"""The benchmark of the PyTorch and CUDA port (``flashfftconv_tpu_torch``).

``run.py`` is the command; README.md says how it is driven and extended.
"""
