"""Parallel paths of the port on ``torch.distributed``: the sequence-sharded
FFT convolution (``seq_conv``), which distributes one long conv over the
ranks of a mesh dimension, and the train-step helpers of a model whose
sequence is sharded."""

from flashfftconv_tpu_torch.parallel.seq_conv import (
    seq_backward,
    seq_fft_conv,
    seq_fft_conv_padded,
    seq_group,
    seq_halo,
)

__all__ = ["seq_fft_conv", "seq_fft_conv_padded", "seq_halo", "seq_group", "seq_backward"]
