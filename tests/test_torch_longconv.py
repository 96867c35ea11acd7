"""Parity of the port's Long Conv family and sequence harness with the flax
modules, on the CPU: ``LongConv``, ``LongConvModel`` (the LRA ListOps
model), ``LongConvOperator`` and the long-conv LM, then the encoders, pools,
decoders and ``SequenceModel`` of ``models/sequence.py``.

The flax modules are initialised from a JAX key; their parameters go to the
port through ``utils.jax_weights``; inputs come from numpy with a seed. The
LongConv kernel is as long as the FFT (k_len = N = 2 l_max): its second
half reaches the output by the circular wrap on both sides. ``impl="pallas"``
runs the JAX package's direct Pallas kernels in interpret mode, else its
XLA path; the port runs its plain versions.

Tolerances: f32 outputs at 1e-4 of their largest |value| and every
parameter's grad at 1e-4 of its largest |grad| (the FFT conv's and the
matmuls' summation orders); a bf16 conv plan at 1e-2 of the largest |logit|
(the JAX package rounds the plan's operands to bf16, the port computes in
f32); parameter-free pools and decoders at 1e-6.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashfftconv_tpu.models import sequence as jseq
from flashfftconv_tpu_torch.models import sequence
from flashfftconv_tpu_torch.utils import jax_weights

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return np.array(x, np.float32)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, ref, rel):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, atol=rel * float(np.abs(ref).max()) + 1e-7)


# --- LongConv --------------------------------------------------------------------


# --- encoders, pools, decoders -------------------------------------------------------


POOLS = {
    "avg": dict(stride=3),
    "linear": dict(stride=2, expand=2),
    "up-linear": dict(stride=2, shrink=2),
    "spectral": dict(stride=4),
}


@pytest.mark.parametrize("name", list(POOLS))
def test_pool_matches_flax(name):
    x = np.random.default_rng(12).standard_normal((2, 24, 8)).astype(np.float32)
    jm = jseq._POOLS[name](**POOLS[name])
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jm.apply(variables, jnp.asarray(x))
    tm = sequence.POOLS[name](in_features=8, **POOLS[name], device=CPU)
    if "params" in variables:
        tm.load_state_dict(jax_weights._dense(_tree(variables["params"])["proj"], "proj"),
                           strict=True)
    got = tm(torch.from_numpy(x))
    assert got.shape == ref.shape and tm.out_features == got.shape[-1]
    _close(got.detach(), ref, 1e-5)
    if name != "up-linear":
        with pytest.raises(ValueError, match="divisible"):
            tm(torch.zeros(1, 25, 8))


@pytest.mark.parametrize("mode", ["last", "first", "mean", "pool", "sum", "full"])
@pytest.mark.parametrize("l_output", [0, 3])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_sequence_decoder_matches_flax(mode, l_output, with_lengths):
    """Every mode, squeezed or not, with and without per-sample lengths (the
    vectorised masking of the flax module), projected to 5 outputs."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 10, 8)).astype(np.float32)
    lengths = np.array([10, 4, 1]) if with_lengths else None
    jl = None if lengths is None else jnp.asarray(lengths)
    jm = jseq.SequenceDecoder(d_output=5, l_output=l_output, mode=mode)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), lengths=jl)
    ref = jm.apply(variables, jnp.asarray(x), lengths=jl)
    tm = sequence.SequenceDecoder(8, d_output=5, l_output=l_output, mode=mode, device=CPU)
    tm.load_state_dict(jax_weights._dense(_tree(variables["params"])["proj"], "proj"),
                       strict=True)
    got = tm(torch.from_numpy(x), lengths=None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == ref.shape
    _close(got.detach(), ref, 1e-5)


# --- SequenceModel: the configurations of tests/test_sequence.py ---------------------
