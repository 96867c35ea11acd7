"""Parity of the port's splash-attention path with the JAX package.

``flash_mha(window=W)`` and ``blocksparse_mha`` run ``SplashAttnFunction``,
whose CPU forward and backward are ``splash_attn_fwd_plain`` and
``splash_attn_bwd_plain``, the plain versions of the three splash kernels.
They are held against JAX's splash attention itself, run by the JAX
package's ``flash_mha(impl="flash", window=W)`` and
``blocksparse_mha(impl="flash")`` inside ``pltpu.force_tpu_interpret_mode()``
at B = 1 (JAX's interpret mode fails on the batch vmap of ``_splash_call``
for B > 1 with "safe_zip() argument 2 is shorter than argument 1"), L 256
and 512, head_dim 64 and 128, f32 and bf16: outputs and dq, dk, dv. A B = 2
case, the empty row block and the CPU routes are held against the JAX
package's plain path (``impl="xla"``, or its off-TPU ``mha_reference``). The
tile tables of ``ops/splash_mask.py`` are held to the dense mask, and a
2-layer windowed GPT to the flax model with JAX's splash kernel, weights
carried by ``jax_weights.gpt_state_dict``.

Tolerances, as ``tests/test_torch_attention.py`` states them: f32 outputs
at 1e-5, f32 grads at 1e-4 of max(1, each largest |grad|); bf16 outputs at
1e-2 and bf16 grads at 2e-2 of max(1, each largest |grad|). In bf16, JAX
multiplies q by sm_scale in bf16 before the kernel (exact at head_dim 64,
where the scale is 1/8; one more bf16 rounding of q at 128) and rounds p
before p v; the port scales the f32 scores and keeps p in f32. The GPT in
f32: logits at 1e-4 absolute, grads at 1e-4 of each parameter's largest
|grad|.
"""

import functools

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashfftconv_tpu.ops import attention as jattn
from flashfftconv_tpu_torch.ops import attention as tattn
from flashfftconv_tpu_torch.ops import attention_cuda
from flashfftconv_tpu_torch.ops.splash_mask import TILE, SplashMask

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

H = 2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _blockmask(l: int, block: int, seed: int) -> np.ndarray:
    """A random block mask with its diagonal kept, so that no row is empty
    (JAX's splash kernel and the package's plain contract differ on an empty
    row; see test_empty_row_block_gives_zeros_and_zero_grads)."""
    n = l // block
    m = np.random.default_rng(seed).random((n, n)) < 0.5
    np.fill_diagonal(m, True)
    return m


def _inputs(b, l, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, H, l, d)).astype(np.float32) for _ in range(4)]


def _jax_case(kind, causal, arg, impl):
    """The JAX package's attention for a case, as f(q, k, v)."""
    if kind == "window":
        return lambda q, k, v: jattn.flash_mha(q, k, v, causal=causal, impl=impl, window=arg)
    return lambda q, k, v, mask=None: jattn.blocksparse_mha(q, k, v, mask, block_size=arg,
                                                            causal=causal, impl=impl)


def _port(kind, inputs, mask, dtype, arg, causal):
    """The port's output and grads through SplashAttnFunction's CPU path."""
    q, k, v, do = inputs
    tdt = DTYPES[dtype][1]
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    if kind == "window":
        out = tattn.flash_mha(qt, kt, vt, causal=causal, window=arg)
    else:
        out = tattn.blocksparse_mha(qt, kt, vt, mask, block_size=arg, causal=causal)
    out.backward(torch.from_numpy(do).to(tdt))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in (qt, kt, vt)]


def _check(out, grads, ref_out, ref_grads, dtype):
    out_tol, grad_tol = (1e-5, 1e-4) if dtype == "f32" else (1e-2, 2e-2)
    np.testing.assert_allclose(out, ref_out, atol=out_tol, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        err = float(np.abs(g - r).max())
        assert err <= grad_tol * max(1.0, float(np.abs(r).max())), (name, err, np.abs(r).max())


def test_empty_row_block_gives_zeros_and_zero_grads():
    """A row block that sees no key gives exact zeros, adds nothing to any
    grad and leaves every grad finite: the JAX package's plain contract
    (blocksparse_mha's docstring, ops/attention.py:347-349 there), which
    impl="xla" follows. JAX's splash kernel gives nonzero values on such
    rows (max |o| 0.143 at (1, 2, 256, 64), block 128, mask [[0, 0], [1, 1]],
    in interpret mode); the port follows the documented contract."""
    q, k, v, do = _inputs(1, 64, 64, 11)
    mask = np.array([[0, 0], [1, 1]])
    f = functools.partial(_jax_case("blocks", False, 32, "xla"), mask=mask)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got, grads = _port("blocks", (q, k, v, do), mask, "f32", 32, False)
    assert not got[:, :, :32].any() and not grads[0][:, :, :32].any()
    assert all(np.isfinite(g).all() for g in grads)
    _check(got, grads, np.asarray(out), ref_grads, "f32")
    sm = SplashMask.blocks(mask, 32)
    o, lse = attention_cuda.splash_attn_fwd(*(torch.from_numpy(a) for a in (q, k, v)), sm)
    assert torch.isinf(lse[:, :, :32]).all() and torch.isfinite(lse[:, :, 32:]).all()


def test_splash_routes_and_refusals_on_the_cpu():
    """On CPU tensors a window with a bias or segment ids runs the plain
    mha_reference, as the JAX package does off a TPU (on CUDA tensors it
    raises NotImplementedError, as on a TPU: tests/test_torch_gpu.py);
    impl names and masks the kernels cannot take raise ValueError."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((2, 3, 40, 64)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    bias = np.array(jattn.alibi_bias(3, 40, 40))
    seg = np.repeat(np.array([[1, 2], [3, 3]], np.int32), 20, axis=1)
    got = tattn.flash_mha(tq, tk, tv, window=9, bias=torch.from_numpy(bias))
    want = jattn.flash_mha(jq, jk, jv, window=9, bias=jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = tattn.flash_mha(tq, tk, tv, window=9, segment_ids=torch.from_numpy(seg))
    want = jattn.flash_mha(jq, jk, jv, window=9, segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tattn.flash_mha(tq, tk, tv, window=9).numpy(),
                               tattn.flash_mha(tq, tk, tv, window=9, impl="xla").numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_mha(tq, tk, tv, window=9, impl="flash")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.blocksparse_mha(tq, tk, tv, [[1, 0], [1, 1]], block_size=20, impl="flash")
    with pytest.raises(ValueError, match="impl"):
        tattn.blocksparse_mha(tq, tk, tv, [[1, 0], [1, 1]], block_size=20, impl="pallas")
    with pytest.raises(ValueError, match="window"):
        tattn.flash_mha(tq, tk, tv, window=0)
    with pytest.raises(ValueError, match="L=41"):
        attention_cuda.splash_attn_fwd(tq, tk, tv, SplashMask.local(41, 9))


# --- the tile tables ---------------------------------------------------------

def _check_tiles(mask: SplashMask) -> None:
    """Every kept element of the dense mask lies in a listed tile, every
    listed tile holds one, a full tile holds no masked element, the lists
    run in ascending order, and the key tiles' lists are the transpose of
    the query tiles'."""
    dense = mask.dense().numpy()
    fwd, bwd = mask.tiles()
    assert len(fwd) == len(bwd) == mask.n_tiles == -(-mask.length // TILE)
    listed = {}
    for tq, row in enumerate(fwd):
        assert [t for t, _ in row] == sorted({t for t, _ in row})
        listed.update({(tq, tk): full for tk, full in row})
    for col in bwd:
        assert [t for t, _ in col] == sorted({t for t, _ in col})
    assert {(tq, tk): full for tk, col in enumerate(bwd) for tq, full in col} == listed
    for tq in range(mask.n_tiles):
        for tk in range(mask.n_tiles):
            tile = dense[TILE * tq : TILE * (tq + 1), TILE * tk : TILE * (tk + 1)]
            if (tq, tk) not in listed:
                assert not tile.any(), (tq, tk)
            else:
                assert tile.any(), (tq, tk)
                assert tile.all() or not listed[(tq, tk)], (tq, tk)


@pytest.mark.parametrize("l,w", [(1, 1), (2048, 256), (2048, 1), (300, 100), (129, 64),
                                 (65, 1000), (256, 128)])
def test_window_tiles_cover_the_window(l, w):
    _check_tiles(SplashMask.local(l, w))


def test_window_tiles_at_the_windowed_gpt_shape():
    """L = 2048, W = 256: 150 tiles a (b, h), 0.28 of the causal 528."""
    fwd, bwd = SplashMask.local(2048, 256).tiles()
    assert sum(map(len, fwd)) == sum(map(len, bwd)) == 150
    assert sum(map(len, SplashMask.local(2048, 2048).tiles()[0])) == 528


@pytest.mark.parametrize("l,block,causal", [(1024, 256, True), (256, 16, False),
                                            (80, 16, True), (300, 100, False), (96, 3, True)])
def test_block_tiles_cover_the_block_mask(l, block, causal):
    mask = _blockmask(l, block, l + block)
    mask[0] = False  # an empty row block
    _check_tiles(SplashMask.blocks(mask, block, causal))


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(l=st.integers(1, 400), w=st.integers(1, 450))
def test_window_tiles_property(l, w):
    _check_tiles(SplashMask.local(l, w))


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(n=st.integers(1, 8), block=st.sampled_from([1, 3, 16, 24, 32, 64, 100]),
                  causal=st.booleans(), seed=st.integers(0, 2**16))
def test_block_tiles_property(n, block, causal, seed):
    mask = np.random.default_rng(seed).random((n, n)) < 0.4
    _check_tiles(SplashMask.blocks(mask, block, causal))


def test_block_tables_are_cached_and_masks_checked():
    mask = _blockmask(256, 64, 1)
    a, b = SplashMask.blocks(mask, 64, True), SplashMask.blocks(mask.copy(), 64, True)
    assert a.table() is b.table()
    assert a.table() is not SplashMask.blocks(mask, 64, False).table()
    with pytest.raises(ValueError, match="tile"):
        SplashMask(250, blockmask=mask, block_size=64)
    with pytest.raises(ValueError, match="tile"):
        SplashMask.blocks(np.ones((2, 3)), 64)


# --- a windowed GPT ------------------------------------------------------------
