"""The sequence-parallel conv and LM of the port against the JAX package's, on
gloo ranks. Helpers and tolerances are those of ``test_torch_seq.py``, whose
docstring states them.
"""

import numpy as np
import pytest
import torch
from test_torch_seq import LM, LM_MIXER, _LM_STATE, _Spy, _assert_matches_plain_lm, _jax_mesh, _ranks

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


WORLDS = (1, 2, 4)


def _joined(res, name, key):
    return np.concatenate([r[name][key] for r in res], axis=-1)


def _jax_seq_conv(world, args, dtype, fn="seq_fft_conv", **kw):
    import jax
    import jax.numpy as jnp

    from flashfftconv_tpu.parallel import seq_conv as jseq

    mesh = _jax_mesh(world)
    cdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    conv = getattr(jseq, fn)
    with mesh:
        return jax.jit(lambda u, k, *g: conv(
            u, k, mesh, axis="sp", pregate=g[0] if g else None, postgate=g[1] if g else None,
            compute_dtype=cdt, impl="pallas", **kw))(*args)


def _flax_lm(mesh):
    import jax.numpy as jnp

    from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM

    return JLM(**LM, dtype=jnp.float32, mixer_kwargs={
        **LM_MIXER, "conv_dtype": jnp.float32, "impl": "xla", "seq_mesh": mesh})


@pytest.mark.parametrize("world", WORLDS)
def test_seq_fft_conv_f32_matches_jax(monkeypatch, world):
    spy = _Spy(monkeypatch, "_conv_tiles")
    cases, res = _ranks(world)
    u, k, _ = cases["f32"]["args"]
    want = np.asarray(_jax_seq_conv(world, [u, k], "f32"))
    assert spy.calls == 1
    np.testing.assert_allclose(_joined(res, "f32", "y"), want, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_seq_fft_conv_gated_bf16_matches_jax(monkeypatch, world):
    import jax.numpy as jnp

    spy = _Spy(monkeypatch, "_conv_tiles")
    cases, res = _ranks(world)
    u, k, gates = cases["bf16_gated"]["args"]
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    args = [bf(u), jnp.asarray(k), *map(bf, gates)]
    want = np.asarray(_jax_seq_conv(world, args, "bf16").astype(jnp.float32))
    assert spy.calls == 1
    np.testing.assert_allclose(_joined(res, "bf16_gated", "y"), want, atol=1e-2)


@pytest.mark.parametrize("world", WORLDS)
def test_seq_fft_conv_grads_match_jax(monkeypatch, world):
    """Grads of sum(y^2) in u, k, pregate and postgate: the port's autograd
    through the differentiable all-to-alls and BandConvFunction against
    jax.grad through the JAX custom VJP, each within 1e-4 of its own largest
    |grad| (the gate grads' median is 1e-5 to 1e-4 here, their largest 7e-4
    to 4e-3: a fixed atol of 2e-4 would hide errors of tens of percent)."""
    import jax
    import jax.numpy as jnp

    from flashfftconv_tpu.parallel import seq_conv as jseq

    spy = _Spy(monkeypatch, "_conv_tiles")
    cases, res = _ranks(world)
    u, k, gates = cases["grads"]["args"]
    mesh = _jax_mesh(world)

    def loss(u, k, pre, post):
        with mesh:
            return jnp.sum(jseq.seq_fft_conv(u, k, mesh, axis="sp", pregate=pre, postgate=post,
                                             compute_dtype=jnp.float32, impl="pallas") ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (u, k, *gates)))
    assert spy.calls == 2
    got = [np.concatenate([r["grads"]["grads"][i] for r in res], axis=-1) for i in range(4)]
    for name, a, r in zip(("u", "k", "pregate", "postgate"), got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(a, r, atol=1e-4 * np.abs(r).max(), rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_seq_fft_conv_padded_short_kernel_matches_jax(monkeypatch, world):
    """L = 512 at FFT size 1024 with a 200-tap kernel: the rechunking of u
    into the padded array and back, against seq_fft_conv_padded on the JAX
    mesh, and its grads against the torch.fft oracle's autograd."""
    from flashfftconv_tpu_torch.ops import monarch

    spy = _Spy(monkeypatch, "_conv_tiles")
    cases, res = _ranks(world)
    case = cases["padded"]
    want = np.asarray(_jax_seq_conv(world, [case["u"], case["k"]], "f32",
                                    fn="seq_fft_conv_padded"))
    assert spy.calls == 1
    np.testing.assert_allclose(_joined(res, "padded", "y"), want, atol=1e-5)
    tu, tk = (torch.from_numpy(a).requires_grad_() for a in (case["u"], case["k"]))
    (monarch.fft_conv_reference(1024, tu, tk) ** 2).sum().backward()
    np.testing.assert_allclose(_joined(res, "padded", "du"), tu.grad.numpy(), atol=1e-5)
    dk = sum(r["padded"]["dk"] for r in res)  # each rank's share of the replicated taps
    np.testing.assert_allclose(dk, tk.grad.numpy(), atol=1e-5)


def test_seq_fft_conv_long_band_matches_jax_long_tiles(monkeypatch):
    """N2 = 65536 at P = 1: the port's four real convs at FFT size 65536
    (the long kernels' plain versions) against _long_tiles' complex-I/O
    contract in interpret mode."""
    spy = _Spy(monkeypatch, "_long_tiles")
    cases, res = _ranks(1)
    u, k, _ = cases["long"]["args"]
    want = np.asarray(_jax_seq_conv(1, [u, k], "f32"))
    assert spy.calls == 1
    np.testing.assert_allclose(_joined(res, "long", "y"), want, atol=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_seq_lm_matches_flax_seq_lm(world):
    """A 2-layer ConvLMHeadModel with seq_mesh at P ranks against the flax
    model with seq_mesh on a P-device mesh, the same weights: logits, the
    loss and the grads of one step; and against the port's own model
    without a mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from flashfftconv_tpu.utils import metrics as jmetrics
    from flashfftconv_tpu_torch.utils import jax_weights

    cases, res = _ranks(world)
    ids = cases["lm"]["ids"]
    params = _LM_STATE["params"]
    mesh = _jax_mesh(world)
    jm = _flax_lm(mesh)
    x = jax.device_put(jnp.asarray(ids[:, :-1]), NamedSharding(mesh, PartitionSpec(None, "sp")))
    y = jnp.asarray(ids[:, 1:])

    def loss_fn(p):
        logits = jm.apply({"params": p}, x, deterministic=True)
        return jmetrics.cross_entropy(logits, y), logits

    with mesh:
        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    got_logits = np.concatenate([r["lm"]["logits"] for r in res], axis=1)
    np.testing.assert_allclose(got_logits, np.asarray(logits), atol=5e-4)
    assert all(abs(r["lm"]["loss"] - float(loss)) <= 1e-5 * float(loss) for r in res)
    want = jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    got = res[0]["lm"]["grads"]
    assert set(got) == set(want)
    for name, g in got.items():
        ref = want[name].numpy()
        assert np.abs(g - ref).max() <= 5e-4 * np.abs(ref).max() + 1e-7, name

    _assert_matches_plain_lm(cases["lm"], res, "lm")
