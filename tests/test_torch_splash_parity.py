"""The splash path of the port against JAX's splash kernel and the plain JAX
path, and the windowed GPT against flax. Helpers and tolerances are those
of ``test_torch_splash.py``, whose docstring states them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from flashfftconv_tpu.models import gpt as jgpt
from flashfftconv_tpu.utils import generation as jgen
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu_torch.models import gpt as tgpt
from flashfftconv_tpu_torch.ops import attention as tattn
from flashfftconv_tpu_torch.ops import attention_cuda
from flashfftconv_tpu_torch.ops.splash_mask import SplashMask
from flashfftconv_tpu_torch.utils import generation, jax_weights, train
from test_torch_splash import DTYPES, _blockmask, _check, _inputs, _jax_case, _port

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


# (mask, L, head_dim, dtype, window or block size, causal): each runs JAX's
# splash kernel once in interpret mode, forward and vjp, at B = 1.
SPLASH_CASES = [
    ("window", 256, 64, "f32", 64, True),
    ("window", 512, 64, "f32", 100, True),
    ("window", 256, 128, "f32", 200, True),
    ("window", 256, 64, "bf16", 64, True),
    ("window", 256, 128, "bf16", 64, True),
    ("blocks", 256, 64, "f32", 64, True),
    ("blocks", 512, 128, "f32", 64, False),
    ("blocks", 256, 64, "f32", 16, False),
    ("blocks", 256, 64, "bf16", 128, True),
]


@functools.lru_cache(maxsize=None)
def _jax_splash(kind, l, d, dtype, arg, causal):
    """(inputs, mask, out, (dq, dk, dv)) of JAX's splash kernel in
    interpret mode, at B = 1."""
    q, k, v, do = _inputs(1, l, d, l + d + arg + causal)
    mask = None if kind == "window" else _blockmask(l, arg, l + arg)
    if kind == "window":
        f = _jax_case(kind, causal, arg, "flash")
    else:
        f = functools.partial(_jax_case(kind, causal, arg, "flash"), mask=mask)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(do)

    jdt = DTYPES[dtype][0]
    with pltpu.force_tpu_interpret_mode():
        out, grads = fwd_bwd(*(jnp.asarray(a, jdt) for a in (q, k, v, do)))
    to_np = lambda a: np.asarray(a.astype(jnp.float32))
    return (q, k, v, do), mask, to_np(out), tuple(to_np(g) for g in grads)


GPT_CFG = dict(d_model=256, n_layer=2, d_inner=1024, vocab_size=256, l_max=512, num_heads=4)


@pytest.mark.parametrize("kind,l,d,dtype,arg,causal", SPLASH_CASES)
def test_splash_path_matches_jax_splash_kernel(kind, l, d, dtype, arg, causal):
    """flash_mha(window=W) and blocksparse_mha (SplashAttnFunction, the plain
    versions of the splash kernels on the CPU) against JAX's splash kernel
    in interpret mode: output and dq, dk, dv."""
    inputs, mask, ref_out, ref_grads = _jax_splash(kind, l, d, dtype, arg, causal)
    before = [f.launches for f in (attention_cuda.splash_attn_fwd,
                                   attention_cuda.splash_attn_bwd_dkv,
                                   attention_cuda.splash_attn_bwd_dq)]
    out, grads = _port(kind, inputs, mask, dtype, arg, causal)
    _check(out, grads, ref_out, ref_grads, dtype)
    assert [f.launches for f in (attention_cuda.splash_attn_fwd,
                                 attention_cuda.splash_attn_bwd_dkv,
                                 attention_cuda.splash_attn_bwd_dq)] == before  # no kernel here


@pytest.mark.parametrize("case", [c for c in SPLASH_CASES if c[3] == "f32"])
def test_splash_plain_versions_match_jax_splash_kernel(case):
    """splash_attn_bwd_plain from splash_attn_fwd_plain's (o, lse) under the
    mask's dense form against the interpret-mode kernel's grads; the
    wrappers' CPU paths give the same numbers."""
    kind, l, d, dtype, arg, causal = case
    (q, k, v, do), mask, ref_out, ref_grads = _jax_splash(*case)
    sm = SplashMask.local(l, arg) if kind == "window" else SplashMask.blocks(mask, arg, causal)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    keep = sm.dense()
    o, lse = tattn.splash_attn_fwd_plain(qt, kt, vt, keep)
    grads = tattn.splash_attn_bwd_plain(qt, kt, vt, o, lse, dot, keep)
    _check(o.numpy(), [g.numpy() for g in grads], ref_out, ref_grads, dtype)
    o2, lse2 = attention_cuda.splash_attn_fwd(qt, kt, vt, sm)
    delta = tattn.attention_delta(o2, dot)
    dk, dv = attention_cuda.splash_attn_bwd_dkv(qt, kt, vt, dot, lse2, delta, sm)
    dq = attention_cuda.splash_attn_bwd_dq(qt, kt, vt, dot, lse2, delta, sm)
    for got, want in zip((o2, lse2, dq, dk, dv), (o, lse, *grads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,l,arg,causal", [
    ("window", 100, 30, True), ("window", 100, 30, False), ("window", 70, 500, True),
    ("blocks", 96, 16, True), ("blocks", 96, 32, False),
])
def test_splash_path_at_batch_2_matches_the_plain_jax_path(kind, l, arg, causal):
    """B = 2 and ragged L against the JAX package's plain path (impl="xla"):
    the interpret-mode kernel does not take B > 1."""
    q, k, v, do = _inputs(2, l, 64, l + arg)
    mask = None if kind == "window" else _blockmask(l, arg, l)
    f = _jax_case(kind, causal, arg, "xla")
    if mask is not None:
        f = functools.partial(f, mask=mask)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got, grads = _port(kind, (q, k, v, do), mask, "f32", arg, causal)
    _check(got, grads, np.asarray(out), ref_grads, "f32")


def test_windowed_gpt_matches_flax_with_jax_splash():
    """A 2-layer f32 GPT with mixer_kwargs={"window": 128} at B = 1, L = 512
    (the flax model on JAX's splash kernel in interpret mode, the port on
    SplashAttnFunction's plain versions): logits and grads; generate_kv
    past the window gives flax's tokens, and the port's cached steps give
    its forward's logits."""
    jm = jgpt.GPTLMHeadModel(**GPT_CFG, mixer_kwargs={"window": 128, "impl": "flash"},
                             dtype=jnp.float32)
    ids = np.random.default_rng(13).integers(0, 256, (1, 513))
    x, y = ids[:, :-1], ids[:, 1:]
    # The parameters come from the same model on impl="xla" (the same tree):
    # an eager interpret-mode splash call, as init makes, stalls JAX's
    # dispatch; jitted it runs.
    params = jgpt.GPTLMHeadModel(**GPT_CFG, mixer_kwargs={"window": 128, "impl": "xla"},
                                 dtype=jnp.float32).init(jax.random.PRNGKey(0),
                                                         jnp.asarray(x))["params"]
    pnp = jax.tree_util.tree_map(np.asarray, params)

    def loss(p):
        return jmetrics.cross_entropy(jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    with pltpu.force_tpu_interpret_mode():
        ref_logits = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
        ref_loss, gp = jax.jit(jax.value_and_grad(loss))(params)
    tm = tgpt.GPTLMHeadModel(**GPT_CFG, mixer_kwargs={"window": 128}, dtype=torch.float32,
                             device="cpu")
    tm.load_state_dict(jax_weights.gpt_state_dict(pnp), strict=True)
    tm.embed_drop.p = 0.0
    logits = tm(torch.from_numpy(x))
    lt = train.cross_entropy(logits, torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=1e-4)
    assert float(lt.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = jax_weights.gpt_state_dict(jax.tree_util.tree_map(np.asarray, gp))
    assert set(ref) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        err = float(np.abs(p.grad.numpy() - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()) + 1e-7, (name, err)

    tm.eval()
    prompt = ids[:, :150]
    with torch.no_grad():
        full = tm(torch.from_numpy(prompt))
        caches = tm.init_cache(1, 160, torch.float32)
        steps = [tm.step(torch.from_numpy(prompt[:, p : p + 1]), caches, p)[0]
                 for p in range(150)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=1e-4)
    want = jgen.generate_kv(jm, params, jnp.asarray(prompt), 6, 160, temperature=0.0)
    got = generation.generate_kv(tm, torch.from_numpy(prompt), 6, 160, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
