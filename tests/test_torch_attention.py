"""Parity of the port's attention slice with the JAX package.

The attention op (``flash_mha`` through ``FlashAttnFunction``, whose CPU
forward and backward are ``flash_attn_fwd_plain`` and ``flash_attn_bwd_plain``,
the plain versions of the three CUDA kernels) against JAX's Pallas
``flash_attention`` itself, run by the JAX package's ``flash_mha(impl="flash")``
inside ``pltpu.force_tpu_interpret_mode()`` at L = 256 (head_dim 64, 128, 256 and
640, the last above 512, where the CUDA kernels split D across blocks),
and against the JAX ``mha_reference`` at ragged L (1, 7, 129, 300), where the
Pallas kernel cannot tile: forward and grads (dq, dk, dv, d bias), causal,
non-causal, ALiBi and segment ids, f32 and bf16. Then the helpers (ALiBi,
rotary, ``pack_sequences``, the window and block-sparse plain paths),
``MHAOperator`` and its KV-cached ``step``, a 2-layer ``GPTLMHeadModel`` (GPT-2
and OPT shapes), ``generate_kv``, ``ConvLMHeadModel(mixer="mha")``, three
optimizer steps of the ``examples/lm`` chain and the GPT-2 and OPT imports,
each against the JAX package on the CPU. Inputs come from numpy with a seed.

Tolerances: f32 attention outputs at 1e-5 (measured 3.6e-7 against the
interpret-mode kernel), f32 grads at 1e-4 of max(1, each largest |grad|)
(measured <= 7.6e-6; at L = 1 dq is 0 and both sides round to ~1e-7); bf16 outputs at the repo's 1e-2 and bf16 grads at 2e-2 of max(1, each
largest |grad|) (the Pallas kernel rounds p to bf16 before p v, the port's
plain version keeps p in f32). Modules and models in f32: outputs at 1e-5
of their largest |value|, logits at 1e-4 absolute, grads at 1e-4 of each
parameter's largest |grad|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flashfftconv_tpu.models import attention as jattn_mod
from flashfftconv_tpu.models import gpt as jgpt
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.ops import attention as jattn
from flashfftconv_tpu.ops import fused as jfused
from flashfftconv_tpu.utils import checkpoint_import as jci
from flashfftconv_tpu.utils import generation as jgen
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu_torch.models import attention as tattn_mod
from flashfftconv_tpu_torch.models import gpt as tgpt
from flashfftconv_tpu_torch.models.lm import Block, ConvLMHeadModel
from flashfftconv_tpu_torch.ops import attention as tattn
from flashfftconv_tpu_torch.ops import attention_cuda, fused
from flashfftconv_tpu_torch.utils import checkpoint_import as tci
from flashfftconv_tpu_torch.utils import generation, jax_weights, train

CPU = "cpu"
B, H = 2, 2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (L, head_dim, dtype, case): L = 256 runs JAX's Pallas kernel in interpret
# mode, the ragged lengths its mha_reference.
KERNEL_CASES = [
    (256, 64, "f32", "causal"), (256, 64, "f32", "noncausal"), (256, 64, "f32", "alibi"),
    (256, 64, "f32", "segments"), (256, 128, "f32", "causal"), (256, 128, "f32", "alibi"),
    (256, 64, "bf16", "causal"), (256, 64, "bf16", "alibi"),
    (256, 256, "f32", "causal"), (256, 256, "bf16", "alibi"),
    # head_dim 640, above 512: the CUDA kernels' D slices. In bf16 it is
    # non-causal: causal and ALiBi put one of 655,360 outputs (|o| = 2.0234,
    # 5e-8 from a bf16 rounding midpoint) one bf16 ulp, 0.015625, from JAX's,
    # both within half an ulp of the f64 value, past the absolute 1e-2.
    (256, 640, "f32", "causal"), (256, 640, "bf16", "noncausal"),
]
RAGGED_CASES = [
    (1, 64, "f32", "causal"), (7, 64, "f32", "alibi"), (129, 128, "f32", "segments"),
    (300, 64, "f32", "noncausal"), (300, 64, "bf16", "causal"),
]


def _segments(l: int) -> np.ndarray:
    """(B, L) segment ids from pack_sequences: row 0 packs two sequences,
    row 1 one."""
    seqs = [np.zeros(n, np.float32) for n in (l // 3, l - l // 3, l)]
    _, seg, _ = tattn.pack_sequences(seqs, l)
    assert seg.shape == (B, l)
    return seg


def _inputs(l, d, case):
    rng = np.random.default_rng(l * 1000 + d + len(case))
    q, k, v, do = (rng.standard_normal((B, H, l, d)).astype(np.float32) for _ in range(4))
    bias = np.asarray(jattn.alibi_bias(H, l, l)) if case == "alibi" else None
    seg = _segments(l) if case == "segments" else None
    return q, k, v, do, bias, seg


@functools.lru_cache(maxsize=None)
def _jax_attention(l, d, dtype, case):
    """(inputs, out, (dq, dk, dv, dbias)) of the JAX package's flash_mha: the
    Pallas kernel in interpret mode where it tiles, else mha_reference."""
    q, k, v, do, bias, seg = _inputs(l, d, case)
    jdt = DTYPES[dtype][0]
    causal = case != "noncausal"
    pallas = l % 128 == 0 and l >= 256
    seg_j = None if seg is None else jnp.asarray(seg)

    def f(q, k, v, b):
        return jattn.flash_mha(q, k, v, causal=causal, impl="flash" if pallas else "xla", bias=b,
                               segment_ids=seg_j)

    @jax.jit
    def fwd_bwd(q, k, v, b, do):
        out, vjp = jax.vjp(f, q, k, v, b)
        return out, vjp(do)

    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    b = jnp.zeros((1, H, l, l), jnp.float32) if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        out, grads = fwd_bwd(*args, b, jnp.asarray(do, jdt))
    to_np = lambda a: np.asarray(a.astype(jnp.float32))
    return (q, k, v, do, bias, seg), to_np(out), tuple(to_np(g) for g in grads)


def _port_attention(inputs, dtype, case):
    q, k, v, do, bias, seg = inputs
    tdt = DTYPES[dtype][1]
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_()
    st = None if seg is None else torch.from_numpy(seg)
    out = tattn.flash_mha(qt, kt, vt, causal=case != "noncausal", bias=bt, segment_ids=st)
    out.backward(torch.from_numpy(do).to(tdt))
    grads = [t.grad.float().numpy() for t in (qt, kt, vt)]
    grads.append(None if bt is None else bt.grad.numpy())
    return out.detach().float().numpy(), grads


def _check(out, grads, ref_out, ref_grads, dtype, bias):
    out_tol, grad_tol = (1e-5, 1e-4) if dtype == "f32" else (1e-2, 2e-2)
    np.testing.assert_allclose(out, ref_out, atol=out_tol, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, ref_grads):
        if name == "dbias" and bias is None:
            continue
        err = float(np.abs(g - r).max())
        assert err <= grad_tol * max(1.0, float(np.abs(r).max())), (name, err, np.abs(r).max())


@pytest.mark.parametrize("l,d,dtype,case", KERNEL_CASES + RAGGED_CASES)
def test_flash_mha_matches_jax_flash_attention(l, d, dtype, case):
    """The port's attention (the plain versions of the three kernels on the
    CPU) against the Pallas kernel (L = 256) or mha_reference (ragged L)."""
    inputs, ref_out, ref_grads = _jax_attention(l, d, dtype, case)
    out, grads = _port_attention(inputs, dtype, case)
    _check(out, grads, ref_out, ref_grads, dtype, inputs[4])


@pytest.mark.parametrize("l,d,dtype,case", KERNEL_CASES[:4])
def test_flash_attn_bwd_plain_matches_jax_grad(l, d, dtype, case):
    """flash_attn_bwd_plain from flash_attn_fwd_plain's (o, lse) against
    jax.grad of the interpret-mode kernel; the wrappers' CPU paths give the
    same grads."""
    (q, k, v, do, bias, seg), ref_out, ref_grads = _jax_attention(l, d, dtype, case)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    bt = None if bias is None else torch.from_numpy(bias)
    st = None if seg is None else torch.from_numpy(seg)
    causal = case != "noncausal"
    o, lse = tattn.flash_attn_fwd_plain(qt, kt, vt, causal, None, bt, st)
    grads = tattn.flash_attn_bwd_plain(qt, kt, vt, o, lse, dot, causal, None, bt, st,
                                       bias_grad=bias is not None)
    grads = [None if g is None else g.numpy() for g in grads[:3]] + [
        None if grads[3] is None else grads[3].sum(0, keepdim=True).numpy()]
    _check(o.numpy(), grads, ref_out, ref_grads, dtype, bias)
    o2, lse2 = attention_cuda.flash_attn_fwd(qt, kt, vt, causal, None, bt, st)
    delta = tattn.attention_delta(o2, dot)
    dk, dv = attention_cuda.flash_attn_bwd_dkv(qt, kt, vt, dot, lse2, delta, causal, None, bt, st)
    dq, _ = attention_cuda.flash_attn_bwd_dq(qt, kt, vt, dot, lse2, delta, causal, None, bt, st)
    for got, want in zip((o2, lse2, dq, dk, dv), (o, lse, *grads[:3])):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6, rtol=0)


def test_flash_mha_routes_and_refusals():
    """On CPU tensors impl='auto' runs FlashAttnFunction (whose forward is
    the plain version of the kernel), impl='xla' the oracle, impl='flash'
    raises; bad impl names raise."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
               for _ in range(3))
    before = attention_cuda.flash_attn_fwd.launches
    a = tattn.flash_mha(q, k, v)
    b = tattn.flash_mha(q, k, v, impl="xla")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert attention_cuda.flash_attn_fwd.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_mha(q, k, v, impl="flash")
    with pytest.raises(ValueError, match="impl"):
        tattn.flash_mha(q, k, v, impl="pallas")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# (what, q, k, v) that the attention kernels refuse by shape or dtype
REFUSED = {
    "head_dim 32": (_meta(2, 8, 16, 32),) * 3,
    "head_dim 96": (_meta(2, 8, 16, 96),) * 3,
    "head_dim 576": (_meta(2, 4, 16, 576),) * 3,
    "f64": (_meta(2, 4, 16, 64, dtype=torch.float64),) * 3,
    "k shorter than q": (_meta(2, 4, 16, 64), _meta(2, 4, 8, 64), _meta(2, 4, 8, 64)),
    "v in another dtype": (_meta(2, 4, 16, 64),) * 2 + (_meta(2, 4, 16, 64, dtype=torch.bfloat16),),
    "3-d q": (_meta(4, 16, 64),) * 3,
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_kernels_take_refuses_what_check_qkv_refuses(what):
    """kernels_take (what impl='auto' asks before a kernel) and _check_qkv
    (what every attention wrapper asks on CUDA tensors) are one predicate:
    each refusal on meta tensors, no card needed."""
    for q in (_meta(2, 4, 16, 64), _meta(65535, 1, 3, 128, dtype=torch.bfloat16),
              _meta(1, 2, 5, 128, dtype=torch.float16)):
        assert attention_cuda.kernels_take(q, q, q)
        assert attention_cuda._check_qkv(q, q, q, q) == tuple(q.shape)
    assert not attention_cuda.kernels_take(*REFUSED[what])
    with pytest.raises(ValueError):
        attention_cuda._check_qkv(*REFUSED[what])


@pytest.mark.parametrize("d,dtype", [(32, torch.float32), (96, torch.float16)])
def test_auto_runs_the_plain_version_where_the_kernels_refuse(monkeypatch, d, dtype):
    """With the tensors taken for CUDA ones (on_cpu patched to False), a
    head_dim the kernels refuse, at an L the JAX package's TPU kernels do not
    tile either, runs mha_reference (flash_mha, and a window with a bias) or
    the dense mask (blocksparse_mha) under impl='auto', as the JAX package's
    'auto' runs its XLA path there (JAX's own auto on the CPU is the oracle
    here); impl='flash' raises without reaching a kernel."""
    monkeypatch.setattr(tattn, "on_cpu", lambda *t: False)
    monkeypatch.setattr(attention_cuda, "on_cpu", lambda *t: False)
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 3, 64, d)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.float16 if dtype == torch.float16 else jnp.float32)
                  for a in (q, k, v))
    bias = tattn.alibi_bias(3, 64, 64)
    mask = np.array([[1, 0], [1, 1]])
    tol = 1e-5 if dtype == torch.float32 else 2e-3
    launches = (attention_cuda.flash_attn_fwd.launches, attention_cuda.splash_attn_fwd.launches)
    for got, want in (
        (tattn.flash_mha(tq, tk, tv), jattn.flash_mha(jq, jk, jv)),
        (tattn.flash_mha(tq, tk, tv, window=9, bias=bias),
         jattn.flash_mha(jq, jk, jv, window=9, bias=jnp.asarray(bias.numpy()))),
        (tattn.blocksparse_mha(tq, tk, tv, mask, block_size=32),
         jattn.blocksparse_mha(jq, jk, jv, mask, block_size=32)),
    ):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    assert launches == (attention_cuda.flash_attn_fwd.launches,
                        attention_cuda.splash_attn_fwd.launches)
    for call in (lambda: tattn.flash_mha(tq, tk, tv, impl="flash"),
                 lambda: tattn.flash_mha(tq, tk, tv, window=9, impl="flash"),
                 lambda: tattn.blocksparse_mha(tq, tk, tv, mask, block_size=32, impl="flash")):
        with pytest.raises(ValueError, match="head_dim"):
            call()
    with pytest.raises(NotImplementedError, match="bias or segment ids"):
        tattn.flash_mha(tq, tk, tv, window=9, bias=bias, impl="flash")


# (what, q, k, v, the refusal): calls the JAX package's TPU kernels take
# (L >= 256, L and head_dim multiples of 128) and the CUDA kernels refuse
TPU_ONLY = {
    "k shorter than q": ((_meta(1, 2, 256, 128), _meta(1, 2, 128, 128), _meta(1, 2, 128, 128)),
                         "one shape"),
}


@pytest.mark.parametrize("what", list(TPU_ONLY))
def test_auto_raises_where_only_the_tpu_kernels_take_the_call(monkeypatch, what):
    """With meta tensors taken for CUDA ones (on_cpu patched to False): where
    the JAX package's 'auto' would run its TPU kernel and the CUDA kernels
    refuse the call, impl='auto' raises the kernels' refusal, as
    impl='flash' does, for flash_mha, a window and blocksparse_mha; it does
    not run the plain version on the card."""
    monkeypatch.setattr(tattn, "on_cpu", lambda *t: False)
    monkeypatch.setattr(attention_cuda, "on_cpu", lambda *t: False)
    (q, k, v), why = TPU_ONLY[what]
    assert not tattn._auto_runs_plain(q, k, v)
    for impl in ("auto", "flash"):
        for call in (lambda: tattn.flash_mha(q, k, v, impl=impl),
                     lambda: tattn.flash_mha(q, k, v, window=9, impl=impl),
                     lambda: tattn.blocksparse_mha(q, k, v, [[1, 0], [1, 1]], block_size=128,
                                                   impl=impl)):
            with pytest.raises(ValueError, match=why):
                call()


@pytest.mark.parametrize("shape", [(256, 257, 1, 64), (256, 257, 256, 128)])
def test_kernels_take_any_batch_times_heads(monkeypatch, shape):
    """B * H = 65792, past the 65535 of one grid dimension: the kernels fold
    it over two, so kernels_take and _check_qkv accept it and impl='auto'
    sends it to the kernels (on meta tensors, with on_cpu patched to False)."""
    monkeypatch.setattr(attention_cuda, "on_cpu", lambda *t: False)
    q = _meta(*shape)
    assert attention_cuda.kernels_take(q, q, q)
    assert attention_cuda._check_qkv(q, q, q, q) == shape
    assert not tattn._auto_runs_plain(q, q, q)


@pytest.mark.parametrize("d", [256, 384, 512, 640, 768, 1024, 2048])
def test_kernels_take_every_wide_head_dim(monkeypatch, d):
    """head_dim 256, 384 and 512, and above 512 (D slices across blocks, no
    largest) 640, 768, 1024 and 2048: kernels_take and _check_qkv accept
    them in every dtype and impl='auto' sends them to the kernels (meta
    tensors, on_cpu patched to False), as the JAX package's 'auto' sends
    every multiple of 128 to its TPU kernel; 64 more, no multiple of 128,
    is refused with a message that names head_dim."""
    monkeypatch.setattr(attention_cuda, "on_cpu", lambda *t: False)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q = _meta(2, 3, 256, d, dtype=dtype)
        assert attention_cuda.kernels_take(q, q, q)
        assert attention_cuda._check_qkv(q, q, q, q) == (2, 3, 256, d)
        assert not tattn._auto_runs_plain(q, q, q)
    q = _meta(2, 3, 256, d + 64)
    assert not attention_cuda.kernels_take(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        attention_cuda._check_qkv(q, q, q)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits, to
    nearest, ties away from zero (on the bits, which are sign and
    magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tensor_core_mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the backward kernels' mma.sync TF32 products compute it: each
    f32 operand split into hi = tf32(x) and lo = x - hi, of which the tensor
    cores read the leading 19 bits (a truncation to TF32), and lo hi + hi lo
    + hi hi summed (passes=3), or hi hi alone (passes=1); products of TF32
    values are exact in f32, and the sums are f32."""
    trunc = lambda x: (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if passes == 3:
        out = trunc(a - ah) @ bh + ah @ trunc(b - bh) + out
    return out


def _tensor_core_backward(q, k, v, do, passes: int):
    """(dq, dk, dv) of causal attention as the backward kernels compute
    them: the five products by _tensor_core_mm, p and ds in f32, lse and
    delta from the plain forward."""
    scale = q.shape[-1] ** -0.5
    o, lse = tattn.flash_attn_fwd_plain(q, k, v, True)
    delta = tattn.attention_delta(o, do)
    keep = torch.ones(q.shape[2], q.shape[2], dtype=torch.bool).tril()
    s = _tensor_core_mm(q, k.transpose(-1, -2), passes) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (_tensor_core_mm(do, v.transpose(-1, -2), passes) - delta[..., None])
    dv = _tensor_core_mm(p.transpose(-1, -2), do, passes)
    dk = _tensor_core_mm(ds.transpose(-1, -2), q, passes) * scale
    dq = _tensor_core_mm(ds, k, passes) * scale
    return dq, dk, dv


def _tensor_core_forward(q, k, v, passes: int):
    """(o, lse) of causal attention as the forward kernels compute them:
    s = q k^T and p v by _tensor_core_mm, the softmax's max, exp and sums in
    f32, o = (p v) / l."""
    scale = q.shape[-1] ** -0.5
    keep = torch.ones(q.shape[2], q.shape[2], dtype=torch.bool).tril()
    s = torch.where(keep, _tensor_core_mm(q, k.transpose(-1, -2), passes) * scale, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return _tensor_core_mm(p, v, passes) / l, (m + torch.log(l))[..., 0]


def test_split_tf32_keeps_the_forward_within_the_card_tolerance():
    """The forward kernels' split-TF32 products (q k^T and p v), emulated on
    the CPU at B=1, H=2, L=192, D=64, f32, causal, land within the card
    checks' f32 tolerance (2e-5 of max(1, the largest |o|): chip_smoke.
    attn_tol, test_torch_gpu._attn_close) of flash_attn_fwd_plain, output
    and logsumexp; one TF32 pass does not, so the forward keeps the f32
    contract only split. As in the backward's test below, every product is
    summed by torch's f32 matmul: the tensor cores' truncating accumulation,
    the kernels' grouping of each tile's terms, the online softmax's
    rescaling and ex2.approx are left to the card checks."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 192, 64)).astype(np.float32))
               for _ in range(3))
    ref = tattn.flash_attn_fwd_plain(q, k, v, True)
    for passes, within in ((3, True), (1, False)):
        got = _tensor_core_forward(q, k, v, passes)
        errs = [float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
                for g, r in zip(got, ref)]
        assert (max(errs) <= 2e-5) == within, (passes, errs)


def test_split_tf32_keeps_the_backward_within_the_card_tolerance():
    """The backward kernels' split-TF32 products, emulated on the CPU at
    B=1, H=2, L=192, D=64, f32, causal, land within the card checks' f32
    tolerance (2e-5 of max(1, the largest |grad|): chip_smoke.attn_tol,
    test_torch_gpu._attn_close) of the f32 plain backward (measured about
    1e-6); one TF32 pass does not (about 5e-4), so the tensor cores keep
    the f32 contract only split. It shows that the split is needed, and
    only that: every product is summed by torch's f32 matmul, so it models
    neither the tensor cores' truncating accumulation, nor the kernels'
    grouping of each tile's terms that bounds it, nor ex2.approx. The card
    checks (chip_smoke.py kernels, tests/test_torch_gpu.py) guard those."""
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, 192, 64)).astype(np.float32))
                   for _ in range(4))
    o, lse = tattn.flash_attn_fwd_plain(q, k, v, True)
    ref = tattn.flash_attn_bwd_plain(q, k, v, o, lse, do, True)[:3]
    for passes, within in ((3, True), (1, False)):
        got = _tensor_core_backward(q, k, v, do, passes)
        errs = [float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
                for g, r in zip(got, ref)]
        assert (max(errs) <= 2e-5) == within, (passes, errs)


def test_alibi_rotary_and_packing_match_jax():
    np.testing.assert_allclose(tattn.alibi_slopes(12).numpy(),
                               np.asarray(jattn.alibi_slopes(12)), rtol=1e-7)
    for h, lq, lk in ((12, 7, 9), (8, 5, 5), (6, 1, 4)):
        np.testing.assert_allclose(tattn.alibi_bias(h, lq, lk).numpy(),
                                   np.asarray(jattn.alibi_bias(h, lq, lk)), rtol=1e-6)
    for l, dim in ((17, 8), (33, 64)):
        for got, want in zip(tattn_mod.rotary_tables(l, dim),
                             jattn_mod.rotary_tables(l, dim)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        x = np.random.default_rng(l).standard_normal((2, 3, l, dim)).astype(np.float32)
        cos, sin = jattn_mod.rotary_tables(l, dim)
        want = jfused.apply_rotary_emb(jnp.asarray(x), cos, sin)
        got = fused.apply_rotary_emb(torch.from_numpy(x), *tattn_mod.rotary_tables(l, dim))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rng = np.random.default_rng(4)
    seqs = [rng.standard_normal((n, 3)).astype(np.float32) for n in (5, 9, 3, 12, 1, 7)]
    got, want = tattn.pack_sequences(seqs, 12), jattn.pack_sequences(seqs, 12)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with pytest.raises(ValueError):
        tattn.pack_sequences(seqs, 8)


@pytest.mark.parametrize("causal", [False, True])
def test_window_and_blocksparse_plain_paths_match_jax(causal):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 2, 64, 32)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = tattn.flash_mha(tq, tk, tv, causal=causal, window=9)
    want = jattn.flash_mha(jq, jk, jv, causal=causal, window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mask = np.array([[1, 0, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0], [1, 0, 1, 1]])
    got = tattn.blocksparse_mha(tq, tk, tv, mask, block_size=16, causal=causal)
    want = jattn.blocksparse_mha(jq, jk, jv, mask, block_size=16, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not got[:, :, 32:48].any()  # the empty row block gives zeros
    with pytest.raises(ValueError):
        tattn.blocksparse_mha(tq, tk, tv, mask, block_size=8)


def _init(model, *args, **kw):
    params = model.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return params, jax.tree_util.tree_map(np.asarray, params)


def _assert_grads(jax_grads: dict, model, tol=1e-4):
    assert set(jax_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        ref = jax_grads[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= tol * float(np.abs(ref).max()) + 1e-7, (name, err, float(np.abs(ref).max()))


MHA_CASES = {
    "plain": dict(),
    "rotary8": dict(rotary_dim=8),
    "rotary_full": dict(rotary_dim=64),
    "alibi": dict(alibi=True),
    "segments": dict(),
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_mha_operator_matches_flax(case):
    """MHAOperator forward, input grad and parameter grads against flax
    (d_model 128, 2 heads of 64, L = 40), weights carried by mha_state_dict."""
    kw = MHA_CASES[case]
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 40, 128)).astype(np.float32)
    w = rng.standard_normal((2, 40, 128)).astype(np.float32)
    seg = np.repeat(np.array([[1, 2, 3, 4], [1, 1, 2, 2]]), 10, axis=1).astype(np.int32) \
        if case == "segments" else None
    jm = jattn_mod.MHAOperator(d_model=128, num_heads=2, **kw)
    params, pnp = _init(jm, jnp.asarray(u))
    seg_j = None if seg is None else jnp.asarray(seg)

    def loss(p, x):
        return (jm.apply({"params": p}, x, segment_ids=seg_j) * w).sum()

    ref = jm.apply({"params": params}, jnp.asarray(u), segment_ids=seg_j)
    gp, gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(u))
    tm = tattn_mod.MHAOperator(128, num_heads=2, **kw, device=CPU)
    tm.load_state_dict(jax_weights.mha_state_dict(pnp), strict=True)
    ut = torch.from_numpy(u).requires_grad_()
    out = tm(ut, segment_ids=None if seg is None else torch.from_numpy(seg))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu),
                               atol=1e-4 * float(np.abs(gu).max()))
    _assert_grads(jax_weights.mha_state_dict(jax.tree_util.tree_map(np.asarray, gp)), tm)


@pytest.mark.parametrize("kw", [dict(rotary_dim=16), dict(alibi=True)])
def test_mha_step_decodes_like_the_forward_and_flax(kw):
    """step over a fresh cache, one position at a time, gives the forward's
    outputs at every position, and flax's apply_step the same."""
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 12, 128)).astype(np.float32)
    jm = jattn_mod.MHAOperator(d_model=128, num_heads=2, **kw)
    params, pnp = _init(jm, jnp.asarray(u))
    tm = tattn_mod.MHAOperator(128, num_heads=2, **kw, device=CPU).eval()
    tm.load_state_dict(jax_weights.mha_state_dict(pnp), strict=True)
    with torch.no_grad():
        full = tm(torch.from_numpy(u))
        cache = tm.init_cache(2, 16)
        steps = []
        for pos in range(12):
            y, cache = tm.step(torch.from_numpy(u[:, pos : pos + 1]), cache, pos)
            steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=1e-5)
    jcache = jm.init_cache(2, 16)
    for pos in range(12):
        jy, jcache = jm.apply_step({"params": params}, jnp.asarray(u[:, pos : pos + 1]), jcache,
                                   pos)
        np.testing.assert_allclose(steps[pos].numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)


GPT_CASES = {
    "gpt2": dict(d_model=128, n_layer=2, d_inner=512, vocab_size=200, l_max=64, num_heads=2),
    "opt_embed_dim": dict(d_model=128, n_layer=2, d_inner=512, vocab_size=200, l_max=64,
                          num_heads=2, embed_dim=64, mlp_activation="relu"),
    "rotary_remat": dict(d_model=128, n_layer=2, d_inner=512, vocab_size=200, l_max=64,
                         num_heads=2, mixer_kwargs={"rotary_dim": 64}, remat=True),
}


def _gpt_pair(case, **extra):
    """The flax model (without remat, which changes no number) and the port's,
    with the same weights."""
    cfg = GPT_CASES[case]
    jm = jgpt.GPTLMHeadModel(**{k: v for k, v in cfg.items() if k != "remat"},
                             dtype=jnp.float32, **extra)
    ids = np.random.default_rng(8).integers(0, cfg["vocab_size"], (2, 48))
    params, pnp = _init(jm, jnp.asarray(ids))
    tm = tgpt.GPTLMHeadModel(**cfg, dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.gpt_state_dict(pnp), strict=True)
    return jm, params, tm, ids


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_gpt_logits_and_grads_match_flax(case):
    jm, params, tm, ids = _gpt_pair(case)
    x, y = ids[:, :-1], ids[:, 1:]

    def loss(p):
        return jmetrics.cross_entropy(jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    ref_logits = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    ref_loss, gp = jax.jit(jax.value_and_grad(loss))(params)
    tm.train()  # remat replays blocks only with grad on; dropout stays off below
    tm.embed_drop.p = 0.0
    logits = tm(torch.from_numpy(x))
    lt = train.cross_entropy(logits, torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=1e-4)
    assert float(lt) == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_grads(jax_weights.gpt_state_dict(jax.tree_util.tree_map(np.asarray, gp)), tm)


@pytest.mark.parametrize("case", ["gpt2", "opt_embed_dim"])
def test_gpt_step_and_generate_kv_match_flax(case):
    """step over f32 caches gives the forward's logits at every position; the
    JAX package's generate_kv and the port's give the same greedy tokens."""
    jm, params, tm, ids = _gpt_pair(case)
    prompt = ids[:, :10]
    with torch.no_grad():
        full = tm(torch.from_numpy(prompt))
        caches = tm.init_cache(2, 24, torch.float32)
        steps = [tm.step(torch.from_numpy(prompt[:, p : p + 1]), caches, p)[0]
                 for p in range(10)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=1e-4)
    want = jgen.generate_kv(jm, params, jnp.asarray(prompt), 6, 24, temperature=0.0)
    got = generation.generate_kv(tm, torch.from_numpy(prompt), 6, 24, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        generation.generate_kv(tm, torch.from_numpy(prompt), 20, 24)


def test_conv_lm_with_the_mha_mixer_matches_flax():
    cfg = dict(d_model=128, n_layer=2, d_inner=256, vocab_size=64, l_max=32)
    mk = {"num_heads": 2, "alibi": True}
    jm = JLM(**cfg, mixer="mha", mixer_kwargs=mk, dtype=jnp.float32)
    ids = np.random.default_rng(9).integers(0, 64, (2, 32))
    params, pnp = _init(jm, jnp.asarray(ids))
    gp = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jnp.asarray(ids)).sum()))(params)
    tm = ConvLMHeadModel(**cfg, mixer="mha", mixer_kwargs=mk, dtype=torch.float32,
                         device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    logits = tm(torch.from_numpy(ids))
    logits.sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(ids))),
                               atol=1e-4)
    _assert_grads(jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, gp)), tm)
    with pytest.raises(ValueError, match="unknown mixer"):
        Block(16, 32, mixer="attention", device=CPU)


def test_gpt_train_steps_match_the_example_optax_chain():
    """Three steps of the examples/lm chain (clip_by_global_norm(1.0), then
    adamw over warmup_cosine_decay_schedule, decaying every parameter) on a
    2-layer f32 GPT, dropout off: lm_optimizer serves GPT as it is. Every
    parameter sits in a group that decays it by wd, and each element's change
    over the three steps matches optax's within 5e-3 of its parameter's
    largest |change|, 8e-6 here (the differences measured reach 1e-3 of it;
    the decay alone moves a LayerNorm scale by 1.5e-4 over the steps, 18
    times the tolerance). An element whose first gradient is at rounding
    level (below 1e-5 of its parameter's largest, as the key bias's, which
    softmax cancels) takes a step of either sign in either framework: those
    elements, under 1% of all, are held to Adam's bound of the summed lr
    alone."""
    lr, wd, warmup, steps = 1e-3, 0.1, 1, 3
    jm, params, tm, ids = _gpt_pair("gpt2", embed_dropout=0.0)
    x, y = ids[:, :-1], ids[:, 1:]
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1)),
        weight_decay=wd))
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(lambda p: jmetrics.cross_entropy(
            jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y)))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    jlosses, first_grads = [], None
    for _ in range(steps):
        params, opt_state, loss, grads = jstep(params, opt_state)
        jlosses.append(float(loss))
        first_grads = first_grads or jax_weights.gpt_state_dict(
            jax.tree_util.tree_map(np.asarray, grads))
    opt, sched = train.lm_optimizer(tm, lr=lr, weight_decay=wd, warmup=warmup, steps=steps)
    decayed = {id(p) for grp in opt.param_groups if grp["weight_decay"] == wd
               for p in grp["params"]}
    assert decayed == {id(p) for p in tm.parameters()}
    step = train.make_train_step(tm, opt, sched, clip=1.0)
    lrs, losses = [], []
    for _ in range(steps):
        lrs.append(opt.param_groups[0]["lr"])
        losses.append(float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = jax_weights.gpt_state_dict(jax.tree_util.tree_map(np.asarray, params))
    n_noise = n_all = 0
    for name, p in tm.named_parameters():
        change, ref = (p.detach() - before[name]).numpy(), (want[name] - before[name]).numpy()
        g = np.abs(first_grads[name].numpy())
        noise = g <= 1e-5 * g.max()
        n_noise, n_all = n_noise + int(noise.sum()), n_all + noise.size
        np.testing.assert_allclose(change[~noise], ref[~noise], atol=5e-3 * np.abs(ref).max(),
                                   rtol=0, err_msg=name)
        assert np.all(np.abs(change[noise]) <= 1.01 * sum(lrs)), name
    assert n_noise < 0.01 * n_all


def _hf_gpt2_state(rng, n_layer, d, vocab, n_pos):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    st = {"transformer.wte.weight": r(vocab, d), "transformer.wpe.weight": r(n_pos, d),
          "transformer.ln_f.weight": r(d), "transformer.ln_f.bias": r(d),
          "lm_head.weight": r(vocab, d)}
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        st.update({p + "ln_1.weight": r(d), p + "ln_1.bias": r(d), p + "ln_2.weight": r(d),
                   p + "ln_2.bias": r(d), p + "attn.c_attn.weight": r(d, 3 * d),
                   p + "attn.c_attn.bias": r(3 * d), p + "attn.c_proj.weight": r(d, d),
                   p + "attn.c_proj.bias": r(d), p + "mlp.c_fc.weight": r(d, 4 * d),
                   p + "mlp.c_fc.bias": r(4 * d), p + "mlp.c_proj.weight": r(4 * d, d),
                   p + "mlp.c_proj.bias": r(d), p + "attn.bias": np.ones((1, 1, 8, 8), np.float32)})
    return st


def _hf_opt_state(rng, n_layer, d, vocab, n_pos, proj):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    e = proj or d
    st = {"model.decoder.embed_tokens.weight": r(vocab, e),
          "model.decoder.embed_positions.weight": r(n_pos + 2, d),
          "model.decoder.final_layer_norm.weight": r(d),
          "model.decoder.final_layer_norm.bias": r(d), "lm_head.weight": r(vocab, e)}
    if proj:
        st["model.decoder.project_in.weight"] = r(d, e)
        st["model.decoder.project_out.weight"] = r(e, d)
    for i in range(n_layer):
        p = f"model.decoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            st[p + f"self_attn.{n}_proj.weight"] = r(d, d)
            st[p + f"self_attn.{n}_proj.bias"] = r(d)
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            st[p + f"{n}.weight"], st[p + f"{n}.bias"] = r(d), r(d)
        st[p + "fc1.weight"], st[p + "fc1.bias"] = r(4 * d, d), r(4 * d)
        st[p + "fc2.weight"], st[p + "fc2.bias"] = r(d, 4 * d), r(d)
    return st


@pytest.mark.parametrize("which", ["gpt2", "opt", "opt_proj"])
def test_gpt2_and_opt_imports_match_the_jax_import(which):
    """HuggingFace-keyed state dicts built in memory: the port's import gives
    the JAX import's parameters (through gpt_state_dict) and loads strictly
    into a GPTLMHeadModel whose logits match flax's on them."""
    rng = np.random.default_rng(10)
    n_layer, d, vocab, n_pos = 2, 64, 45, 32
    if which == "gpt2":
        state = _hf_gpt2_state(rng, n_layer, d, vocab, n_pos)
        want, jrep = jci.import_gpt2_state_dict(state, n_layer)
        got, rep = tci.import_gpt2_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                              n_layer)
        cfg = dict(mlp_activation="gelu")
    else:
        proj = 32 if which == "opt_proj" else None
        state = _hf_opt_state(rng, n_layer, d, vocab, n_pos, proj)
        want, jrep = jci.import_opt_state_dict(state, n_layer)
        got, rep = tci.import_opt_state_dict(state, n_layer)
        cfg = dict(mlp_activation="relu", embed_dim=proj)
    want_sd = jax_weights.gpt_state_dict(want)
    assert set(got) == set(want_sd)
    for name, t in want_sd.items():
        np.testing.assert_array_equal(got[name].numpy(), t.numpy(), err_msg=name)
    assert sorted(rep.skipped) == sorted(jrep.skipped)
    tm = tgpt.GPTLMHeadModel(d, n_layer, 4 * d, vocab, n_pos, num_heads=2, dtype=torch.float32,
                             device=CPU, **cfg).eval()
    tm.load_state_dict(got, strict=True)
    jm = jgpt.GPTLMHeadModel(d_model=d, n_layer=n_layer, d_inner=4 * d, vocab_size=vocab,
                             l_max=n_pos, num_heads=2, dtype=jnp.float32, **cfg)
    ids = rng.integers(0, vocab, (2, 16))
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids))
    ref = jm.apply({"params": want}, jnp.asarray(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-3 * float(np.abs(ref).max()))


@pytest.mark.parametrize("width", ["125m", "350m", "1.3b"])
def test_opt_lm_configs_match_jax(monkeypatch, width):
    """opt_lm passes the JAX package's OPT geometry (the model is not built)."""
    monkeypatch.setattr(tgpt, "GPTLMHeadModel", lambda **kw: kw)
    got = tgpt.opt_lm(50272, 2048, width, dtype=torch.float32)
    want = jgpt.opt_lm(50272, 2048, width)
    for name in ("d_model", "n_layer", "d_inner", "vocab_size", "l_max", "num_heads",
                 "embed_dim", "mlp_activation"):
        assert got[name] == getattr(want, name), name
