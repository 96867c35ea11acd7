"""Parity of the port's sequence-parallel FFT conv (``parallel/seq_conv.py``)
and of the Hyena LM on a sequence mesh with the JAX package, on the CPU.

The port runs in P spawned processes (P = 1, 2, 4) joined by ``gloo`` over
a ``FileStore``, each rank holding its chunk of the sequence; the JAX
package runs ``seq_fft_conv`` on a P-device mesh of the conftest's CPU
devices, with ``impl='pallas'`` (``_conv_tiles`` and ``_long_tiles`` in
interpret mode, with spies that assert they ran). The inputs are made with
numpy from a seed; the rank processes import this module, so it imports no
JAX at its top: the JAX side imports inside the tests. Every case of one P
runs in one spawn of P ranks, on first use.

Tolerances, those of the JAX package's own tests (``tests/test_parallel.py``):
f32 outputs at atol 1e-5 (the inputs are scaled by 0.02), bf16 at 1e-2,
grads of u, k and the gates at rtol 1e-3 and an atol of 1e-4 of each
grad's largest |value| (the JAX tests' fixed 2e-4 exceeds the gate grads
these inputs give), the 64K band
(``_long_tiles``) at 1e-3, the padded conv with a short kernel at 1e-5.
``band_conv`` alone against ``_band_conv_pallas_raw`` at 1e-4 of the
largest |y|, its grads against the custom VJP at 2e-4 and rtol 1e-3. The
2-layer LM on a seq mesh: logits at 5e-4 against the flax model on the same
mesh and the grads of one step at 5e-4 of each parameter's largest |grad|
(``tests/test_parallel.py:446-476``; weights carried by ``jax_weights``), and
at 2e-4 against the port's own model without a mesh.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
from flashfftconv_tpu_torch.ops import monarch_cuda
from flashfftconv_tpu_torch.ops import plan as tplan
from flashfftconv_tpu_torch.parallel import seq_conv
from flashfftconv_tpu_torch.utils import metrics

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"
LM = dict(vocab_size=32, d_model=16, n_layer=2, d_inner=32, l_max=512)
LM_MIXER = {"filter_order": 16}
# the in-projection and short conv in L-chunks (the halo seeds the carry) and
# the long conv in channel blocks, under the sequence mesh
LM_LEVERS = {"proj_l_chunks": 2, "conv_h_chunks": 2}
LM_BATCH = 2


# --- inputs (numpy, from seeds) --------------------------------------------

def _conv_inputs(seed, b, h, n, gated):
    """u and k as the JAX seq-conv tests make them (0.02-scaled, the kernel
    with a slow decay), unit-normal gates."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((b, h, n)) * 0.02).astype(np.float32)
    k = (rng.standard_normal((h, n)) * 0.02 * np.exp(-0.001 * np.arange(n))).astype(np.float32)
    gates = [rng.standard_normal((b, h, n)).astype(np.float32) for _ in range(2 * gated)]
    return u, k, gates


def _cases(world):
    """{name: case} of one spawn of ``world`` ranks; each case holds its
    global inputs and what the ranks compute."""
    cases = {}
    n = 256 * world  # N2 = 256: the band_conv route, _conv_tiles in JAX
    cases["f32"] = dict(kind="conv", args=_conv_inputs(world, 2, 3, n, False), dtype="f32")
    cases["bf16_gated"] = dict(kind="conv", args=_conv_inputs(10 + world, 2, 3, n, True),
                               dtype="bf16")
    cases["grads"] = dict(kind="conv", args=_conv_inputs(20 + world, 2, 3, n, True),
                          dtype="f32", grads=True)
    rng = np.random.default_rng(30 + world)
    cases["padded"] = dict(kind="padded", u=(rng.standard_normal((2, 3, 512)) * 0.02)
                           .astype(np.float32),
                           k=(rng.standard_normal((3, 200)) * 0.02).astype(np.float32))
    if world == 1:  # N2 = 65536: four real convs in the port, _long_tiles in JAX
        cases["long"] = dict(kind="conv", args=_conv_inputs(40, 1, 1, 65536, False), dtype="f32")
    else:
        cases["errors"] = dict(kind="errors", chunks=(18, 8, 24))
        ids = np.random.default_rng(50).integers(0, LM["vocab_size"], (LM_BATCH, LM["l_max"] + 1))
        cases["lm"] = dict(kind="lm", state=_lm_state(), ids=ids, mixer={})
        cases["lm_levers"] = dict(kind="lm", state=_lm_state(), ids=ids, mixer=LM_LEVERS)
        rng = np.random.default_rng(60 + world)
        cases["long_conv_op"] = dict(
            kind="long_conv_op", state=_long_conv_state(),
            x=rng.standard_normal((2, LC["l_max"], LC["d_model"])).astype(np.float32),
            dout=rng.standard_normal((2, LC["l_max"], LC["d_model"])).astype(np.float32))
    return cases


# LongConvOperator on the mesh: its kernel is as long as the FFT (2 l_max)
LC = dict(d_model=16, l_max=256, lam=0.003)


def _long_conv_state():
    """A seeded port LongConvOperator's weights, as numpy."""
    from flashfftconv_tpu_torch.models.long_conv import LongConvOperator

    op = LongConvOperator(**LC, conv_dtype=torch.float32, device=CPU,
                          generator=torch.Generator().manual_seed(7))
    with torch.no_grad():  # kernel taps large enough to pass the squash
        op.conv.kernel.mul_(10)
    return {n: t.numpy() for n, t in op.state_dict().items()}


_LM_STATE = {}


def _lm_state():
    """The flax LM's initial parameters (as numpy) and the port's state
    dict from them."""
    if not _LM_STATE:
        import jax
        import jax.numpy as jnp

        from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
        from flashfftconv_tpu_torch.utils import jax_weights

        jm = JLM(**LM, dtype=jnp.float32,
                 mixer_kwargs={**LM_MIXER, "conv_dtype": jnp.float32, "impl": "xla"})
        ids = jnp.zeros((LM_BATCH, LM["l_max"]), jnp.int32)
        params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), ids)["params"])
        _LM_STATE["params"] = params
        _LM_STATE["torch"] = {n: t.numpy() for n, t in jax_weights.from_jax_params(params).items()}
    return _LM_STATE["torch"]


# --- what each rank runs (no JAX here) ---------------------------------------

def _chunk(a, world, rank):
    c = a.shape[-1] // world
    return torch.from_numpy(np.ascontiguousarray(a[..., rank * c:(rank + 1) * c]))


def _run_conv(case, mesh, world, rank):
    u, k, gates = case["args"]
    dtype = torch.bfloat16 if case["dtype"] == "bf16" else torch.float32
    tu, tk = _chunk(u, world, rank).to(dtype), _chunk(k, world, rank)
    tg = [_chunk(g, world, rank).to(dtype) for g in gates]
    ts = [tu, tk, *tg]
    if case.get("grads"):
        for t in ts:
            t.requires_grad_()
    y = seq_conv.seq_fft_conv(tu, tk, mesh, pregate=tg[0] if tg else None,
                              postgate=tg[1] if tg else None)
    out = {"y": y.detach().float().numpy()}
    if case.get("grads"):
        (y.float() ** 2).sum().backward()
        out["grads"] = [t.grad.float().numpy() for t in ts]
    return out


def _run_padded(case, mesh, world, rank):
    tu = _chunk(case["u"], world, rank).requires_grad_()
    tk = torch.from_numpy(case["k"]).requires_grad_()
    y = seq_conv.seq_fft_conv_padded(tu, tk, mesh)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "du": tu.grad.numpy(), "dk": tk.grad.numpy()}


def _run_errors(case, mesh, world, rank):
    msgs = []
    for c in case["chunks"]:
        try:
            seq_conv.seq_fft_conv(torch.zeros(1, 2, c), torch.zeros(2, c), mesh)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return {"messages": msgs}


def _run_lm(case, mesh, world, rank):
    model = ConvLMHeadModel(**LM, dtype=torch.float32, device=CPU, mixer_kwargs={
        **LM_MIXER, **case["mixer"], "conv_dtype": torch.float32, "seq_mesh": mesh,
        "seq_axis": "sp"}).eval()
    model.load_state_dict({n: torch.from_numpy(a) for n, a in case["state"].items()})
    ids = case["ids"]
    x, y = _chunk(ids[:, :-1], world, rank), _chunk(ids[:, 1:], world, rank)
    logits = model(x)
    loss = seq_conv.seq_backward(model, metrics.cross_entropy(logits, y), y.numel(),
                                 seq_conv.seq_group(model))
    out = {"logits": logits.detach().numpy(), "loss": float(loss)}
    if rank == 0:
        out["grads"] = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return out


def _run_long_conv_op(case, mesh, world, rank):
    """The rank's chunk (B, L/P, D) through LongConvOperator(seq_mesh): its
    output chunk, its input grad and its share of the parameters' grads."""
    from flashfftconv_tpu_torch.models.long_conv import LongConvOperator

    op = LongConvOperator(**LC, conv_dtype=torch.float32, seq_mesh=mesh, seq_axis="sp",
                          device=CPU)
    op.load_state_dict({n: torch.from_numpy(a) for n, a in case["state"].items()})
    c = LC["l_max"] // world
    x = torch.from_numpy(np.ascontiguousarray(case["x"][:, rank * c:(rank + 1) * c]))
    x.requires_grad_()
    y = op(x)
    (y * torch.from_numpy(np.ascontiguousarray(case["dout"][:, rank * c:(rank + 1) * c]))
     ).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "grads": {n: p.grad.numpy() for n, p in op.named_parameters()}}


_RUNNERS = {"conv": _run_conv, "padded": _run_padded, "errors": _run_errors, "lm": _run_lm,
            "long_conv_op": _run_long_conv_op}


def _rank_main(rank, world, store, cases_path, out_dir):
    """One rank: join the gloo group, build the 1-D mesh, run every case."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh(CPU, (world,), mesh_dim_names=("sp",))
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        res = {name: _RUNNERS[case["kind"]](case, mesh, world, rank)
               for name, case in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


_RESULTS = {}


def _ranks(world):
    """Every case of ``world`` ranks, run once: (cases, [result of each rank])."""
    if world not in _RESULTS:
        cases = _cases(world)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "cases.pkl")
            with open(path, "wb") as f:
                pickle.dump(cases, f)
            mp.spawn(_rank_main, args=(world, os.path.join(tmp, "store"), path, tmp),
                     nprocs=world)
            res = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    res.append(pickle.load(f))
        _RESULTS[world] = cases, res
    return _RESULTS[world]


# --- the JAX side --------------------------------------------------------------

class _Spy:
    """Counts the calls of a monarch_pallas kernel function while a test runs."""

    def __init__(self, monkeypatch, name):
        from flashfftconv_tpu.ops import monarch_pallas

        self.calls, orig = 0, getattr(monarch_pallas, name)

        def spy(*args, **kwargs):
            self.calls += 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(monarch_pallas, name, spy)


def _jax_mesh(world):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:world]), ("sp",))


# --- band_conv alone ----------------------------------------------------------

def _jax_band_plan(n2):
    """The JAX package's band plan at N2, split close to square as
    seq_fft_conv splits a single-factor plan."""
    import jax.numpy as jnp

    from flashfftconv_tpu.ops.plan import make_plan

    plan = make_plan(n2, compute_dtype=jnp.float32)
    if len(plan.factors) == 1:
        f1 = 1 << (n2.bit_length() // 2)
        plan = make_plan(n2, compute_dtype=jnp.float32,
                         factors=(max(f1, n2 // f1), min(f1, n2 // f1)))
    return plan


@pytest.mark.parametrize("n2", [256, 2048])
def test_band_conv_matches_jax_band_conv_pallas(monkeypatch, n2):
    """band_conv_plain, the band_conv wrapper and BandConvFunction on the CPU
    against _band_conv_pallas_raw (_conv_tiles, complex contract, interpret
    mode), then grads against jax.grad through its custom VJP."""
    import jax
    import jax.numpy as jnp

    from flashfftconv_tpu.ops import monarch_pallas
    from flashfftconv_tpu.ops.plan import kf_permute, kf_unpermute
    from flashfftconv_tpu.parallel import seq_conv as jseq

    spy = _Spy(monkeypatch, "_conv_tiles")
    rng = np.random.default_rng(n2)
    b, h = 2, 3
    bre, bim, gre, gim = (rng.standard_normal((b, h, n2)).astype(np.float32) for _ in "abcd")
    kre, kim = (rng.standard_normal((h, n2)).astype(np.float32) for _ in "ab")
    jp = _jax_band_plan(n2)
    jk = [kf_permute(jnp.asarray(a), jp.factors) for a in (kre, kim)]
    ore, oim = jax.jit(lambda *a: jseq._band_conv_pallas_raw(jp, *a))(
        jnp.asarray(bre), jnp.asarray(bim), *jk)
    want = np.asarray(ore) + 1j * np.asarray(oim)
    tp = tplan.make_plan(2 * n2, torch.float32, device=CPU)
    tb = torch.complex(torch.from_numpy(bre), torch.from_numpy(bim))
    tk = torch.complex(torch.from_numpy(kre), torch.from_numpy(kim))
    tol = 1e-4 * np.abs(want).max()
    for got in (monarch_cuda.band_conv(tp, tb, tk),
                monarch_cuda.BandConvFunction.apply(tp, tb, tk)):
        assert got.dtype == torch.complex64 and got.shape == (b, h, n2)
        np.testing.assert_allclose(got.numpy(), want, atol=tol)
    assert spy.calls == 1

    key = monarch_pallas._register(jp)

    def loss(*a):
        yre, yim = jseq._band_conv_pallas(key, *a)
        return jnp.sum(yre * gre + yim * gim)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(jnp.asarray(bre), jnp.asarray(bim), *jk)
    want_db = np.asarray(jg[0]) + 1j * np.asarray(jg[1])
    want_dk = np.asarray(kf_unpermute(jg[2], jp.factors) + 1j * kf_unpermute(jg[3], jp.factors))
    tb.requires_grad_()
    tk.requires_grad_()
    y = monarch_cuda.BandConvFunction.apply(tp, tb, tk)
    (y.real * torch.from_numpy(gre) + y.imag * torch.from_numpy(gim)).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), want_db, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(tk.grad.numpy(), want_dk, atol=2e-4, rtol=1e-3)
    assert spy.calls == 3  # the forward and the conj-kernel backward


@pytest.mark.parametrize("n2", [16 << i for i in range(11)])
def test_band_conv_matches_torch_fft_at_every_band_length(n2):
    """The band_conv wrapper on the CPU at every band length its kernel is
    instantiated for (N2 = 16 ... 16384), both conj, against torch.fft's
    ifft(fft(b) * K) at the card's band_tol, 1e-4 of the largest |y|."""
    rng = np.random.default_rng(n2)
    b, h = 2, 3
    cplx = lambda *s: torch.complex(*(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                                      for _ in "ab"))
    x, k_f = cplx(b, h, n2), cplx(h, n2)
    tp = tplan.make_plan(2 * n2, torch.float32, device=CPU)
    for conj in (False, True):
        want = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128))
                              * (k_f.conj() if conj else k_f).to(torch.complex128))
        got = monarch_cuda.band_conv(tp, x, k_f, conj)
        assert got.dtype == torch.complex64 and got.shape == (b, h, n2)
        tol = 1e-4 * float(want.abs().max()) + 1e-7
        assert float((got.to(torch.complex128) - want).abs().max()) <= tol


# --- seq_fft_conv --------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_seq_fft_conv_raises_as_jax(world):
    """An untileable N, a per-device length below 16 and one that is no
    power of two raise the JAX package's ValueErrors, word for word."""
    import jax.numpy as jnp

    from flashfftconv_tpu.parallel import seq_conv as jseq

    cases, res = _ranks(world)
    mesh = _jax_mesh(world)
    for chunk, got in zip(cases["errors"]["chunks"], res[0]["errors"]["messages"]):
        n = world * chunk
        with pytest.raises(ValueError) as want:
            with mesh:
                jseq.seq_fft_conv(jnp.zeros((1, 2, n)), jnp.zeros((2, n)), mesh, axis="sp")
        assert got == str(want.value), (chunk, got)


# --- the Hyena LM on a sequence mesh ----------------------------------------


def _assert_matches_plain_lm(case, res, name):
    """The ranks' logits and rank 0's summed grads against the port's own
    LM without a mesh, the same weights and mixer options, at 2e-4."""
    plain = ConvLMHeadModel(**LM, dtype=torch.float32, device=CPU, mixer_kwargs={
        **LM_MIXER, **case["mixer"], "conv_dtype": torch.float32}).eval()
    plain.load_state_dict({n: torch.from_numpy(a) for n, a in case["state"].items()})
    ids = case["ids"]
    out = plain(torch.from_numpy(ids[:, :-1]))
    metrics.cross_entropy(out, torch.from_numpy(ids[:, 1:])).backward()
    got_logits = np.concatenate([r[name]["logits"] for r in res], axis=1)
    np.testing.assert_allclose(got_logits, out.detach().numpy(), atol=2e-4)
    for pname, prm in plain.named_parameters():
        ref = prm.grad.numpy()
        err = np.abs(res[0][name]["grads"][pname] - ref).max()
        assert err <= 2e-4 * np.abs(ref).max() + 1e-7, pname


@pytest.mark.parametrize("world", [2, 4])
def test_seq_lm_levers_match_the_plain_lm(world):
    """proj_l_chunks (the first chunk's carry is the previous rank's halo)
    and conv_h_chunks under the sequence mesh: logits and grads against the
    port's LM without a mesh with the same levers."""
    cases, res = _ranks(world)
    _assert_matches_plain_lm(cases["lm_levers"], res, "lm_levers")


def test_hyena_operator_accepts_a_seq_mesh():
    """HyenaOperator(seq_mesh=...) builds (the port used to refuse it) and
    keeps the mesh; make_train_step finds its group."""
    from flashfftconv_tpu_torch.models.hyena import HyenaOperator

    class _Mesh:
        def get_group(self, axis):
            return ("group", axis)

    op = HyenaOperator(16, 64, seq_mesh=_Mesh(), seq_axis="sp", device=CPU)
    assert op.seq_mesh is not None and op.seq_axis == "sp"
    assert seq_conv.seq_group(torch.nn.Sequential(op)) == ("group", "sp")
    assert seq_conv.seq_group(torch.nn.Linear(2, 2)) is None


@pytest.mark.parametrize("world", [2, 4])
def test_long_conv_operator_on_a_seq_mesh_matches_the_plain_operator(world):
    """LongConvOperator(seq_mesh) on P gloo ranks, each with its chunk of the
    sequence (L = l_max = 256, FFT size 512, a kernel of 512 taps): the
    joined outputs and input grads, and the parameters' grads summed over
    the ranks (as seq_backward sums them), against the port's operator
    without a mesh on the whole sequence: outputs at 1e-5 of the largest
    |value|, grads at 1e-4 of each largest |grad|."""
    from flashfftconv_tpu_torch.models.long_conv import LongConvOperator

    cases, res = _ranks(world)
    case = cases["long_conv_op"]
    op = LongConvOperator(**LC, conv_dtype=torch.float32, device=CPU)
    op.load_state_dict({n: torch.from_numpy(a) for n, a in case["state"].items()})
    x = torch.from_numpy(case["x"]).requires_grad_()
    y = op(x)
    (y * torch.from_numpy(case["dout"])).sum().backward()
    got_y = np.concatenate([r["long_conv_op"]["y"] for r in res], axis=1)
    got_dx = np.concatenate([r["long_conv_op"]["dx"] for r in res], axis=1)
    ref_y, ref_dx = y.detach().numpy(), x.grad.numpy()
    np.testing.assert_allclose(got_y, ref_y, atol=1e-5 * np.abs(ref_y).max())
    np.testing.assert_allclose(got_dx, ref_dx, atol=1e-4 * np.abs(ref_dx).max())
    for name, p in op.named_parameters():
        got = sum(r["long_conv_op"]["grads"][name] for r in res)
        ref = p.grad.numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max() + 1e-7, err_msg=name)
