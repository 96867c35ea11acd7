"""Parity of the port's parallel layer (``parallel/mesh.py``,
``parallel/pipeline.py``, ``ops/fused.vocab_parallel_cross_entropy``,
``models/moe.MoEMlp`` over an ``ep`` mesh dimension) with the JAX package,
on the CPU: the cases of the JAX package's ``tests/test_parallel.py``.

The port runs in P spawned processes (P = 1, 2, 4) joined by ``gloo`` over
a ``FileStore``; each rank holds only its shard of every tensor a sharding
splits and returns its results as numpy, with its local shapes. Every case
of one P runs in one spawn, on first use. The JAX side runs, jitted, on a
mesh of the conftest's virtual CPU devices of the same shape; the weights
are made by flax and carried across by ``utils.jax_weights``, the inputs by
a seeded numpy generator. The rank processes import this module, which
therefore imports JAX only inside its tests.

Tolerances are those of the JAX tests: 1e-5 for the sharded convs and the
pointwise GELU, 1e-6 for the ZeRO-1 and ZeRO-2 updates and losses, 1e-6 for
the tanh pipeline's forward and 1e-5 for its grads, 1e-4 for the pipelined
Hyena blocks. The vocab-parallel cross entropy and its logit grads, the
dp x tp LongConvModel step of ``__graft_entry__.dryrun_multichip`` and the
dp x ep MoE LM step (loss and updated parameters) are held at 1e-5. Every
multi-rank train step also returns the gradients its optimizer steps (after
the dp reduction and the clip, gathered to full shape), held to the JAX
gradients at 1e-5 of each parameter's largest |grad|: one Adam step reads
little more than each gradient's sign, so the parameters alone would not
show a gradient scaled by a positive factor. The
dryrun's model runs here with dropout 0 and an f32 conv: the frameworks
draw different dropout masks, and a bf16 conv rounds differently in each.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"
WORLDS = (1, 2, 4)
# __graft_entry__._build_model's LongConvModel, dropout 0, f32 conv
DRYRUN = dict(d_input=3, d_output=10, d_model=64, n_layers=2, l_max=128)
HYENA_LM = dict(d_model=16, n_layer=2, d_inner=32, vocab_size=32, l_max=64)
HYENA_CHUNKS = 4  # mlp_l_chunks of the ChunkedMlp case
MOE_LM = dict(d_model=16, n_layer=2, d_inner=32, vocab_size=32, l_max=32)
MOE = {"n_experts": 4, "top_k": 1, "ep_axis": "ep"}
BLOCK = dict(d_model=16, d_inner=32)
BLOCK_L, BLOCK_B = 64, 4


# --- the JAX side's parameters (made in the parent, before the spawn) -----------------

_JAX = {}


def _jax_models():
    """The flax models of the cases and their initial parameters (numpy)."""
    if not _JAX:
        import jax
        import jax.numpy as jnp

        import __graft_entry__
        from flashfftconv_tpu.models.lm import Block, ConvLMHeadModel

        init = lambda m, x, seed: jax.tree_util.tree_map(
            np.asarray, jax.jit(m.init)(jax.random.PRNGKey(seed), x)["params"])
        dry = __graft_entry__._build_model(impl="xla").clone(dropout=0.0,
                                                              conv_dtype=jnp.float32)
        params = init(dry, jnp.zeros((2, 128, 3)), 0)
        for i in range(DRYRUN["n_layers"]):  # kernel taps large enough to pass the squash
            params[f"layer_{i}"]["kernel"] = params[f"layer_{i}"]["kernel"] * 100
        _JAX["dryrun"] = dry, params
        mix = {"impl": "xla", "conv_dtype": jnp.float32}
        lm = ConvLMHeadModel(**HYENA_LM, mixer_kwargs={**mix, "filter_order": 16},
                             embed_dropout=0.0, dtype=jnp.float32)
        _JAX["hyena_lm"] = lm, init(lm, jnp.zeros((2, 64), jnp.int32), 1)
        moe = ConvLMHeadModel(**MOE_LM, mixer="hyena", mixer_kwargs=mix, moe_kwargs=MOE,
                              dtype=jnp.float32)
        _JAX["moe_lm"] = moe, init(moe, jnp.zeros((4, 32), jnp.int32), 0)
        block = Block(**BLOCK, mixer="hyena", mixer_kwargs={"l_max": BLOCK_L, **mix})
        x = jnp.zeros((BLOCK_B, BLOCK_L, BLOCK["d_model"]))
        block_init = jax.jit(block.init)  # one compile for the four stages
        _JAX["block"] = block, [jax.tree_util.tree_map(np.asarray, block_init(
            jax.random.PRNGKey(10 + i), x)["params"]) for i in range(4)]
    return _JAX


def _state(kind, params):
    from flashfftconv_tpu_torch.utils import jax_weights

    if kind == "dryrun":
        sd = jax_weights.long_conv_model_state_dict(params)
    elif kind == "block":
        sd = jax_weights._block_state_dict(params, "")
    else:
        sd = jax_weights.from_jax_params(params)
    return {n: t.numpy() for n, t in sd.items()}


def _rng(seed):
    return np.random.default_rng(seed)


def _cases(world):
    """{name: case} of one spawn of ``world`` ranks."""
    cases = {"mesh": dict(kind="mesh")}
    g = _rng(world)
    cases["tanh_pipe"] = dict(kind="tanh_pipe", mesh=(world,), names=("pp",),
                              w=(g.standard_normal((world, 16, 16)) * 0.3).astype(np.float32),
                              b=(g.standard_normal((world, 16)) * 0.1).astype(np.float32),
                              x=g.standard_normal((8, 16)).astype(np.float32), m=4)
    if world == 1:
        cases["chunked_splits"] = dict(kind="chunked_splits")
        return cases
    cases["h_conv"] = dict(kind="h_conv", u=(g.standard_normal((2, 16, 1024)) * 0.02
                                             ).astype(np.float32),
                           k=(g.standard_normal((16, 1024)) * 0.02).astype(np.float32))
    cases["dp_conv"] = dict(kind="dp_conv", u=(g.standard_normal((4 * world, 4, 512)) * 0.02
                                               ).astype(np.float32),
                            k=(g.standard_normal((4, 512)) * 0.02).astype(np.float32))
    cases["seq_gelu"] = dict(kind="seq_gelu", x=g.standard_normal((2, 64, 8)).astype(np.float32),
                             w=g.standard_normal((8, 8)).astype(np.float32))
    cases["zero1"] = dict(kind="zero1", w=g.standard_normal((16, 8)).astype(np.float32))
    cases["zero2"] = dict(kind="zero2", w=(g.standard_normal((16, 10)) * 0.1).astype(np.float32),
                          x=g.standard_normal((16, 16)).astype(np.float32),
                          y=g.integers(0, 10, 16))
    labels = g.integers(0, 128, (2, 8))
    cases["vocab_ce"] = dict(kind="vocab_ce", logits=g.standard_normal((2, 8, 128)
                                                                       ).astype(np.float32),
                             labels=labels, labels_ignored=np.where(
                                 np.arange(16).reshape(2, 8) == 0, -100, labels))
    if world == 4:
        jx = _jax_models()
        cases["dryrun"] = dict(kind="dryrun", state=_state("dryrun", jx["dryrun"][1]),
                               x=g.standard_normal((8, 128, 3)).astype(np.float32),
                               y=g.integers(0, 10, 8))
        cases["hyena_tp"] = dict(kind="hyena_tp", state=_state("hyena_lm", jx["hyena_lm"][1]),
                                 ids=g.integers(0, 32, (4, 65)))
        moe_ids = g.integers(0, 32, (4, 32))
        for shape in ((1, 4), (2, 2)):
            cases[f"moe_{shape[0]}x{shape[1]}"] = dict(
                kind="moe", mesh=shape, state=_state("moe", jx["moe_lm"][1]), ids=moe_ids)
        cases["dp_pp"] = dict(kind="tanh_pipe", mesh=(2, 2), names=("dp", "pp"),
                              w=(g.standard_normal((2, 16, 16)) * 0.3).astype(np.float32),
                              b=(g.standard_normal((2, 16)) * 0.1).astype(np.float32),
                              x=g.standard_normal((8, 16)).astype(np.float32), m=2)
        cases["block_pipe"] = dict(
            kind="block_pipe", states=[_state("block", p) for p in jx["block"][1]],
            x=g.standard_normal((BLOCK_B, BLOCK_L, BLOCK["d_model"])).astype(np.float32))
    # the Hyena LM with a ChunkedMlp on (dp, tp) = (world / 2, 2), a generator of its own
    cases["hyena_chunked"] = dict(kind="hyena_tp", mesh=(world // 2, 2), chunks=HYENA_CHUNKS,
                                  state=_state("hyena_lm", _jax_models()["hyena_lm"][1]),
                                  ids=_rng(100 + world).integers(0, 32, (4, 65)))
    return cases


# --- what each rank runs (no JAX here) --------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _full(t, sharding):
    """The whole tensor from every rank's shard (``sharding.local``'s inverse)."""
    for d, name in reversed(sharding.sharded_dims()):
        group = sharding.mesh.get_group(name)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat(parts, dim=d)
    return t


def _run_mesh(case, world, rank):
    from flashfftconv_tpu_torch.parallel.mesh import make_mesh, mesh_axes

    out = {"default": mesh_axes(make_mesh(axis_names=("dp", "tp"), device=CPU))}
    if world >= 2:
        out["explicit"] = mesh_axes(make_mesh((world // 2, 2), ("dp", "tp"), device=CPU))
    try:
        make_mesh((3, 2), ("dp", "tp"), device=CPU)
    except ValueError as e:
        out["error"] = str(e)
    return out


def _run_h_conv(case, world, rank):
    from flashfftconv_tpu_torch import make_plan
    from flashfftconv_tpu_torch.ops import dispatch
    from flashfftconv_tpu_torch.parallel.mesh import Sharding, make_mesh

    mesh = make_mesh((1, world), ("dp", "tp"), device=CPU)
    u = Sharding(mesh, (None, "tp", None)).local(_t(case["u"]))
    k = Sharding(mesh, ("tp", None)).local(_t(case["k"]))
    y = dispatch.fft_conv(make_plan(1024, torch.float32, device=CPU), u, k)
    return {"y": y.numpy(), "shape": tuple(u.shape)}


def _run_dp_conv(case, world, rank):
    from flashfftconv_tpu_torch import make_plan
    from flashfftconv_tpu_torch.ops import dispatch
    from flashfftconv_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    mesh = make_mesh((world, 1), ("dp", "tp"), device=CPU)
    u = batch_sharding(mesh, 3).local(_t(case["u"]))
    y = dispatch.fft_conv(make_plan(512, torch.float32, device=CPU), u, _t(case["k"]))
    return {"y": y.numpy(), "shape": tuple(u.shape)}


def _run_seq_gelu(case, world, rank):
    import torch.nn.functional as F

    from flashfftconv_tpu_torch.parallel.mesh import make_mesh, sequence_sharding

    mesh = make_mesh((1, world), ("dp", "tp"), device=CPU)
    sh = sequence_sharding(mesh, 3, seq_axis=1)
    x = sh.local(_t(case["x"]))
    y = F.gelu(x @ _t(case["w"]), approximate="tanh")
    return {"y": _full(y, sh).numpy(), "shape": tuple(x.shape),
            "placements": [repr(p) for p in sh.placements]}


class _Params(torch.nn.Module):
    """One weight w; forward(x) = x @ w, or w itself when x is None."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(_t(w).clone())

    def forward(self, x):
        return self.w * 1.0 if x is None else x @ self.w


def _run_zero1(case, world, rank):
    from flashfftconv_tpu_torch.parallel.mesh import make_mesh, zero1_shardings
    from flashfftconv_tpu_torch.utils.train import make_train_step

    mesh = make_mesh((world, 1), ("dp", "tp"), device=CPU)
    model = _Params(case["w"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, opt, clip=math.inf, loss_fn=lambda out, y: out.sum(),
                           opt_shardings=zero1_shardings(mesh, model))
    step(None, None)  # the grad of w.sum() is ones, as the JAX test's grads
    moments = {k: tuple(v.shape) for s in opt.state.values() for k, v in s.items() if v.ndim}
    return {"w": model.w.detach().numpy(), "moments": moments}


def _run_zero2(case, world, rank):
    from flashfftconv_tpu_torch.parallel.mesh import batch_sharding, make_mesh, zero2_shardings
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy
    from flashfftconv_tpu_torch.utils.train import make_train_step

    mesh = make_mesh((world, 1), ("dp", "tp"), device=CPU)
    model = _Params(case["w"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    calls = []
    orig = dist.reduce_scatter_tensor

    def spy(out, inp, *args, **kwargs):
        calls.append((tuple(inp.shape), tuple(out.shape)))
        return orig(out, inp, *args, **kwargs)

    dist.reduce_scatter_tensor = spy
    seen = _grads_at_step(model, opt)
    try:
        step = make_train_step(model, opt, clip=math.inf, loss_fn=cross_entropy,
                               grad_shardings=zero2_shardings(mesh, model))
        x = batch_sharding(mesh, 2).local(_t(case["x"]))
        y = batch_sharding(mesh, 1).local(_t(case["y"]))
        m = step(x, y)
    finally:
        dist.reduce_scatter_tensor = orig
    moments = {k: tuple(v.shape) for s in opt.state.values() for k, v in s.items() if v.ndim}
    return {"w": model.w.detach().numpy(), "loss": float(m["loss"]), "calls": calls,
            "moments": moments, "grads": _full_grads(model, seen, mesh)}


def _run_vocab_ce(case, world, rank):
    from flashfftconv_tpu_torch.ops.fused import vocab_parallel_cross_entropy
    from flashfftconv_tpu_torch.parallel.mesh import Sharding, make_mesh

    mesh = make_mesh((1, world), ("dp", "tp"), device=CPU)
    sh = Sharding(mesh, (None, None, "tp"))
    out = {}
    for labels in ("labels", "labels_ignored"):
        for smooth in (0.0, 0.1):
            lg = sh.local(_t(case["logits"])).requires_grad_()
            loss = vocab_parallel_cross_entropy(lg, _t(case[labels]), mesh, "tp",
                                                label_smoothing=smooth)
            loss.backward()
            out[labels, smooth] = (float(loss), _full(lg.grad, sh).numpy(), tuple(lg.shape))
    return out


def _run_tanh_pipe(case, world, rank):
    from flashfftconv_tpu_torch.parallel.mesh import make_mesh
    from flashfftconv_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        stack_stage_params,
        stage_param_shardings,
    )

    mesh = make_mesh(case["mesh"], case["names"], device=CPU)
    s = case["w"].shape[0]
    stacked = stack_stage_params([{"w": _t(case["w"][i]), "b": _t(case["b"][i])}
                                  for i in range(s)])
    local = {n: sh.local(stacked[n]).requires_grad_()
             for n, sh in stage_param_shardings(mesh, stacked).items()}
    batch = "dp" in case["names"]
    x = _t(case["x"])
    if batch:
        from flashfftconv_tpu_torch.parallel.mesh import batch_sharding

        x = batch_sharding(mesh, 2).local(x)
    x.requires_grad_()
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), local, x, mesh,
                       num_microbatches=case["m"], batch_axis="dp" if batch else None)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "grads": {n: t.grad.numpy() for n, t in local.items()},
            "shapes": {n: tuple(t.shape) for n, t in local.items()}}


def _run_block_pipe(case, world, rank):
    from torch.func import functional_call

    from flashfftconv_tpu_torch.models.lm import Block
    from flashfftconv_tpu_torch.parallel.mesh import make_mesh
    from flashfftconv_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        stack_stage_params,
        stage_param_shardings,
    )

    mesh = make_mesh((world,), ("pp",), device=CPU)
    block = Block(**BLOCK, mixer="hyena",
                  mixer_kwargs={"l_max": BLOCK_L, "conv_dtype": torch.float32},
                  device=CPU).eval()
    stacked = stack_stage_params([{n: _t(a) for n, a in st.items()} for st in case["states"]])
    local = {n: sh.local(stacked[n]).requires_grad_()
             for n, sh in stage_param_shardings(mesh, stacked).items()}
    y = pipeline_apply(lambda p, h: functional_call(block, p, (h,)), local, _t(case["x"]), mesh)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "grads": {n: t.grad.numpy() for n, t in local.items()}}


def _gathered_params(model):
    return {n: _full(p.detach(), p.sharding).numpy() if getattr(p, "sharding", None) is not None
            else p.detach().numpy() for n, p in model.named_parameters()}


def _grads_at_step(model, opt):
    """{name: gradient} filled when opt.step() starts, with the tensor the
    optimizer steps for each parameter: after the dp reduction and the clip,
    a ZeRO shard where the step swapped one in. Call before make_train_step,
    which keeps each parameter's place in the param groups."""
    names = {id(p): n for n, p in model.named_parameters()}
    places = [(i, j, names[id(p)]) for i, g in enumerate(opt.param_groups)
              for j, p in enumerate(g["params"])]
    seen = {}

    def hook(optimizer, args, kwargs):
        for i, j, name in places:
            t = optimizer.param_groups[i]["params"][j]
            if t.grad is not None:
                seen[name] = t.grad.detach().clone()

    opt.register_step_pre_hook(hook)
    return seen


def _full_grads(model, seen, mesh):
    """The gradients of ``_grads_at_step`` at the parameters' full shapes: a
    ZeRO shard all-gathered over dp, then a tensor- or expert-parallel shard
    over its mesh dimensions."""
    from flashfftconv_tpu_torch.parallel.mesh import Sharding

    params = dict(model.named_parameters())
    out = {}
    for name in sorted(seen):  # one order on every rank
        g, p = seen[name], params[name]
        if g.shape != p.shape:
            d = next(i for i, (a, b) in enumerate(zip(g.shape, p.shape)) if a != b)
            g = _full(g, Sharding(mesh, tuple("dp" if i == d else None for i in range(g.ndim))))
        if getattr(p, "sharding", None) is not None:
            g = _full(g, p.sharding)
        out[name] = g.numpy()
    return out


def _run_dryrun(case, world, rank):
    """__graft_entry__.dryrun_multichip's step on a (dp, tp) = (2, 2) mesh:
    LongConvModel parameters by param_shardings, the batch over dp,
    make_optimizer(lr=1e-3, special_lr=1e-3), no clip."""
    from flashfftconv_tpu_torch.models.long_conv import LongConvModel
    from flashfftconv_tpu_torch.parallel.mesh import (
        batch_sharding,
        make_mesh,
        param_shardings,
        shard_parameters,
    )
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy
    from flashfftconv_tpu_torch.utils.optim import make_optimizer
    from flashfftconv_tpu_torch.utils.train import make_train_step

    mesh = make_mesh((2, 2), ("dp", "tp"), device=CPU)
    model = LongConvModel(**DRYRUN, dropout=0.0, conv_dtype=torch.float32, device=CPU)
    model.load_state_dict({n: _t(a) for n, a in case["state"].items()})
    shardings = param_shardings(mesh, model)
    shard_parameters(model, shardings)
    opt, _ = make_optimizer(model, lr=1e-3, special_lr=1e-3)
    seen = _grads_at_step(model, opt)
    step = make_train_step(model.train(), opt, clip=math.inf, loss_fn=cross_entropy, mesh=mesh)
    x = batch_sharding(mesh, 3).local(_t(case["x"]))
    y = batch_sharding(mesh, 1).local(_t(case["y"]))
    m = step(x, y)
    return {"loss": float(m["loss"]), "params": _gathered_params(model),
            "grads": _full_grads(model, seen, mesh),
            "local": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "specs": {n: s.spec for n, s in shardings.items()}}


def _run_hyena_tp(case, world, rank):
    """A 2-layer Hyena LM on (dp, tp) = (2, 2), or the case's mesh and
    mlp_l_chunks: parameters by param_shardings, ZeRO-1 moments and ZeRO-2
    grads over dp, the loss by vocab_parallel_cross_entropy over tp, AdamW
    (lr 1e-3, decay 0.1), clip 1."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.ops.fused import vocab_parallel_cross_entropy
    from flashfftconv_tpu_torch.parallel.comm import scatter_to
    from flashfftconv_tpu_torch.parallel.mesh import (
        batch_sharding,
        make_mesh,
        param_shardings,
        shard_parameters,
        zero1_shardings,
        zero2_shardings,
    )
    from flashfftconv_tpu_torch.utils.train import make_train_step

    mesh = make_mesh(case.get("mesh", (2, 2)), ("dp", "tp"), device=CPU)
    model = ConvLMHeadModel(**HYENA_LM, mixer_kwargs={"filter_order": 16,
                                                      "conv_dtype": torch.float32},
                            embed_dropout=0.0, dtype=torch.float32,
                            mlp_l_chunks=case.get("chunks", 0), device=CPU)
    model.load_state_dict({n: _t(a) for n, a in case["state"].items()})
    shardings = param_shardings(mesh, model)
    shard_parameters(model, shardings)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.1)
    seen = _grads_at_step(model, opt)
    tp = mesh.get_group("tp")

    def loss_fn(logits, y):
        return vocab_parallel_cross_entropy(scatter_to(logits, -1, tp), y, mesh, "tp")

    step = make_train_step(model, opt, clip=1.0, loss_fn=loss_fn,
                           opt_shardings=zero1_shardings(mesh, model),
                           grad_shardings=zero2_shardings(mesh, model))
    ids = batch_sharding(mesh, 2).local(_t(case["ids"]))
    m = step(ids[:, :-1].contiguous(), ids[:, 1:].contiguous())
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _gathered_params(model), "grads": _full_grads(model, seen, mesh),
            "local": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def _run_chunked_splits(case, world, rank):
    """shard_parameters on a Hyena LM with a ChunkedMlp on a 1 x 1 (dp, tp)
    mesh: the DEFAULT_TP_RULES pair takes the tp form; fc1's kernel split
    without its bias, or fc2 split column-wise, raises."""
    from flashfftconv_tpu_torch.models.lm import ChunkedMlp, ConvLMHeadModel
    from flashfftconv_tpu_torch.parallel.mesh import (
        DEFAULT_TP_RULES,
        make_mesh,
        param_shardings,
        shard_parameters,
    )

    mesh = make_mesh((1, 1), ("dp", "tp"), device=CPU)
    out = {}
    for name, rules in (
            ("default", DEFAULT_TP_RULES),
            ("fc1 bias whole", [r for r in DEFAULT_TP_RULES if "fc1/bias" not in r[0]]),
            ("fc2 column", [r for r in DEFAULT_TP_RULES if "fc2" not in r[0]]
             + [(r".*mlp/fc2/kernel$", (None, "tp"))])):
        model = ConvLMHeadModel(**HYENA_LM, mlp_l_chunks=HYENA_CHUNKS, device=CPU)
        try:
            shard_parameters(model, param_shardings(mesh, model, rules))
            out[name] = sum(isinstance(m, ChunkedMlp) and m.fc1.tp is not None
                            for m in model.modules())
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _run_moe(case, world, rank):
    """The JAX test's MoE LM step (TestExpertParallel) on a (dp, ep) mesh:
    experts by moe_param_shardings, the batch over dp, Adam(1e-3)."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.models.moe import moe_param_shardings
    from flashfftconv_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_parameters
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy
    from flashfftconv_tpu_torch.utils.train import make_train_step

    mesh = make_mesh(case["mesh"], ("dp", "ep"), device=CPU)
    model = ConvLMHeadModel(**MOE_LM, mixer_kwargs={"conv_dtype": torch.float32},
                            moe_kwargs={**MOE, "mesh": mesh}, dtype=torch.float32,
                            device=CPU).eval()
    model.load_state_dict({n: _t(a) for n, a in case["state"].items()})
    shardings = moe_param_shardings(mesh, model)
    shard_parameters(model, shardings)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    seen = _grads_at_step(model, opt)
    step = make_train_step(model, opt, clip=math.inf, mesh=mesh,
                           loss_fn=lambda lg, ids: cross_entropy(lg[:, :-1], ids[:, 1:]))
    ids = batch_sharding(mesh, 2).local(_t(case["ids"]))
    m = step(ids, ids)
    return {"loss": float(m["loss"]), "params": _gathered_params(model),
            "grads": _full_grads(model, seen, mesh),
            "local": {n: tuple(p.shape) for n, p in model.named_parameters()}}


_RUNNERS = {name[len("_run_"):]: fn for name, fn in globals().items()
            if name.startswith("_run_")}


def _rank_main(rank, world, store, cases_path, out_dir):
    """One rank: join the gloo group and run every case."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        res = {}
        for name, case in cases.items():
            torch.manual_seed(0)
            res[name] = _RUNNERS[case["kind"]](case, world, rank)
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


# --- the JAX side ---------------------------------------------------------------------

def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


# --- the tests --------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS[1:])
def test_h_sharded_conv_matches_single_device(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flashfftconv_tpu import fft_conv, make_plan

    cases, res = _ranks(world)
    case = cases["h_conv"]
    mesh = _jax_mesh((1, world), ("dp", "tp"))
    plan = make_plan(1024, compute_dtype=jnp.float32)
    u = jax.device_put(case["u"], NamedSharding(mesh, P(None, "tp", None)))
    k = jax.device_put(case["k"], NamedSharding(mesh, P("tp", None)))
    with mesh:
        want = jax.jit(lambda u, k: fft_conv(plan, u, k, impl="xla"))(u, k)
    got = np.concatenate([r["h_conv"]["y"] for r in res], axis=1)
    assert res[0]["h_conv"]["shape"] == (2, 16 // world, 1024)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_dp_batch_sharded_conv(world):
    import jax
    import jax.numpy as jnp

    from flashfftconv_tpu import fft_conv, make_plan
    from flashfftconv_tpu.parallel.mesh import batch_sharding

    cases, res = _ranks(world)
    case = cases["dp_conv"]
    mesh = _jax_mesh((world, 1), ("dp", "tp"))
    plan = make_plan(512, compute_dtype=jnp.float32)
    u = jax.device_put(case["u"], batch_sharding(mesh, 3))
    with mesh:
        want = jax.jit(lambda u, k: fft_conv(plan, u, k, impl="xla"))(u, case["k"])
    assert res[0]["dp_conv"]["shape"] == (4, 4, 512)
    _close(np.concatenate([r["dp_conv"]["y"] for r in res]), want, 1e-5)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_sequence_parallel_pointwise(world):
    import jax

    from flashfftconv_tpu.parallel.mesh import sequence_sharding

    cases, res = _ranks(world)
    case = cases["seq_gelu"]
    mesh = _jax_mesh((1, world), ("dp", "tp"))
    x = jax.device_put(case["x"], sequence_sharding(mesh, 3, seq_axis=1))
    with mesh:
        want = jax.jit(lambda x, w: jax.nn.gelu(x @ w))(x, case["w"])
    r = res[0]["seq_gelu"]
    assert r["shape"] == (2, 64 // world, 8)
    assert r["placements"] == ["Replicate()", "Shard(dim=1)"]
    _close(r["y"], want, 1e-5)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_zero1_sharded_optimizer_step(world):
    import jax
    import optax

    from flashfftconv_tpu.parallel.mesh import zero1_shardings

    cases, res = _ranks(world)
    w = cases["zero1"]["w"]
    mesh = _jax_mesh((world, 1), ("dp", "tp"))
    tx = optax.adam(1e-2)
    params, grads = {"w": w}, {"w": np.ones_like(w)}
    opt_state = jax.device_put(tx.init(params), zero1_shardings(mesh, tx.init(params)))
    with mesh:
        up, _ = jax.jit(tx.update)(grads, opt_state, params)
    for r in res:
        _close(r["zero1"]["w"], w + np.asarray(up["w"]), 1e-6)
        assert r["zero1"]["moments"] == {"exp_avg": (16 // world, 8),
                                         "exp_avg_sq": (16 // world, 8)}


@pytest.mark.parametrize("world", WORLDS[1:])
def test_zero2_grad_sharded_train_step(world):
    import jax
    import jax.numpy as jnp
    import optax

    from flashfftconv_tpu.utils.train import create_train_state, cross_entropy_loss, make_train_step

    cases, res = _ranks(world)
    case = cases["zero2"]
    tx = optax.adam(1e-2)
    step = make_train_step(lambda v, x, **kw: x @ v["params"]["w"], tx)
    y = case["y"].astype(np.int32)
    state, metrics = jax.jit(step)(create_train_state({"w": jnp.asarray(case["w"])}, tx),
                                   (case["x"], y), jax.random.PRNGKey(0))
    grad = jax.jit(jax.grad(lambda w: cross_entropy_loss(case["x"] @ w, y)))(case["w"])
    for r in res:
        z = r["zero2"]
        _close(z["w"], state.params["w"], 1e-6)
        _close(z["loss"], metrics["loss"], 1e-6)
        _check_grads(z["grads"], {"w": np.asarray(grad)}, "zero2")
        # the gradient was reduce-scattered over dp, in one flat bucket: the
        # whole 16 x 10 in, a shard of 16 / P rows out, and the moments hold
        # the shard's shape
        assert z["calls"] == [((160,), (160 // world,))]
        assert z["moments"] == {"exp_avg": (16 // world, 10), "exp_avg_sq": (16 // world, 10)}


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("labels", ["labels", "labels_ignored"])
def test_vocab_parallel_cross_entropy(world, smooth, labels):
    import jax

    from flashfftconv_tpu.ops.fused import cross_entropy_loss, vocab_parallel_cross_entropy

    cases, res = _ranks(world)
    case = cases["vocab_ce"]
    mesh = _jax_mesh((1, world), ("dp", "tp"))
    lb = case[labels].astype(np.int32)

    def loss(lg):
        with mesh:
            return vocab_parallel_cross_entropy(lg, lb, mesh, axis="tp", label_smoothing=smooth)

    value, grad = jax.jit(jax.value_and_grad(loss))(case["logits"])
    ref = cross_entropy_loss(case["logits"], lb, label_smoothing=smooth)
    _close(value, ref, 1e-6)
    for r in res:
        got_value, got_grad, shape = r["vocab_ce"][labels, smooth]
        assert shape == (2, 8, 128 // world)
        _close(got_value, value, 1e-5)
        _close(got_grad, grad, 1e-5)


def _check_grads(got, want, what=""):
    """Every gradient at 1e-5 of its parameter's largest |JAX gradient|."""
    assert set(got) == set(want), what
    for name, g in got.items():
        _close(g, want[name], 1e-5 * np.abs(want[name]).max(), f"{what} grad {name}")


def test_param_shardings_rules():
    """The JAX test's rules on a LongConv-style tree, and every parameter's
    spec equal to the JAX function's on the same model's flax tree (the
    dryrun's LongConvModel and a 2-layer Hyena LM), the Dense kernels
    transposed."""
    import jax
    from jax.sharding import PartitionSpec as P

    from flashfftconv_tpu.parallel.mesh import param_shardings
    from flashfftconv_tpu_torch.models.long_conv import LongConvModel
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.parallel import mesh as tmesh
    from flashfftconv_tpu_torch.utils.jax_weights import flax_paths

    jmesh = _jax_mesh((2, 2), ("dp", "tp"))
    jx = _jax_models()
    ports = {"dryrun": LongConvModel(**DRYRUN, device=CPU),
             "hyena_lm": ConvLMHeadModel(**HYENA_LM, mixer_kwargs={"filter_order": 16},
                                         device=CPU),
             "hyena_lm_scanned": ConvLMHeadModel(**HYENA_LM, mixer_kwargs={"filter_order": 16},
                                                 scan_blocks=True, device=CPU)}
    sharded = 0
    for key, model in ports.items():
        got = tmesh.param_shardings(None, model)
        paths = flax_paths(model)
        if key == "hyena_lm_scanned":  # JAX leaves the stacked leaves replicated
            assert all(s.spec == (None,) * len(s.spec) for s in got.values())
            continue
        flat = {"/".join(str(k.key) for k in p): s.spec for p, s in
                jax.tree_util.tree_flatten_with_path(
                    param_shardings(jmesh, jx[key][1]))[0]}
        for name, s in got.items():
            p = dict(model.named_parameters())[name]
            want = tuple(flat["/".join(paths[name])]) + (None,) * p.ndim
            want = want[: p.ndim]
            if paths[name][-1] == "kernel" and p.ndim == 2:
                want = want[::-1]
            assert s.spec == want, (key, name, s.spec, want)
            sharded += any(s.spec)
    assert sharded == 6 + 8  # LongConvModel: 3 a layer; Hyena LM: out_proj, fc1 (2), fc2
    assert P(None, "tp", None) == P(*tmesh.Sharding(None, (None, "tp", None)).spec)
