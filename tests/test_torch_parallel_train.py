"""Meshes, pipelines and the parallel train steps of the port on gloo ranks,
against the JAX package's. Helpers and tolerances are those of
``test_torch_parallel.py``, whose docstring states them.
"""

import numpy as np
import pytest
import torch
from test_torch_parallel import WORLDS, _check_grads, _close, _jax_mesh, _jax_models, _ranks, _state

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def _jax_tanh_pipe(case):
    import jax
    import jax.numpy as jnp

    from flashfftconv_tpu.parallel.pipeline import pipeline_apply

    names = case["names"]
    mesh = _jax_mesh(case["mesh"], names)
    stacked = {"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])}
    fn = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
    batch = "dp" if "dp" in names else None

    def loss(sp, x):
        y = pipeline_apply(fn, sp, x, mesh, num_microbatches=case["m"], batch_axis=batch)
        return jnp.sum(y ** 2), y

    (_, y), (g, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        stacked, case["x"])
    ref = case["x"]
    for i in range(case["w"].shape[0]):
        ref = np.tanh(ref @ case["w"][i] + case["b"][i])
    _close(y, ref, 1e-6)
    return y, g, dx


def _check_step(got, want, grads, lr):
    """Parameters after one Adam step at 1e-5, except where the JAX gradient
    is below 1e-6: there Adam's first step, lr g / (|g| + 1e-8), turns on the
    gradient's rounding (an element of the dryrun's output_linear, |g| 3.5e-9,
    moves 6.7e-5 apart between the unsharded port and JAX), and the element
    is held to the 2 lr that bounds any step. The step reads little more than
    the gradient's sign; _check_grads holds its magnitude."""
    assert set(got) == set(want)
    for name, a in got.items():
        tol = np.where(np.abs(grads[name]) < 1e-6, 2 * lr, 1e-5)
        err = np.abs(a - want[name])
        assert (err <= tol).all(), (name, float(err.max()), int((err > tol).sum()))


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_shapes(world):
    _, res = _ranks(world)
    for r in res:
        assert r["mesh"]["default"] == {"dp": world, "tp": 1}
        if world >= 2:
            assert r["mesh"]["explicit"] == {"dp": world // 2, "tp": 2}
        assert "do not cover" in r["mesh"]["error"]


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_forward_and_grad_parity(world):
    cases, res = _ranks(world)
    y, g, dx = _jax_tanh_pipe(cases["tanh_pipe"])
    for r in res:
        _close(r["tanh_pipe"]["y"], y, 1e-6)
        _close(r["tanh_pipe"]["dx"], dx, 1e-5)
        assert r["tanh_pipe"]["shapes"] == {"w": (1, 16, 16), "b": (1, 16)}
    for name in ("w", "b"):
        got = np.concatenate([r["tanh_pipe"]["grads"][name] for r in res])
        _close(got, g[name], 1e-5, name)


def test_dp_pp_composition():
    """(dp, pp) = (2, 2): each dp group pipelines its own half of the batch."""
    cases, res = _ranks(4)
    y, g, dx = _jax_tanh_pipe(cases["dp_pp"])
    # rank = 2 * dp + pp: ranks 0 and 2 hold the two halves
    _close(np.concatenate([res[0]["dp_pp"]["y"], res[2]["dp_pp"]["y"]]), y, 1e-6)
    _close(np.concatenate([res[0]["dp_pp"]["dx"], res[2]["dp_pp"]["dx"]]), dx, 1e-5)
    for name in ("w", "b"):  # each stage's grad summed over the dp groups
        got = np.concatenate([res[0]["dp_pp"]["grads"][name] + res[2]["dp_pp"]["grads"][name],
                              res[1]["dp_pp"]["grads"][name] + res[3]["dp_pp"]["grads"][name]])
        _close(got, g[name], 1e-5, name)


def test_lm_blocks_pipelined():
    """Four Hyena Blocks (the FFT conv inside) as the stages of a pp = 4
    pipeline, against the JAX pipeline on the same weights: the output at
    1e-4 (the JAX test's tolerance) and the stages' grads of sum(y**2) at
    1e-4 of each grad's largest |value|."""
    import jax
    import jax.numpy as jnp

    from flashfftconv_tpu.parallel.pipeline import pipeline_apply, stack_stage_params
    from flashfftconv_tpu_torch.utils import jax_weights

    cases, res = _ranks(4)
    block, trees = _jax_models()["block"]
    mesh = _jax_mesh((4,), ("pp",))
    fn = lambda p, h: block.apply({"params": p}, h, deterministic=True)

    def loss(sp, x):
        y = pipeline_apply(fn, sp, x, mesh)
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        stack_stage_params(trees), cases["block_pipe"]["x"])
    for r in res:
        _close(r["block_pipe"]["y"], y, 1e-4)
    g = jax.tree_util.tree_map(np.asarray, g)
    for i, r in enumerate(res):
        want = {n: t.numpy() for n, t in jax_weights._block_state_dict(
            jax.tree_util.tree_map(lambda a: a[i], g), "").items()}
        for name, got in r["block_pipe"]["grads"].items():
            _close(got[0], want[name], 1e-4 * np.abs(want[name]).max() + 1e-7, name)


def test_dryrun_dp_tp_train_step():
    """dryrun_multichip's recipe (LongConvModel, param_shardings, batch over
    dp, make_optimizer, make_train_step) on a (2, 2) mesh: the port's loss
    and updated parameters against the JAX step's, each rank holding the
    shard shapes of the specs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flashfftconv_tpu.parallel.mesh import batch_sharding, param_shardings
    from flashfftconv_tpu.utils.optim import make_optimizer
    from flashfftconv_tpu.utils.train import (
        create_train_state,
        cross_entropy_loss,
        make_train_step,
    )

    cases, res = _ranks(4)
    case = cases["dryrun"]
    model, params = _jax_models()["dryrun"]
    mesh = _jax_mesh((2, 2), ("dp", "tp"))
    tx = make_optimizer(params, lr=1e-3, special_lr=1e-3)
    state = create_train_state(params, tx)
    p_sh = param_shardings(mesh, params)
    state = jax.device_put(state, type(state)(
        step=NamedSharding(mesh, P()), params=p_sh,
        opt_state=jax.tree.map(lambda _: NamedSharding(mesh, P()), state.opt_state)))
    x = jax.device_put(case["x"], batch_sharding(mesh, 3))
    y = jax.device_put(case["y"].astype(np.int32), batch_sharding(mesh, 1))
    with mesh:
        new, metrics = jax.jit(make_train_step(model.apply, tx))(state, (x, y),
                                                                  jax.random.PRNGKey(1))
        grads = jax.jit(jax.grad(lambda p: cross_entropy_loss(model.apply({"params": p}, x),
                                                              y)))(params)
    want = _state("dryrun", jax.tree_util.tree_map(np.asarray, new.params))
    grads = _state("dryrun", jax.tree_util.tree_map(np.asarray, grads))
    assert all(np.abs(grads[f"layer.{i}.kernel"]).max() > 0 for i in range(2))
    for r in res:
        d = r["dryrun"]
        _close(d["loss"], metrics["loss"], 1e-5)
        _check_step(d["params"], want, grads, 1e-3)
        _check_grads(d["grads"], grads, "dryrun")
        for name, spec in d["specs"].items():
            shape = list(want[name].shape)
            for dim, axis in enumerate(spec):
                if axis is not None:
                    shape[dim] //= 2
            assert d["local"][name] == tuple(shape), name
    assert sum(any(s) for s in res[0]["dryrun"]["specs"].values()) == 6


def test_hyena_lm_tp_zero_step_matches_jax():
    """The parallel_train recipe at CPU size: a 2-layer Hyena LM on (dp, tp)
    = (2, 2), out_proj row-parallel and the MLP a column/row pair, ZeRO-1/2
    over dp, vocab-parallel loss over tp, AdamW with a clip at 1, against
    the JAX package's unsharded step (optax clip + adamw) on the same
    weights and batch."""
    import jax
    import optax

    from flashfftconv_tpu.ops.fused import cross_entropy_loss

    cases, res = _ranks(4)
    ids = cases["hyena_tp"]["ids"].astype(np.int32)
    model, params = _jax_models()["hyena_lm"]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, weight_decay=0.1))

    def step(p, o):
        loss, g = jax.value_and_grad(
            lambda p: cross_entropy_loss(model.apply({"params": p}, ids[:, :-1]), ids[:, 1:]))(p)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), loss, g

    new, loss, g = jax.jit(step)(params, tx.init(params))
    want = _state("hyena_lm", jax.tree_util.tree_map(np.asarray, new))
    grads = _state("hyena_lm", jax.tree_util.tree_map(np.asarray, g))
    norm = float(optax.global_norm(g))
    assert norm > 1.0  # the clip scales every gradient
    for r in res:
        h = r["hyena_tp"]
        _close(h["loss"], loss, 1e-5)
        _close(h["grad_norm"], norm, 1e-5)
        _check_step(h["params"], want, grads, 1e-3)
        # the optimizer steps the grads clipped to norm 1: g min(1, 1 / (norm + 1e-6))
        _check_grads(h["grads"], {n: v * min(1.0, 1.0 / (norm + 1e-6))
                                  for n, v in grads.items()}, "hyena_tp")
        # fc1 split on out over tp, then its moments over dp: 32 -> 16 -> 8 rows
        assert h["local"]["backbone.blocks.0.mlp.fc1.weight"] == (16, 16)
        assert h["local"]["backbone.blocks.0.mlp.fc2.weight"] == (16, 16)
        assert h["local"]["backbone.blocks.0.mixer.out_proj.weight"] == (16, 8)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_chunked_mlp_tp_zero_step_matches_jax(world):
    """The recipe of test_hyena_lm_tp_zero_step_matches_jax with the MLP a
    ChunkedMlp (mlp_l_chunks=4) on (dp, tp) = (world / 2, 2): fc1 column-
    and fc2 row-parallel inside the L-chunked Function, against the JAX
    package's jitted step with its parameters placed by param_shardings and
    the batch over dp on a mesh of the same shape (GSPMD partitions it), at
    the same tolerances."""
    import jax
    import optax

    from flashfftconv_tpu.ops.fused import cross_entropy_loss
    from flashfftconv_tpu.parallel.mesh import batch_sharding, param_shardings

    cases, res = _ranks(world)
    case = cases["hyena_chunked"]
    lm, params = _jax_models()["hyena_lm"]
    model = lm.clone(mlp_l_chunks=case["chunks"])
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, weight_decay=0.1))

    def step(p, o, ids):
        loss, g = jax.value_and_grad(
            lambda p: cross_entropy_loss(model.apply({"params": p}, ids[:, :-1]), ids[:, 1:]))(p)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), loss, g

    mesh = _jax_mesh(case["mesh"], ("dp", "tp"))
    p = jax.device_put(params, param_shardings(mesh, params))
    ids = jax.device_put(case["ids"].astype(np.int32), batch_sharding(mesh, 2))
    with mesh:
        new, loss, g = jax.jit(step)(p, tx.init(p), ids)
    want = _state("hyena_lm", jax.tree_util.tree_map(np.asarray, new))
    grads = _state("hyena_lm", jax.tree_util.tree_map(np.asarray, g))
    norm = float(optax.global_norm(g))
    assert norm > 1.0  # the clip scales every gradient
    for r in res:
        h = r["hyena_chunked"]
        _close(h["loss"], loss, 1e-5)
        _close(h["grad_norm"], norm, 1e-5)
        _check_step(h["params"], want, grads, 1e-3)
        _check_grads(h["grads"], {n: v * min(1.0, 1.0 / (norm + 1e-6))
                                  for n, v in grads.items()}, "hyena_chunked")
        # fc1 split on out and fc2 on in over tp: 32 -> 16
        assert h["local"]["backbone.blocks.0.mlp.fc1.weight"] == (16, 16)
        assert h["local"]["backbone.blocks.0.mlp.fc1.bias"] == (16,)
        assert h["local"]["backbone.blocks.0.mlp.fc2.weight"] == (16, 16)
        assert h["local"]["backbone.blocks.0.mlp.fc2.bias"] == (16,)


def test_chunked_mlp_takes_only_the_megatron_pair():
    """ChunkedMlp under shard_parameters: DEFAULT_TP_RULES' pair gives both
    layers the tp form (on a 1 x 1 mesh too); fc1's kernel split without
    its bias, or fc2 split on its output, raises NotImplementedError."""
    _, res = _ranks(1)
    got = res[0]["chunked_splits"]
    assert got["default"] == 2
    assert "ChunkedMlp splits fc1" in got["fc1 bias whole"]
    assert "ChunkedMlp splits fc1" in got["fc2 column"]


def test_moe_lm_train_step_dp_ep():
    """The MoE LM step of TestExpertParallel on (dp, ep) = (1, 4) and (2, 2):
    one expert or two on each rank, the routing and capacity over the whole
    batch, against the JAX step on one device. (The JAX step on a (2, 2)
    mesh with moe_param_shardings gives twice the one-device gradient of
    each Hyena short filter's weights, which its Adam step hides.)"""
    import jax
    import jax.numpy as jnp
    import optax

    cases, res = _ranks(4)
    model, params = _jax_models()["moe_lm"]
    ids = cases["moe_1x4"]["ids"].astype(np.int32)
    tx = optax.adam(1e-3)

    def loss_fn(p, ids):
        logits = model.apply({"params": p}, ids)
        tgt = jnp.roll(ids, -1, axis=-1)
        return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1],
                                                               tgt[:, :-1]).mean()

    @jax.jit
    def step(p, o, ids):
        loss, g = jax.value_and_grad(loss_fn)(p, ids)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), loss, g

    new, loss, g = step(params, tx.init(params), ids)
    want = _state("moe", jax.tree_util.tree_map(np.asarray, new))
    grads = _state("moe", jax.tree_util.tree_map(np.asarray, g))
    for name, experts in (("moe_1x4", 1), ("moe_2x2", 2)):
        for r in res:
            m = r[name]
            _close(m["loss"], loss, 1e-5, name)
            _check_step(m["params"], want, grads, 1e-3)
            _check_grads(m["grads"], grads, name)
            assert m["local"]["backbone.blocks.0.mlp.w1"] == (experts, 16, 32)
