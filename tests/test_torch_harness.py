"""The port's training harness against the JAX package's, on the CPU.

``utils/train.py`` (``evaluate``, checkpoints, ``auto_save_on_exception``,
``latest_checkpoint``, ``ProgressiveResizing``), ``utils/data.py`` (the
samplers, the ICL generators, ``ArrayDataset``, ``grayscale_sequence``),
``utils/tasks.py``, ``utils/registry.py`` with the optax-named schedules and
optimizers of ``utils/optim.py``, ``utils/logging.py``, ``utils/debugging.py``
and ``utils/native_loader.py``, each on the same inputs as the JAX module.

Tolerances: the numpy-only utilities (samplers, generators, datasets, the
curriculum, the native loader's stream) are equal bit for bit; task losses
and metrics within 1e-6 (f32 reductions in two orders); schedules within
1e-7 at learning-rate scale (optax computes in f32, the port in Python
floats); optimizer updates within 1e-6 after 5 steps (f32 arithmetic in
another order); the evaluate counts exactly. Checkpoint round trips are bit
for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flashfftconv_tpu.models import long_conv as jlc
from flashfftconv_tpu.models.lm import LMBackbone as JBackbone
from flashfftconv_tpu.utils import data as jdata
from flashfftconv_tpu.utils import debugging as jdebug
from flashfftconv_tpu.utils import logging as jlogging
from flashfftconv_tpu.utils import native_loader as jnative
from flashfftconv_tpu.utils import registry as jregistry
from flashfftconv_tpu.utils import tasks as jtasks
from flashfftconv_tpu.utils import train as jtrain
from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel, LMBackbone
from flashfftconv_tpu_torch.utils import data, debugging, jax_weights, native_loader, optim
from flashfftconv_tpu_torch.utils import logging as tlogging
from flashfftconv_tpu_torch.utils import registry, tasks, train

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"


# --- samplers, generators, datasets -------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False])
def test_fault_tolerant_sampler_matches_jax_across_a_mid_epoch_restore(shuffle):
    def run(mod):
        s = mod.FaultTolerantSampler(num_samples=23, seed=5, shuffle=shuffle)
        it = iter(s)
        head = [next(it) for _ in range(9)]
        state = s.state_dict()
        resumed = mod.FaultTolerantSampler(num_samples=23, seed=0, shuffle=shuffle)
        resumed.load_state_dict(state)
        rest = list(resumed) + list(resumed)  # the rest of epoch 0, then epoch 1
        batches = [b.tolist() for b in resumed.batches(4, drop_last=False)]
        return head, state, rest, batches, resumed.state_dict()

    assert run(data) == run(jdata)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3), (2, 3)])
def test_sharded_sampler_matches_jax(rank, world):
    def run(mod):
        s = mod.ShardedSampler(num_samples=20, seed=2, rank=rank, world_size=world)
        it = iter(s)
        head = [next(it) for _ in range(3)]
        resumed = mod.ShardedSampler(num_samples=20, seed=2, rank=rank, world_size=world)
        resumed.load_state_dict(s.state_dict())
        return head, list(resumed), list(resumed), resumed.state_dict()

    assert run(data) == run(jdata)


@pytest.mark.parametrize("task,kwargs", [
    ("induction_head", {}),
    ("induction_head", {"induction_len": 3, "num_triggers": 4}),
    ("assoc_recall", {}),
    ("assoc_recall", {"num_keys": 2}),
])
def test_icl_batches_match_jax(task, kwargs):
    ours = data.icl_batches(task, 4, 40, 21, seed=3, **kwargs)
    ref = jdata.icl_batches(task, 4, 40, 21, seed=3, **kwargs)
    for _ in range(3):
        (x, y), (jx, jy) = next(ours), next(ref)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_array_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "ds.npz"
    np.savez(path, x=rng.integers(0, 9, (13, 6)), y=rng.integers(0, 2, 13))

    def run(mod):
        ds = mod.ArrayDataset.from_npz(str(path))
        it = ds.batches(4)
        first = next(it)
        state = ds.state_dict()
        again = mod.ArrayDataset.from_npz(str(path))
        again.load_state_dict(state)
        return [first] + list(again.batches(4, drop_last=False))

    for (x, y), (jx, jy) in zip(run(data), run(jdata), strict=True):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError):
        data.ArrayDataset(np.zeros((3, 2)), np.zeros(2))


@pytest.mark.parametrize("shape", [(3, 4, 5, 3), (3, 4, 5)])
def test_grayscale_sequence_matches_jax(shape):
    images = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    got = data.grayscale_sequence(images)
    assert got.dtype == np.float32 and got.shape == (3, 20)
    np.testing.assert_array_equal(got, jdata.grayscale_sequence(images))


def test_progressive_resizing_matches_jax_over_120_epochs():
    stages = [{"resolution": 4, "epochs": 50, "bandlimit": 0.5},
              {"resolution": 2, "epochs": 30, "lr_scale": 0.5},
              {"resolution": 1, "epochs": 20}]
    ours, ref = train.ProgressiveResizing(stages), jtrain.ProgressiveResizing(stages)
    assert ours.total_epochs == ref.total_epochs == 100
    x = np.arange(2 * 64).reshape(2, 64)
    for epoch in range(121):
        assert ours.stage_of(epoch) == ref.stage_of(epoch)
        assert ours.boundary(epoch) == ref.boundary(epoch)
        assert ours.params_at(epoch) == ref.params_at(epoch)
        assert ours.lr_scale(epoch) == ref.lr_scale(epoch)
        assert ours.bandlimit(epoch) == ref.bandlimit(epoch)
        got = ours.downsample(torch.from_numpy(x), epoch)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.downsample(x, epoch)))
    with pytest.raises(ValueError):
        train.ProgressiveResizing([])
    with pytest.raises(ValueError):
        train.ProgressiveResizing([{"epochs": 3}])


# --- tasks, registry, schedules, optimizers ----------------------------------------


def _task_inputs(name, rng):
    if name in ("lm", "lm-shift"):
        return rng.standard_normal((2, 8, 11)).astype(np.float32), rng.integers(0, 11, (2, 8))
    if name == "classification":
        return rng.standard_normal((6, 5)).astype(np.float32), rng.integers(0, 5, 6)
    if name == "multilabel":
        return (rng.standard_normal((4, 6)).astype(np.float32) * 3,
                rng.integers(0, 2, (4, 6)).astype(np.float32))
    return (rng.standard_normal((4, 3, 2)).astype(np.float32),
            rng.standard_normal((4, 3, 2)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(jtasks.TASKS))
def test_task_loss_and_metrics_match_jax(name):
    assert sorted(tasks.TASKS) == sorted(jtasks.TASKS)
    pred, target = _task_inputs(name, np.random.default_rng(len(name)))
    ours, ref = tasks.get_task(name), jtasks.get_task(name)
    assert ours.decoder_mode == ref.decoder_mode
    assert sorted(ours.metrics) == sorted(ref.metrics)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    np.testing.assert_allclose(float(ours.loss(tp, tt)), float(ref.loss(jp, jt)), atol=1e-6)
    for key in ours.metrics:
        np.testing.assert_allclose(float(ours.metrics[key](tp, tt)),
                                   float(ref.metrics[key](jp, jt)), rtol=1e-6, atol=1e-6)
    with pytest.raises(KeyError):
        tasks.get_task("nope")


@pytest.mark.parametrize("kind", sorted(jregistry._REGISTRIES))
def test_registry_has_the_jax_names_and_every_target_resolves(kind):
    assert set(registry._REGISTRIES[kind]) == set(jregistry._REGISTRIES[kind])
    for name in registry._REGISTRIES[kind]:
        assert callable(registry.lookup(kind, name))


def test_registry_instantiate_matches_jax():
    """As the JAX package's test_registry_lookup_and_instantiate."""
    from flashfftconv_tpu_torch.models.hyena import HyenaOperator

    assert registry.lookup("layer", "hyena") is HyenaOperator
    layer = registry.instantiate("layer", {"_name_": "hyena", "d_model": 8, "l_max": 16},
                                 device=CPU)
    ref = jregistry.instantiate("layer", {"_name_": "hyena", "d_model": 8, "l_max": 16})
    assert layer.d_model == ref.d_model == 8 and layer.l_max == ref.l_max == 16
    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(0))
    assert layer(x).shape == (2, 16, 8)
    with pytest.raises(KeyError):
        registry.lookup("layer", "nope")
    registry.register("layer", "custom", lambda **kw: kw)
    assert registry.instantiate("layer", "custom") == {}
    model = registry.instantiate(
        "model", {"_name_": "lm", "d_model": 16, "n_layer": 1, "d_inner": 64,
                  "vocab_size": 50, "mixer": "hyena"},
        l_max=32, dtype=torch.float32, device=CPU, generator=torch.Generator().manual_seed(0))
    assert isinstance(model, ConvLMHeadModel) and model.vocab_size == 56


SCHEDULES = [
    ("constant", dict(value=3e-3)),
    ("linear", dict(init_value=1e-3, end_value=1e-5, transition_steps=120)),
    ("linear", dict(init_value=1e-3, end_value=1e-5, transition_steps=50, transition_begin=30)),
    ("linear", dict(init_value=1e-3, end_value=1e-5, transition_steps=0)),
    ("cosine", dict(init_value=1e-2, decay_steps=150, alpha=0.1)),
    ("cosine", dict(init_value=1e-2, decay_steps=90, exponent=2.0)),
    ("warmup-cosine", dict(init_value=0.0, peak_value=1e-2, warmup_steps=20,
                           decay_steps=160, end_value=1e-4)),
    ("exponential", dict(init_value=1e-2, transition_steps=25, decay_rate=0.5)),
    ("exponential", dict(init_value=1e-2, transition_steps=25, decay_rate=0.5,
                         transition_begin=40, staircase=True, end_value=2e-3)),
    ("exponential", dict(init_value=1e-3, transition_steps=30, decay_rate=1.5,
                         end_value=4e-3)),
    ("warmup-exponential", dict(init_value=1e-4, peak_value=1e-2, warmup_steps=30,
                                transition_steps=20, decay_rate=0.7, transition_begin=10,
                                staircase=True, end_value=1e-3)),
    ("sgdr", dict(cosine_kwargs=[
        dict(init_value=0.0, peak_value=1e-2, warmup_steps=10, decay_steps=60),
        dict(init_value=1e-3, peak_value=5e-3, warmup_steps=5, decay_steps=80, end_value=1e-4),
        dict(init_value=0.0, peak_value=2e-3, warmup_steps=0, decay_steps=100)])),
    ("piecewise", dict(init_value=1e-2, boundaries_and_scales={40: 0.5, 90: 0.1, 150: 2.0})),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULES)
def test_schedule_matches_optax_over_200_steps(name, kwargs):
    ours = registry.instantiate("scheduler", {"_name_": name, **kwargs})
    ref = jregistry.instantiate("scheduler", {"_name_": name, **kwargs})
    got = np.array([ours(step) for step in range(201)])
    want = np.array([float(ref(step)) for step in range(201)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


OPTIMIZERS = [
    ("adamw", dict(learning_rate=1e-2)),
    ("adamw", dict(learning_rate=3e-3, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1)),
    ("adam", dict(learning_rate=1e-2)),
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, nesterov=True)),
    ("lamb", dict(learning_rate=1e-2)),
    ("lamb", dict(learning_rate=1e-2, weight_decay=0.01, eps_root=1e-8)),
    ("adamw", dict(learning_rate={"_name_": "warmup-cosine", "init_value": 0.0,
                                  "peak_value": 1e-2, "warmup_steps": 2, "decay_steps": 5},
                   weight_decay=0.05)),
    ("lamb", dict(learning_rate={"_name_": "linear", "init_value": 1e-2, "end_value": 1e-3,
                                 "transition_steps": 4})),
    # optax's options that torch's optimizers lack; a mask is optax's tree of
    # booleans for JAX and the same flags in the parameters' order for the port
    ("adamw", dict(learning_rate=1e-2, eps_root=1e-3, weight_decay=0.1)),
    ("adamw", dict(learning_rate=1e-2, mu_dtype="bfloat16", weight_decay=0.1)),
    ("adamw", dict(learning_rate=1e-2, weight_decay=0.1,
                   mask={"w": True, "b": False, "z": True})),
    ("adam", dict(learning_rate=1e-2, nesterov=True)),
    ("lamb", dict(learning_rate=1e-2, weight_decay=0.05, mask={"w": False, "b": True, "z": True})),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, accumulator_dtype="bfloat16")),
]


@pytest.mark.parametrize("name,cfg", OPTIMIZERS)
def test_optimizer_matches_optax_over_5_updates(name, cfg):
    """Each registered optimizer against optax at 1e-6 after 5 updates. A
    bf16 moment (mu_dtype, accumulator_dtype) is rounded the same way in
    both (round to nearest even, the decay rounded to bf16 as JAX's weak
    scalar is), so it holds at 1e-6 too."""
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((5, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32),
              "z": np.zeros(3, np.float32)}  # a zero norm: lamb's trust ratio is 1
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    lr = cfg["learning_rate"]
    jlr = tlr = lr
    if isinstance(lr, dict):
        jlr = jregistry.instantiate("scheduler", lr)
        tlr = registry.instantiate("scheduler", lr)
    tx = jregistry.instantiate("optimizer", {"_name_": name, **cfg, "learning_rate": jlr})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tcfg = dict(cfg)
    if "mask" in cfg:
        tcfg["mask"] = [cfg["mask"][k] for k in tp]
    opt, sched = registry.instantiate("optimizer", {"_name_": name, **tcfg, "learning_rate": tlr},
                                      params=list(tp.values()))
    assert (sched is None) == (not isinstance(lr, dict))
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        if sched is not None:
            sched.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_optimizer_defaults_are_optax_not_torch():
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt, _ = optim.adamw(p, 1e-3)
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["eps"] == 1e-8
    assert optim.lamb(p, 1e-3)[0].defaults["eps"] == 1e-6
    # optax's Nesterov Adam, a dtype by name and a mask as a callable on the
    # parameters' list, where torch has none of them
    opt, _ = optim.adam(p, 1e-3, nesterov=True, mu_dtype="bfloat16")
    assert opt.defaults["nesterov"] and opt.defaults["mu_dtype"] is torch.bfloat16
    q = [torch.nn.Parameter(torch.ones(2, 2)), torch.nn.Parameter(torch.ones(2))]
    opt, _ = optim.adamw(q, 1e-3, weight_decay=0.5, mask=lambda ps: [t.ndim > 1 for t in ps])
    assert [(g["params"][0] is t, g["weight_decay"]) for g, t in zip(opt.param_groups, q)] == [
        (True, 0.5), (True, 0.0)]
    with pytest.raises(ValueError):
        optim.adamw(q, 1e-3, mask=[True])


# --- logging, debugging -------------------------------------------------------------


@pytest.mark.parametrize("as_file", [True, False])
def test_metric_logger_records_match_jax(tmp_path, as_file):
    def run(mod, sub):
        logdir = str(tmp_path / sub / ("run.jsonl" if as_file else "logs"))
        logger = mod.MetricLogger(logdir, run_name=None if as_file else "r1",
                                  use_wandb=False, config={"lr": 0.1, "name": "x"})
        logger.log({"loss": np.float32(1.5), "acc": 0.25}, step=3)
        logger.log({"val": 2})
        logger.finish()
        with open(logger.path) as f:
            recs = [json.loads(line) for line in f]
        assert all(isinstance(r.pop("time"), float) for r in recs)
        return os.path.relpath(logger.path, tmp_path / sub), recs

    assert run(tlogging, "port") == run(jlogging, "jax")


def test_metric_logger_takes_tensors(tmp_path):
    logger = tlogging.MetricLogger(str(tmp_path / "t.jsonl"))
    logger.log({"loss": torch.tensor(0.5)}, step=0)
    with open(logger.path) as f:
        assert json.loads(f.read())["loss"] == 0.5


def test_debug_nans_and_checked_raise_on_log_of_minus_one():
    x = torch.tensor([-1.0, 2.0])
    with pytest.raises(FloatingPointError, match="log"):
        with debugging.debug_nans():
            torch.log(x)
    with pytest.raises(FloatingPointError, match="log"):
        debugging.checked(torch.log)(x)
    with debugging.debug_nans(enabled=False):
        assert torch.isnan(torch.log(x)).any()
    finite = torch.tensor([1.0, 2.0])
    with debugging.debug_nans():
        torch.log(finite)
        assert torch.isinf(1.0 / torch.zeros(1)).all()  # an inf is no NaN
    assert torch.equal(debugging.checked(torch.log)(finite), torch.log(finite))
    with pytest.raises(FloatingPointError, match="division"):
        debugging.checked(lambda t: 1.0 / t)(torch.zeros(2))


def test_debug_nans_catches_a_nan_made_in_the_backward():
    x = torch.tensor([0.0], requires_grad=True)
    y = torch.sqrt(x) * 0.0  # forward finite; the backward's 0 / (2 sqrt 0) is NaN
    with pytest.raises(FloatingPointError, match="aten.div"):
        with debugging.debug_nans():
            y.backward()


def test_assert_finite_names_the_path():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 1))
    debugging.assert_finite(model, "model")
    with torch.no_grad():
        model[1].bias.fill_(float("inf"))
    with pytest.raises(FloatingPointError, match="model:1.bias"):
        debugging.assert_finite(model, "model")
    with pytest.raises(FloatingPointError, match="grads:a/1"):
        debugging.assert_finite({"a": [torch.ones(1), torch.tensor([float("nan")])]}, "grads")


def _jax_backbone_pair():
    kw = dict(d_model=16, n_layer=2, d_inner=64, vocab_size=8, l_max=64,
              mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32})
    jb = JBackbone(**kw, dtype=jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 64, 16)).astype(np.float32)
    identity = lambda t: t  # noqa: E731 (the embedding: x is embedded already)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), embed=identity)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = jax_weights.from_jax_params({"embeddings": {"embedding": np.zeros((8, 16))},
                                      "backbone": tree})
    tb = LMBackbone(**{**kw, "mixer_kwargs": {"conv_dtype": torch.float32}},
                    dtype=torch.float32, device=CPU).eval()
    tb.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                        if k.startswith("backbone.")}, strict=True)
    return jax.jit(lambda t: jb.apply({"params": params}, t, embed=identity)), tb, x


@pytest.mark.parametrize("fn,jfn", [(lambda t: t.cumsum(1), lambda t: jnp.cumsum(t, 1)),
                                     (lambda t: t.flip(1), lambda t: jnp.flip(t, 1))],
                         ids=["cumsum", "flip"])
def test_causality_leakage_matches_jax(fn, jfn):
    x = np.random.default_rng(0).standard_normal((2, 32, 3)).astype(np.float32)
    got = debugging.causality_leakage(fn, torch.from_numpy(x))
    ref = jdebug.causality_leakage(jfn, jnp.asarray(x))
    assert sorted(got) == sorted(ref) == [8, 16, 24]
    for t in got:
        np.testing.assert_allclose(got[t], ref[t], rtol=1e-6)


def test_causality_leakage_of_a_hyena_backbone_matches_jax():
    jf, tb, xb = _jax_backbone_pair()
    got = debugging.causality_leakage(tb, torch.from_numpy(xb))
    ref = jdebug.causality_leakage(jf, jnp.asarray(xb))
    assert sorted(got) == sorted(ref)
    for t in got:  # causal up to rounding in both
        assert got[t] < 1e-5 and ref[t] < 1e-5
        np.testing.assert_allclose(got[t], ref[t], atol=1e-5)


# --- evaluate, checkpoints, auto-save -----------------------------------------------


@pytest.mark.parametrize("n_val,batch", [(37, 8), (16, 8), (5, 8)])
def test_evaluate_matches_jax_on_a_ragged_split(n_val, batch):
    """The ListOps LongConvModel (2 layers, d_model 32, L=128, f32) with the
    flax weights: the same (correct, total) as the JAX evaluate, whose last
    batch is padded and masked the same way."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "listops_torch_eval", os.path.join(os.path.dirname(__file__), "..", "examples", "lra",
                                           "train_listops_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    kw = dict(d_model=32, n_layers=2, l_max=128, kernel_lam=0.001)
    jm = jlc.LongConvModel(d_input=16, d_output=10, **kw, conv_dtype=jnp.float32, impl="xla")
    rng = np.random.default_rng(n_val)
    ids = rng.integers(1, 16, (n_val, 128)).astype(np.int32)
    ids[:, 100:] = 0
    labels = rng.integers(0, 10, n_val).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 128, 16)))["params"]
    def apply(p, xx, **k):
        return jm.apply(p, jax.nn.one_hot(xx, 16), mask=(xx != 0), **k)

    ref = jtrain.evaluate(jax.jit(jtrain.make_eval_step(apply)), params, (ids, labels), batch)
    tm = cli.ListOpsModel(**kw, conv_dtype=torch.float32, device=CPU)
    tm.model.load_state_dict(
        jax_weights.long_conv_model_state_dict(jax.tree_util.tree_map(np.asarray, params)),
        strict=True)
    got = train.evaluate(train.make_eval_step(tm), (ids, labels), batch, CPU)
    assert got == ref and got[1] == n_val
    assert all(isinstance(v, float) for v in got)
    with pytest.raises(ValueError):
        train.evaluate(train.make_eval_step(tm), (ids[:0], labels[:0]), batch, CPU)


def _small_lm(seed=0):
    return ConvLMHeadModel(d_model=16, n_layer=2, d_inner=64, vocab_size=32, l_max=32,
                           dtype=torch.float32, device=CPU,
                           generator=torch.Generator().manual_seed(seed)).train()


def _batches(n):
    rng = np.random.default_rng(3)
    return [tuple(torch.from_numpy(a) for a in (rng.integers(0, 32, (2, 32)),) * 2)
            for _ in range(n)]


def _run(state, step_fn, batches):
    losses = []
    for i, (x, y) in enumerate(batches):
        torch.manual_seed(100 + state.step)  # dropout masks from the step
        losses.append(float(step_fn(x, y)["loss"]))
        state.step += 1
    return losses


@pytest.mark.parametrize("make_opt", ["lm_optimizer", "lamb"])
def test_checkpoint_round_trip_is_bit_identical(tmp_path, make_opt):
    """Two steps, save, two more; a fresh model restored from the save takes
    the same two steps: the same losses, parameters, optimizer state and lr,
    bit for bit."""

    def build(seed):
        model = _small_lm(seed)
        if make_opt == "lm_optimizer":
            opt, sched = train.lm_optimizer(model, lr=1e-2, warmup=2, steps=6)
        else:
            opt, sched = optim.lamb(model.parameters(), optim.linear_schedule(1e-2, 1e-3, 5),
                                    weight_decay=0.01)
        state = train.create_train_state(model, opt, sched)
        return state, train.make_train_step(model, opt, sched, clip=1.0)

    batches = _batches(4)
    state, step_fn = build(0)
    _run(state, step_fn, batches[:2])
    train.save_checkpoint(str(tmp_path / "ck"), state, {"step": 2, "note": "x"})
    want = _run(state, step_fn, batches[2:])
    fresh, fresh_step = build(1)  # other initial weights: all must come from the file
    fresh, extra = train.restore_checkpoint(str(tmp_path / "ck"), fresh, {"step": 0})
    assert extra == {"step": 2, "note": "x"} and fresh.step == 2
    assert _run(fresh, fresh_step, batches[2:]) == want
    for (n, a), (_, b) in zip(state.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    s1, s2 = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for k, v in s1["state"].items():
        for key, t in v.items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(s2["state"][k][key])), key
    assert state.scheduler.state_dict() == fresh.scheduler.state_dict()
    assert sorted(os.listdir(tmp_path)) == ["ck"]  # no temporary directory left


def test_save_checkpoint_replaces_an_existing_one(tmp_path):
    model = _small_lm()
    state = train.create_train_state(model, *train.lm_optimizer(model))
    path = str(tmp_path / "ck")
    train.save_checkpoint(path, state, {"step": 1})
    state.step = 7
    train.save_checkpoint(path, state, {"step": 2})
    restored, extra = train.restore_checkpoint(path, state, {})
    assert extra == {"step": 2} and restored.step == 7
    assert train.restore_checkpoint(path, state)[1] is None
    assert sorted(os.listdir(tmp_path)) == ["ck"]


@pytest.mark.parametrize("exc", [RuntimeError, KeyboardInterrupt])
def test_auto_save_on_exception_and_latest_checkpoint(tmp_path, exc):
    model = _small_lm()
    state = train.create_train_state(model, *train.lm_optimizer(model))
    ckpt_dir = str(tmp_path)
    assert train.latest_checkpoint(ckpt_dir) is None
    train.save_checkpoint(os.path.join(ckpt_dir, "last"), state, {"step": 1})
    assert train.latest_checkpoint(ckpt_dir) == os.path.join(ckpt_dir, "last")
    os.utime(os.path.join(ckpt_dir, "last"), (1, 1))  # make the regular checkpoint older
    guard = train.auto_save_on_exception(ckpt_dir)
    with pytest.raises(exc):
        with guard:
            state.step = 5
            guard.track(state, extra={"step": 5})
            raise exc("boom")
    auto = os.path.join(ckpt_dir, train.AUTO_SAVE_NAME)
    assert guard.path == auto and train.latest_checkpoint(ckpt_dir) == auto
    _, extra = train.restore_checkpoint(auto, state, {})
    assert extra == {"step": 5}
    with train.auto_save_on_exception(str(tmp_path / "quiet")):  # no exception: no save
        pass
    assert not os.path.exists(tmp_path / "quiet")


def test_auto_save_failure_does_not_hide_the_error(tmp_path, capsys):
    guard = train.auto_save_on_exception(str(tmp_path))
    with pytest.raises(ValueError, match="original"):
        with guard:
            guard.track(object())  # cannot be saved
            raise ValueError("original")
    assert "auto-save failed" in capsys.readouterr().out


# --- the native loader ---------------------------------------------------------------


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "tokens.bin"
    (np.random.default_rng(0).integers(0, 256, 40000)).astype(np.uint8).tofile(path)
    return str(path)


@pytest.mark.parametrize("seed", [0, 9])
def test_native_loader_stream_matches_jax(token_file, seed):
    assert native_loader.available() and jnative.available()
    ours = native_loader.NativeLMLoader(token_file, 3, 50, seed=seed)
    ref = jnative.NativeLMLoader(token_file, 3, 50, seed=seed)
    try:
        assert ours.num_tokens == ref.num_tokens == 40000
        for _ in range(4):
            (x, y), (jx, jy) = ours.next(), ref.next()
            assert x.dtype == np.int32 and x.shape == (3, 50)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
        counter = ours.state()
        assert counter == ref.state() == 4
        nxt = ours.next()[0]
        ours.restore(counter)
        ref.restore(counter)
        np.testing.assert_array_equal(ours.next()[0], nxt)
        np.testing.assert_array_equal(ref.next()[0], nxt)
    finally:
        ours.close()
        ref.close()


def test_native_loader_builds_into_the_port_build_directory(token_file):
    path = native_loader.library_path()
    assert native_loader.available() and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "flashfftconv_tpu_torch"
    with pytest.raises(OSError):
        native_loader.NativeLMLoader(token_file + ".missing", 2, 8)
