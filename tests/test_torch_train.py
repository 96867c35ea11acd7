"""The port's optimizer, schedule, metrics and train and eval steps against the
JAX package's and optax's, the remat grads of FlashFFTConv, and the LM
batches. Helpers and tolerances are those of ``test_torch_models.py``, whose
docstring states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import optax
from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.utils import metrics as jmetrics
from flashfftconv_tpu.utils import optim as joptim
from flashfftconv_tpu.utils import train as jtrain
from flashfftconv_tpu_torch import FlashFFTConv
from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
from flashfftconv_tpu_torch.utils import data, jax_weights, metrics, optim, train
from test_torch_models import CPU, LM, _init, _np, _tree_paths

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def test_optimizer_groups_match_kernel_label_fn():
    """The special (no weight decay) group holds exactly the parameters the
    JAX labels mark: every Dense kernel, and no LayerNorm scale although
    both are ``.weight`` in the port."""
    jm = JLM(**LM, mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32}, dtype=jnp.float32)
    _, pnp = _init(jm, jnp.zeros((1, 64), jnp.int32))
    jlabels = _tree_paths(joptim.label_params(pnp, joptim.kernel_label_fn))
    tm = ConvLMHeadModel(**LM, device=CPU)
    paths = jax_weights.flax_paths(tm)
    labels = optim.label_params(tm)
    assert {paths[n]: lab for n, lab in labels.items()} == jlabels
    assert labels["backbone.blocks.0.norm1.weight"] == "default"
    assert labels["backbone.blocks.0.mlp.fc1.weight"] == "special"
    opt, _ = optim.make_optimizer(tm, lr=2e-3, weight_decay=0.05, special_lr=1e-3)
    named = {id(p): n for n, p in tm.named_parameters()}
    special = {named[id(p)] for p in opt.param_groups[1]["params"]}
    assert special == {n for n, lab in labels.items() if lab == "special"}
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]


@pytest.mark.parametrize("init,peak,warmup,decay,end", [
    (0.0, 3e-4, 2, 7, 0.0), (0.0, 1e-3, 20, 200, 1e-5), (1e-4, 5e-3, 1, 2, 0.0),
])
def test_schedule_matches_optax(init, peak, warmup, decay, end):
    """Step by step, within optax's own f32 rounding (rel 1e-5); 0 exactly at
    step 0 when init is 0."""
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    mine = optim.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    for step in range(decay + 3):
        assert mine(step) == pytest.approx(float(ref(step)), rel=1e-5, abs=1e-12)
    if init == 0.0:
        assert mine(0) == 0.0
    lin = optax.linear_schedule(init, peak, warmup)
    assert [optim.linear_schedule(init, peak, warmup)(s) for s in range(warmup + 2)] == \
        pytest.approx([float(lin(s)) for s in range(warmup + 2)], rel=1e-5, abs=1e-12)


def test_lm_optimizer_first_update_runs_at_lr_zero():
    """optax counts updates from 0: the LambdaLR gives the first update lr =
    schedule(0) = 0 and then follows the schedule step by step."""
    tm = ConvLMHeadModel(d_model=16, n_layer=1, d_inner=32, vocab_size=32, l_max=64, device=CPU)
    opt, sched = train.lm_optimizer(tm, lr=3e-4, weight_decay=0.1, warmup=2, steps=7)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 7)
    before = [p.detach().clone() for p in tm.parameters()]
    for step in range(7):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(ref(step)), rel=1e-5, abs=1e-12)
        for p in tm.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
        if step == 0:
            assert all(torch.equal(a, p) for a, p in zip(before, tm.parameters()))


def test_train_steps_match_optax_chain():
    """Three steps of the examples/lm optax chain (clip_by_global_norm, then
    adamw over warmup_cosine_decay_schedule) against three steps of the
    port's recipe, from the same weights and batch, dropout off."""
    cfg = dict(d_model=32, n_layer=2, d_inner=128, vocab_size=256, l_max=128)
    lr, wd, warmup, steps = 1e-3, 0.1, 1, 3
    jm = JLM(**cfg, mixer_kwargs={"impl": "xla", "conv_dtype": jnp.float32}, dtype=jnp.float32)
    xy = np.random.default_rng(5).integers(0, 256, (2, 129))
    x, y = xy[:, :-1], xy[:, 1:]
    params, pnp = _init(jm, jnp.asarray(x))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1)),
        weight_decay=wd))
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(lambda p: jmetrics.cross_entropy(
            jm.apply({"params": p}, jnp.asarray(x), deterministic=True), jnp.asarray(y)))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for _ in range(steps):
        params, opt_state, loss = jstep(params, opt_state)
        jlosses.append(float(loss))
    tm = ConvLMHeadModel(**cfg, mixer_kwargs={"conv_dtype": torch.float32},
                         dtype=torch.float32, device=CPU).eval()
    tm.load_state_dict(jax_weights.from_jax_params(pnp), strict=True)
    opt, sched = train.lm_optimizer(tm, lr=lr, weight_decay=wd, warmup=warmup, steps=steps)
    step = train.make_train_step(tm, opt, sched, clip=1.0)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"]) for _ in range(steps)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2 * lr * steps,
                                   err_msg=name)


def test_cross_entropy_and_metrics_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 9))
    masked = targets.copy()
    masked[0, :4] = 3  # JAX gathers the ignored targets too, so they must be valid ids
    for t, ignore in ((targets, None), (masked, 3)):
        jl, jt = jnp.asarray(logits), jnp.asarray(t)
        ref, ref_grad = jax.value_and_grad(jmetrics.cross_entropy)(jl, jt, ignore)
        tl = torch.from_numpy(logits).requires_grad_()
        got = metrics.cross_entropy(tl, torch.from_numpy(t), ignore)
        got.backward()
        assert float(got.detach()) == pytest.approx(float(ref), rel=1e-6)
        np.testing.assert_allclose(tl.grad.numpy(), _np(ref_grad), atol=1e-7)
        tt, tl = torch.from_numpy(t), tl.detach()
        assert float(metrics.perplexity(tl, tt, ignore)) == pytest.approx(
            float(jmetrics.perplexity(jl, jt, ignore)), rel=1e-6)
        assert float(metrics.accuracy(tl, tt, ignore)) == pytest.approx(
            float(jmetrics.accuracy(jl, jt, ignore)), rel=1e-6)
        assert int(metrics.num_tokens(tt, ignore)) == int(jmetrics.num_tokens(jt, ignore))
    t100 = torch.from_numpy(targets).masked_fill(torch.from_numpy(masked == 3), -100)
    tl = torch.from_numpy(logits).requires_grad_()
    metrics.cross_entropy(tl, t100, -100).backward()
    tr = torch.from_numpy(logits).requires_grad_()
    torch.nn.functional.cross_entropy(tr.reshape(-1, 11), t100.reshape(-1), ignore_index=-100
                                      ).backward()
    np.testing.assert_allclose(tl.grad.numpy(), tr.grad.numpy(), atol=1e-7)
    bf = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    metrics.cross_entropy(bf, torch.from_numpy(targets)).backward()
    assert bf.grad.dtype == torch.bfloat16
    assert float(metrics.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))) == \
        pytest.approx(float(torch.nn.functional.cross_entropy(
            torch.from_numpy(logits).reshape(-1, 11), torch.from_numpy(targets).reshape(-1))),
            rel=1e-6)


def test_norms_counts_and_ema_match_jax():
    tm = ConvLMHeadModel(d_model=16, n_layer=1, d_inner=32, vocab_size=32, l_max=64, device=CPU,
                         generator=torch.Generator().manual_seed(0))
    for p in tm.parameters():
        p.grad = torch.full_like(p, 0.5)
    tree = {n: jnp.asarray(np.array(p.detach())) for n, p in tm.named_parameters()}
    norms = metrics.param_and_grad_norms(tm)
    assert float(norms["param_norm"]) == pytest.approx(float(jmetrics.global_norm(tree)), rel=1e-5)
    assert float(norms["grad_norm"]) == pytest.approx(0.5 * sum(p.numel() for p in tm.parameters())
                                                      ** 0.5, rel=1e-5)
    counts = metrics.param_counts(tm)
    assert counts["total"] == sum(counts[k] for k in ("embeddings", "backbone"))
    ema = optim.ema_init(tm)
    jema = joptim.ema_init(tree)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    optim.ema_update(ema, tm, decay=0.9)
    jema = joptim.ema_update(jema, {n: v + 1.0 for n, v in tree.items()}, decay=0.9)
    for n in ema:
        np.testing.assert_allclose(ema[n].numpy(), _np(jema[n]), rtol=1e-6, atol=1e-7)
    swapped = optim.ema_swap(ema, tm)
    assert tm.load_state_dict(swapped, strict=False).unexpected_keys == []
    monitor = metrics.SpeedMonitor()
    assert monitor.step(10) == {} and set(monitor.step(10)) == {"step_time_ms", "items_per_sec"}


def test_eval_step_matches_jax_make_eval_step():
    """A classification head (x @ W^T): loss, correct and total with a
    masked padding row, dropout state restored afterwards."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((5, 8)).astype(np.float32)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.integers(0, 5, 6)
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)
    jstep = jtrain.make_eval_step(lambda v, xx, deterministic: xx @ v["params"]["w"].T)
    ref = jstep({"w": jnp.asarray(w)}, (jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    lin = torch.nn.Linear(8, 5, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    lin.train()
    got = train.make_eval_step(lin)((torch.from_numpy(x), torch.from_numpy(y),
                                     torch.from_numpy(mask)))
    assert lin.training
    for key in ("loss", "correct", "total"):
        assert float(got[key]) == pytest.approx(float(ref[key]), rel=1e-6), key


@pytest.mark.parametrize("remat", [True, False])
def test_flash_fft_conv_remat_grads(remat):
    """remat is accepted with the JAX module's default (True); both values
    give the JAX module's grads and save only the Function's inputs."""
    import inspect

    from flashfftconv_tpu import FlashFFTConv as JFlashFFTConv

    assert inspect.signature(FlashFFTConv).parameters["remat"].default is True
    rng = np.random.default_rng(8)
    u, k, pre, post = (rng.standard_normal(s).astype(np.float32)
                       for s in ((2, 4, 200), (4, 150), (2, 4, 200), (2, 4, 200)))
    dout = rng.standard_normal((2, 4, 200)).astype(np.float32)
    jconv = JFlashFFTConv(512, dtype=jnp.float32, remat=remat)
    ref = jax.grad(lambda *a: jnp.sum(jconv(*a) * dout), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (u, k, pre, post)))
    conv = FlashFFTConv(512, dtype=torch.float32, device=CPU, remat=remat)
    ts = [torch.from_numpy(a).requires_grad_() for a in (u, k, pre, post)]
    y = conv(*ts)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 4 and all(a is b for a, b in zip(saved, ts))
    got = torch.autograd.grad(y, ts, torch.from_numpy(dout))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(r), atol=1e-4 * max(1.0, float(np.abs(r).max())))


def test_lm_train_mode_takes_steps_on_cpu():
    """train() mode (embed dropout 0.1, resid dropout) runs forward and
    backward through the Functions, in bf16 activations with f32 weights,
    and the loss falls over a few steps on one batch."""
    torch.manual_seed(0)
    tm = ConvLMHeadModel(d_model=32, n_layer=2, d_inner=64, vocab_size=64, l_max=128,
                         resid_dropout=0.1, dtype=torch.bfloat16, device=CPU,
                         generator=torch.Generator().manual_seed(1)).train()
    opt, sched = train.lm_optimizer(tm, lr=3e-3, weight_decay=0.1, warmup=1, steps=6)
    step = train.make_train_step(tm, opt, sched)
    xy = torch.randint(0, 64, (2, 129), generator=torch.Generator().manual_seed(2))
    out = [step(xy[:, :-1], xy[:, 1:]) for _ in range(6)]
    losses = [float(o["loss"]) for o in out]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("batch,seq_len", [(1, 1000), (3, 64)])
def test_lm_batches_match_jax(batch, seq_len):
    """The same generator gives the JAX function's windows, batch after
    batch, targets one position after inputs."""
    from flashfftconv_tpu.utils.data import lm_batches as jlm_batches

    tokens = np.random.default_rng(0).integers(0, 5, 5000).astype(np.int32)
    mine = data.lm_batches(tokens, batch, seq_len, np.random.default_rng(7))
    ref = jlm_batches(tokens, batch, seq_len, np.random.default_rng(7))
    for _ in range(3):
        (x, y), (rx, ry) = next(mine), next(ref)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        assert x.shape == (batch, seq_len) and np.array_equal(x[:, 1:], y[:, :-1])
