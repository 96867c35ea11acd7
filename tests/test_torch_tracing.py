"""The port's spans and counters (``utils.tracing``) on a tiny Hyena LM on the
CPU: off, the graph and the numbers are the untraced program's and nothing
is recorded; on, one train step gives the span tree the module documents,
its backward spans on the thread that ran the backward, recomputed spans
under ``remat``, and times on torch.profiler's clock."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flashfftconv_tpu_torch.models import dna
from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
from flashfftconv_tpu_torch.utils import metrics, tracing
from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

torch.set_num_threads(1)

N_LAYER = 2
SITES = ["mixer.in_proj", "mixer.short_conv", "mixer.filter", "mixer.gate", "mixer.long_conv",
         "mixer.gate", "mixer.gate", "mixer.out_proj"]
MARKS = ("_OpenBwdBackward", "_CloseBwdBackward")


def _model(remat=False):
    torch.manual_seed(0)
    return ConvLMHeadModel(16, N_LAYER, 64, 61, 128, mixer="hyena", embed_dropout=0.0,
                           remat=remat, dtype=torch.float32, device="cpu")


def _batch():
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, 61, (2, 128), generator=g), torch.randint(0, 61, (2, 128), generator=g)


@pytest.fixture(autouse=True)
def _off_after():
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def _nodes(t):
    """The names of every node of t's autograd graph, once each."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [nxt for nxt, _ in fn.next_functions]
    return names


def _loss_and_grads(model, x, y):
    loss = metrics.cross_entropy(model(x), y)
    nodes = _nodes(loss)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, nodes


def _steps(on: bool, remat=False):
    model = _model(remat)
    opt, sched = lm_optimizer(model, warmup=2, steps=10)
    step = make_train_step(model, opt, sched)
    x, y = _batch()
    if on:
        tracing.enable()
    losses = [step(x, y)["loss"] for _ in range(2)]
    tracing.disable()
    return losses, dict(model.named_parameters()), tracing.collect()


def test_off_records_nothing_and_keeps_graph_and_numbers():
    x, y = _batch()
    model = _model()
    loss_off, grads_off, nodes_off = _loss_and_grads(model, x, y)
    assert tracing.collect() == {"spans": [], "counters": {}}
    assert not any(n in MARKS for n in nodes_off)
    tracing.enable()
    loss_on, grads_on, nodes_on = _loss_and_grads(model, x, y)
    tracing.disable()
    assert tracing.collect()["spans"]
    marks = [n for n in nodes_on if n in MARKS]
    assert marks and len(nodes_on) - len(marks) == len(nodes_off)
    assert sorted(n for n in nodes_on if n not in MARKS) == sorted(nodes_off)
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(grads_on[n], g) for n, g in grads_off.items())
    # two optimizer steps: the same losses and parameters, bit for bit
    (l_off, p_off, rec_off), (l_on, p_on, rec_on) = _steps(False), _steps(True)
    assert rec_off == {"spans": [], "counters": {}} and rec_on["spans"]
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    assert all(torch.equal(p_on[n], p) for n, p in p_off.items())


def _tree(rec):
    spans = rec["spans"]
    kids = {s["id"]: [] for s in spans}
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]].append(s)
    return spans, kids


def _names(kids, s):
    return [k["name"] for k in kids[s["id"]]]


def test_on_gives_the_span_tree_of_a_train_step():
    model = _model()
    opt, sched = lm_optimizer(model, warmup=2, steps=10)
    step = make_train_step(model, opt, sched)
    x, y = _batch()
    bwd_threads = []
    model.embeddings.weight.register_hook(lambda g: bwd_threads.append(threading.get_native_id()))
    tracing.enable()
    step(x, y)
    tracing.disable()
    rec = tracing.collect()
    spans, kids = _tree(rec)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["step"]
    root = roots[0]
    assert all(s["unit"] == root["id"] for s in spans)
    assert all(s["start_ns"] <= s["end_ns"] for s in spans)
    assert _names(kids, root) == ["step.update", "step.forward", "step.backward", "step.update"]
    upd0, fwd, bwd, upd = kids[root["id"]]
    assert _names(kids, upd0) == [] and _names(kids, fwd) == ["model", "loss"]
    assert _names(kids, upd) == ["step.clip", "step.optimizer", "step.schedule"]
    model_span = kids[fwd["id"]][0]
    assert _names(kids, model_span) == ["embed"] + ["block"] * N_LAYER + ["head"]
    blocks = [k for k in kids[model_span["id"]] if k["name"] == "block"]
    assert [b["attrs"]["layer"] for b in blocks] == list(range(N_LAYER))
    for b in blocks:
        assert _names(kids, b) == ["block.residual", "block.norm", "mixer", "block.residual",
                                   "block.norm", "block.mlp", "block.residual"]
        mixer = kids[b["id"]][2]
        assert _names(kids, mixer) == SITES
    # the backward: head, then each layer's MLP and mixer from the last layer down
    assert _names(kids, bwd) == ["head.bwd"] + ["block.mlp.bwd", "mixer.bwd"] * N_LAYER
    mixers = [k for k in kids[bwd["id"]] if k["name"] == "mixer.bwd"]
    assert [m["attrs"]["layer"] for m in mixers] == list(reversed(range(N_LAYER)))
    for m in mixers:
        assert _names(kids, m) == [n + ".bwd" for n in reversed(SITES)]
    bwd_spans = [s for s in spans if s["name"].endswith(".bwd")]
    assert {s["thread"] for s in bwd_spans} == set(bwd_threads)
    assert all(bwd["start_ns"] <= s["start_ns"] <= s["end_ns"] <= bwd["end_ns"]
               for s in bwd_spans)
    # off the card the allocator counter is absent, not a made-up number
    assert rec["counters"] == {}


def test_backward_on_another_thread_hangs_under_the_unit():
    """As autograd's device thread does on the card: the backward spans get
    that thread's id, the unit's id and, as parent, the span the unit's own
    thread has open."""
    model = _model()
    x, y = _batch()
    tracing.enable()
    with tracing.span("step"):
        loss = metrics.cross_entropy(model(x), y)
        with tracing.span("step.backward"):
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join(timeout=60)
            assert not worker.is_alive()
    tracing.disable()
    spans, kids = _tree(tracing.collect())
    root, bwd = spans[0], next(s for s in spans if s["name"] == "step.backward")
    assert _names(kids, bwd) == ["head.bwd"] + ["block.mlp.bwd", "mixer.bwd"] * N_LAYER
    top = kids[bwd["id"]]
    assert {s["thread"] for s in top} == {worker.native_id} != {root["thread"]}
    assert all(s["unit"] == root["id"] for s in spans)


def test_remat_marks_the_recomputed_spans():
    (l_on, p_on, rec), (l_off, p_off, _) = _steps(True, remat=True), _steps(False, remat=True)
    spans, kids = _tree(rec)
    byid = {s["id"]: s for s in spans}
    again = [s for s in spans if s.get("attrs", {}).get("recompute")]
    assert {s["name"] for s in again} >= {"block", "mixer", "block.mlp", *SITES}

    def ancestors(s):
        while s["parent"] is not None:
            s = byid[s["parent"]]
            yield s["name"]

    assert all("step.backward" in ancestors(s) for s in again)
    assert not any(s.get("attrs", {}).get("recompute") for s in spans
                   if "step.backward" not in ancestors(s))
    # each step recomputes every block once
    assert sum(s["name"] == "block" for s in again) == 2 * N_LAYER
    # tracing changes no number under remat either
    assert all(torch.equal(a, b) for a, b in zip(l_on, l_off))
    assert all(torch.equal(p_on[n], p) for n, p in p_off.items())


def test_spans_share_the_profilers_clock():
    """Every aten op the profiler saw inside the model lies inside the
    innermost program span open at its start."""
    model = _model()
    x, y = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with torch.no_grad():
            model(x)
        tracing.disable()
    spans = tracing.collect()["spans"]
    lo, hi = spans[0]["start_ns"], spans[0]["end_ns"]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::") and lo <= e.start_ns() <= hi]
    assert len(ops) > 50
    for e in ops:
        inner = max((s for s in spans if s["start_ns"] <= e.start_ns() <= s["end_ns"]),
                    key=lambda s: s["start_ns"])
        assert e.end_ns() <= inner["end_ns"], (e.name(), inner["name"])


def test_score_and_eval_units():
    model = dna.build_model("tiny-1k", d_model=16, n_layer=1, l_max=256, dtype=torch.float32,
                            device="cpu")
    ids = torch.randint(0, 5, (2, 256))
    tracing.enable()
    dna.score(model, ids)
    with torch.no_grad():
        metrics.cross_entropy(model(ids), ids)
    tracing.disable()
    spans, kids = _tree(tracing.collect())
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["score", "model", "loss"]
    assert _names(kids, roots[0]) == ["model", "score.answer"]
    # the loss after an eval forward belongs to that forward's unit
    assert roots[2]["unit"] == roots[1]["id"] != roots[0]["id"]
    assert not any(s["name"].endswith(".bwd") for s in spans)


def test_counters_belong_to_the_current_unit():
    tracing.count("device_allocs")  # off: nothing
    tracing.enable()
    with tracing.span("model"):
        tracing.count("device_allocs", 3)
        tracing.count("device_allocs")
    tracing.disable()
    rec = tracing.collect()
    assert rec["counters"] == {rec["spans"][0]["id"]: {"device_allocs": 4}}
    assert tracing.collect() == {"spans": [], "counters": {}}
    t = torch.ones(3, requires_grad=True)
    assert tracing.span("x").inputs(t) is t and tracing.span("x").outputs(t, t) == (t, t)
