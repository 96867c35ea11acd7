"""The output check, driven through the rest of a run on the CPU at a tiny
size (the look for a chip skipped): a sound program comes out correct, and
a program broken underneath the timed path does not, once for each fault
the cell can have. One card a cell, so no exchange between chips."""

from __future__ import annotations

import pytest
import torch
from conftest import CELLS

import flashfftconv_tpu_torch.models.dna as dna
import flashfftconv_tpu_torch.models.lm as lm
import flashfftconv_tpu_torch.utils.metrics as metrics
import flashfftconv_tpu_torch.utils.train as train
from portbench import harness

SEED = 2**31 + 77
TRAIN = [c for c in CELLS if c.endswith(".train")]
SCORE = [c for c in CELLS if c.endswith(".score")]


def _run(h, cell):
    return h.run(cell, SEED, 0.3, False, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_program_is_correct(tiny, cell):
    result = _run(tiny("float32"), cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    make = train.make_train_step

    def half_loss(logits, y):
        if y.shape[0] > 1:
            return train.cross_entropy(logits[: y.shape[0] // 2], y[: y.shape[0] // 2])
        return train.cross_entropy(logits[:, : y.shape[1] // 2], y[:, : y.shape[1] // 2])

    monkeypatch.setattr(train, "make_train_step",
                        lambda *a, **k: make(*a, **{**k, "loss_fn": half_loss}))


def _loss_altered(monkeypatch):
    make = train.make_train_step

    def step_of(*a, **k):
        step = make(*a, **k)

        def altered(x, y):
            out = step(x, y)
            return {**out, "loss": out["loss"] * 1.01}

        return altered

    monkeypatch.setattr(train, "make_train_step", step_of)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _loss_altered],
                         ids=["state_unchanged", "half_batch", "loss_altered"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_train_step_is_not_correct(tiny, monkeypatch, cell, fault):
    h = tiny("float32")
    fault(monkeypatch)
    result = _run(h, cell)
    assert not result["correct"], result["checks"]


def _rows_left_out(monkeypatch):
    """Half of each request's rows scored, the mean taken over the rest."""
    score, loss = dna.score, metrics.cross_entropy
    monkeypatch.setattr(dna, "score", lambda model, ids: score(model, ids[: ids.shape[0] // 2]))
    monkeypatch.setattr(metrics, "cross_entropy",
                        lambda logits, y: loss(logits[: y.shape[0] // 2], y[: y.shape[0] // 2]))


def _logit_altered(monkeypatch):
    """One position's logits come out in the wrong order (reversed over the
    vocabulary), as a kernel writing a row to the wrong place would."""
    forward = lm.ConvLMHeadModel.forward

    def altered(self, ids):
        out = forward(self, ids).clone()
        out[0, 5] = out[0, 5].flip(-1)
        return out

    monkeypatch.setattr(lm.ConvLMHeadModel, "forward", altered)


@pytest.mark.parametrize("fault", [_rows_left_out, _logit_altered],
                         ids=["half_batch", "logit_altered"])
@pytest.mark.parametrize("cell", SCORE)
def test_a_broken_scorer_is_not_correct(tiny, monkeypatch, cell, fault):
    h = tiny("float32")
    fault(monkeypatch)
    result = _run(h, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_not_correct(tiny, cell):
    """The reference in float8 put in the program's place fails the cell's
    limits (the control, kept here at a size a test run holds)."""
    h = tiny("float32")
    wl = h.workload(cell)
    cfg = h.config(wl["config"])
    ref = h.reference(cfg)
    job = h.traffic(wl["traffic"]).Job(cfg, wl, SEED, torch.device("cpu"), ref)
    job.release()
    if job.kind == "train":
        checks = job.compare(job.reference_run(ref.Fp8Rounding()), job.reference_run())
    else:
        checks = job.compare({i: job.reference_answers(i, ref.Fp8Rounding()) for i in job.sampled},
                             {i: job.reference_answers(i) for i in job.sampled})
    assert any(c["value"] > c["limit"] for c in checks), checks
