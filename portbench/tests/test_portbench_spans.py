"""The third profiled stretch (``portbench/spans.py``) and the readers of the
program's spans: device operations tied to program spans through their
launch's thread and time, idle gaps inside and between units, and the
readers' values, on events and spans made up for the purpose; then a tiny
traced run on the CPU, which runs the stretch and reports none of them."""

from __future__ import annotations

import pytest
from conftest import CELLS
from test_portbench_trace import _Ev

from portbench import harness, spans

MAIN, AUTOGRAD = (10, 0x7F00_1234_5678), (20, 0x7F00_8765_4321)
GPU = "DeviceType.CUDA"


class _Launch(_Ev):
    def __init__(self, start, corr, resource=None):
        super().__init__("cudaLaunchKernel", start, 2, "cuda_runtime", corr=corr)
        self._r = resource

    def device_resource_id(self):
        if self._r is None:
            raise RuntimeError("no resource")
        return self._r


def _span(i, name, start, end, thread=MAIN, parent=None, unit=1, **attrs):
    return {"id": i, "name": name, "start_ns": start, "end_ns": end, "thread": thread[0],
            "ident": thread[1], "parent": parent, "unit": unit, **({"attrs": attrs} if attrs else {})}


def _unit(first_id, t0):
    """One train step's spans from t0: forward with a mixer, a backward on
    autograd's thread with a recomputed mixer under ``mixer.bwd``, an update."""
    i = first_id
    return [
        _span(i, "step", t0, t0 + 1000, unit=i),
        _span(i + 1, "step.forward", t0 + 10, t0 + 400, parent=i, unit=i),
        _span(i + 2, "mixer", t0 + 50, t0 + 300, parent=i + 1, unit=i),
        _span(i + 3, "mixer.gate", t0 + 60, t0 + 80, parent=i + 2, unit=i),
        _span(i + 4, "step.backward", t0 + 400, t0 + 900, parent=i, unit=i),
        _span(i + 5, "mixer.bwd", t0 + 450, t0 + 800, AUTOGRAD, parent=i + 4, unit=i),
        _span(i + 6, "mixer", t0 + 460, t0 + 500, AUTOGRAD, parent=i + 5, unit=i,
              recompute=True),
        _span(i + 7, "step.update", t0 + 900, t0 + 1000, parent=i, unit=i),
        _span(i + 8, "step.optimizer", t0 + 950, t0 + 1000, parent=i + 7, unit=i),
    ]


def test_ops_are_tied_to_spans_by_launch_thread_and_time():
    rec = {"spans": _unit(1, 0), "counters": {}}
    ident32 = AUTOGRAD[1] & 0xFFFFFFFF
    ident32 -= 1 << 32 if ident32 >= 1 << 31 else 0
    events = [
        _Launch(70, 1, resource=MAIN[0]),  # inside mixer.gate
        _Launch(470, 2, resource=ident32),  # autograd's thread, by its 32-bit Python id
        _Launch(600, 3, resource=AUTOGRAD[0]),  # autograd's thread, by its OS id
        _Launch(600, 4, resource=MAIN[0]),  # the main thread at that time: step.backward
        _Launch(960, 5),  # no thread known: the innermost span of any thread
        _Launch(1100, 6, resource=MAIN[0]),  # after the unit: no span
        _Launch(850, 8, resource=AUTOGRAD[0]),  # autograd's thread between its spans
    ]
    events += [_Ev(f"k{c}", 2000 + 100 * c, 10 * c, "kernel", corr=c, device=GPU)
               for c in range(1, 9)]  # k7 has no launch
    ops, tied = spans.tie(events, rec)
    chains = {op.name: [s["name"] for s in op.spans] for op in ops}
    assert chains == {
        "k1": ["step", "step.forward", "mixer", "mixer.gate"],
        "k2": ["step", "step.backward", "mixer.bwd", "mixer"],
        "k3": ["step", "step.backward", "mixer.bwd"],
        "k4": ["step", "step.backward"],
        "k5": ["step", "step.update", "step.optimizer"],
        "k6": [], "k7": [], "k8": ["step", "step.backward"]}
    assert tied == pytest.approx(230 / 360)
    by = {op.name: op for op in ops}
    assert [n for n, op in by.items() if op.within("mixer")] == ["k1", "k2", "k3"]
    assert [n for n, op in by.items() if op.recompute] == ["k2"]


def _op(start, end, chain=()):
    return spans.Op("k", start, end, tuple({"name": n} for n in chain))


def test_idle_gaps_inside_and_between_units():
    units = [_span(1, "step", 0, 100, unit=1), _span(2, "step", 200, 300, unit=2),
             _span(3, "step.forward", 10, 90, parent=1, unit=1)]
    ops = [_op(0, 20, ["step", "step.forward"]), _op(30, 50, ["step", "step.forward"]),
           _op(45, 60, ["step", "step.update"]),  # overlaps: no gap
           _op(150, 170),  # a gap that falls outside every span, between the units
           _op(250, 260, ["step", "step.forward"])]  # a gap from 170 to 250, 50 ns inside a unit
    assert spans.idle(ops, units) == [("step.forward", 10, 0),
                                      ("after the unit's last launch", 40, 50),
                                      ("step.forward", 50, 30)]


def _ctx(ops, counters=None, units=2, **extra):
    return {"metric": "m", "program_ops": ops, "program_spans": extra.get("program_spans", []),
            "program_counters": counters or {}, "program_units": units,
            "program_busy_s": 0.9e-6, "program_span_s": 1e-6, "span_s": 1e-6, "busy_s": 0.95e-6,
            "profiled_units": units, "unit_seconds": []}


def test_readers_on_a_made_up_stretch():
    ops = [_op(0, 1_000_000, ["step", "step.forward", "mixer", "mixer.in_proj"]),
           _op(1_000_000, 1_500_000, ["step", "step.backward", "mixer.bwd"]),
           spans.Op("direct_copy_kernel_cuda", 2_000_000, 2_250_000,
                    ({"name": "step"}, {"name": "step.backward"}, {"name": "mixer.bwd"},
                     {"name": "mixer", "attrs": {"recompute": True}})),
           _op(3_000_000, 3_400_000, ["step", "step.update", "step.clip"]),
           _op(3_500_000, 3_600_000, ["step", "step.update"]),
           _op(3_800_000, 4_000_000, ["step", "step.update", "step.optimizer"])]
    units = [_span(1, "step", 0, 4_000_000, unit=1)]
    counters = {1: {"device_allocs": 6}, 7: {"device_allocs": 2}}
    ctx = _ctx(ops, counters, program_spans=units)
    read = {m: harness.reader(m).read({**ctx, "metric": m})
            for m in ("mixer_ms.train", "update_ms.train", "idle_in_program_ms.train",
                      "device_allocs.train")}
    assert read["mixer_ms.train"] == pytest.approx(1.75 / 2)
    assert read["update_ms.train"] == pytest.approx(0.7 / 2)
    # gaps 1.5-2.0, 2.25-3.0, 3.4-3.5 and 3.6-3.8 ms, all inside the unit
    assert read["idle_in_program_ms.train"] == pytest.approx(1.55 / 2)
    assert read["device_allocs.train"] == 4
    assert harness.reader("device_allocs.score").read({**_ctx(ops), "metric": "m"}) is None


def test_readers_find_nothing_without_a_stretch():
    """A run without the third stretch (a program without spans, or readers
    called outside a harness run): every reader returns None."""
    ctx = {"metric": "m", "unit_seconds": [0.1], "units": 1, "profiled_units": 1}
    for m in ("mixer_ms.score", "update_ms.train", "idle_in_program_ms.score",
              "device_allocs.train"):
        assert harness.reader(m).read({**ctx, "metric": m}) is None
    assert harness.reader("mixer_ms.train").read(_ctx([])) is None


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_a_traced_cpu_run_runs_the_stretch_and_reports_none_of_it(tiny, cell):
    result = tiny("float32").run(cell, 2**31 + 9, 0.3, True, device="cpu")
    assert result["correct"]
    assert not any(m.split(".")[0] in ("mixer_ms", "update_ms", "idle_in_program_ms",
                                       "device_allocs") for m in result["metrics"])
    (_, stretch), = spans._RUNS.values()
    roots = [s for s in stretch["program_spans"] if s["parent"] is None]
    assert stretch["program_units"] == 1 and stretch["program_ops"] == []
    assert [r["name"] for r in roots] == (["step"] if cell.endswith(".train") else ["score"])
