"""The program's own spans over a third profiled stretch, for the readers of
``mixer_ms``, ``update_ms``, ``idle_in_program_ms`` and ``device_allocs``.

With ``--trace 1``, after the window and its two profiled stretches, the
first of these readers runs ``trace_units`` more units of the same job
under ``torch.profiler`` recording the CUDA activity alone (as the first
stretch does, so the host runs at its untraced pace but for the program's
own spans) with the program's tracing on (``flashfftconv_tpu_torch.utils.
tracing``). Nothing that the other metrics read changes: their stretches,
the window's stamps and their ``ctx`` are read before this runs. The
harness hands readers no handle on its job, so ``context`` takes it from
``harness.run``'s frame; a harness that runs the stretch itself passes its
result in ``ctx`` under the keys ``context`` returns, and is read as is.

Each device operation is tied to its launch (the ``cudaLaunch*`` or
``cuLaunch*`` call of the same correlation id) and through the launch's
thread and time to the innermost program span open there. ``ctx`` gains:

- ``program_ops``: ``Op`` a device operation, in time order;
- ``program_spans``, ``program_counters``: ``tracing.collect()``'s record;
- ``program_units``: the stretch's units; ``program_busy_s`` and
  ``program_span_s``: its device time and the time from its first device
  operation to its last.

A program without ``utils.tracing`` (a parent commit) gives no stretch, a
run off the card (the tests) one without device operations, and every such
reader then returns None.
"""

from __future__ import annotations

import dataclasses
import sys
import time

from portbench import trace

_RUNS: dict[int, tuple] = {}  # id of the run's unit_seconds -> (that list, the stretch)


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_ns: int
    end_ns: int
    spans: tuple  # the program spans open at the launch, outermost first

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def within(self, *names: str) -> bool:
        """Whether a span named one of ``names``, or ``<name>.<site>``, was
        open at the launch."""
        return any(s["name"] in names or s["name"].startswith(tuple(n + "." for n in names))
                   for s in self.spans)

    @property
    def recompute(self) -> bool:
        return any(s.get("attrs", {}).get("recompute") for s in self.spans)

    @property
    def innermost(self) -> str | None:
        return self.spans[-1]["name"] if self.spans else None


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _resource(e) -> int | None:
    try:
        return e.device_resource_id()
    except (AttributeError, RuntimeError):
        return None


def tie(events, rec: dict) -> tuple[list[Op], float]:
    """Device operations of the profiler's ``events`` with the program spans
    of ``rec`` open at their launch, and the share of device time whose
    launch lies inside a span. A launch's thread is the span thread whose OS
    id, or Python id cut to 32 bits, the profiler gives for it; where it
    gives neither, or that thread has no span open (autograd's thread
    between two backward spans), the innermost span of any thread open at
    that time, as ``tracing`` parents such spans."""
    spans = [s for s in rec["spans"] if s["end_ns"] is not None]
    byid = {s["id"]: s for s in spans}
    threads = {}
    for s in spans:
        threads[s["thread"]] = s["thread"]
        threads[_int32(s["ident"])] = s["thread"]
    device, launches = [], {}
    for e in events:
        if trace._on_device(e):
            device.append(e)
        elif trace._is_launch(e):
            launches[e.correlation_id()] = (e.start_ns(), threads.get(_resource(e)))
    # one sweep a thread, and one over all threads for launches of none
    by_thread: dict = {}
    for s in spans:
        for key in (s["thread"], None):
            by_thread.setdefault(key, []).append((s["start_ns"], 0, s))
    for corr, (t, thread) in launches.items():
        for key in {thread, None}:
            by_thread.setdefault(key, []).append((t, 1, corr))
    own, any_thread = {}, {}
    for key, items in by_thread.items():
        found = own if key is not None else any_thread
        items.sort(key=lambda it: (it[0], it[1]))
        stack = []
        for t, is_launch, x in items:
            while stack and stack[-1]["end_ns"] < t:
                stack.pop()
            if is_launch:
                found[x] = stack[-1] if stack else None
            else:
                stack.append(x)
    inner = {c: own.get(c) or any_thread.get(c) for c in launches}
    chains = {}

    def chain(s):
        if s is None:
            return ()
        if s["id"] not in chains:
            parent = byid.get(s["parent"])
            chains[s["id"]] = chain(parent) + (s,)
        return chains[s["id"]]

    ops, tied, total = [], 0, 0
    for e in device:
        corr, dur = e.correlation_id(), e.duration_ns()
        op = Op(e.name(), e.start_ns(), e.start_ns() + dur, chain(inner.get(corr)))
        total += dur
        tied += dur if op.spans else 0
        ops.append(op)
    ops.sort(key=lambda op: op.start_ns)
    return ops, (tied / total if total else 0.0)


def idle(ops: list[Op], spans: list[dict]) -> list[tuple[str, int, int]]:
    """Every gap in the device's timeline as (label, ns inside a unit, ns
    between units): the part of the gap inside a root span (a unit) is put
    down to the innermost span open at the launch of the operation that ends
    the gap (or, where that launch came after the unit, to the unit's end),
    the rest fell between units, in the harness."""
    units = trace.busy_intervals([trace.DeviceOp("", s["start_ns"], s["end_ns"], ())
                                  for s in spans if s["end_ns"] is not None and s["parent"] is None])
    gaps, end = [], None
    for op in ops:
        if end is not None and op.start_ns > end:
            inside = sum(max(0, min(b, op.start_ns) - max(a, end)) for a, b in units)
            gaps.append((op.innermost or "after the unit's last launch", inside,
                         op.start_ns - end - inside))
        end = op.end_ns if end is None else max(end, op.end_ns)
    return gaps


def _run_locals():
    """The locals of the ``harness.run`` call that is reading its metrics."""
    from portbench import harness

    f = sys._getframe(1)
    while f is not None:
        if f.f_code is harness.run.__code__:
            return f.f_locals
        f = f.f_back
    return None


def _stretch(job, clock, start: int, units: int) -> dict | None:
    try:
        from flashfftconv_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    from torch.profiler import ProfilerActivity, profile

    clock.sync()
    tracing.collect()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA if clock.cuda else ProfilerActivity.CPU]) as prof:
        tracing.enable()
        try:
            for j in range(units):
                job.unit(start + j)
            clock.sync()
        finally:
            tracing.disable()
    rec = tracing.collect()
    ops, tied = tie(prof.profiler.kineto_results.events(), rec)
    del prof
    busy = trace.busy_intervals(ops)
    span_s = (busy[-1][1] - busy[0][0]) * 1e-9 if busy else 0.0
    busy_s = sum(b - a for a, b in busy) * 1e-9
    loose = trace.top_ops([op for op in ops if not op.spans], 3)
    print(f"[portbench] program spans: {units} units in {time.perf_counter() - t0:.3f} s of host "
          f"time, {len(rec['spans'])} spans, {len(ops)} device operations over {span_s:.6f} s, "
          f"busy {busy_s:.6f} s (idle {(span_s - busy_s) / span_s * 100 if span_s else 0:.3f}%), "
          f"{tied:.4f} of their time tied to a program span; not tied, by name: "
          + ", ".join(f"{n} {t * 1e3:.4f} ms" for n, t in loose), file=sys.stderr)
    return {"program_ops": ops, "program_spans": rec["spans"],
            "program_counters": rec["counters"], "program_units": units,
            "program_busy_s": busy_s, "program_span_s": span_s}


def context(ctx: dict) -> dict | None:
    """The third stretch's record for this run (run once, on the first
    call), or None where there is none."""
    if "program_ops" in ctx:
        return ctx
    key = id(ctx["unit_seconds"])
    if key not in _RUNS:
        run = _run_locals()
        result = None
        if run is not None and ctx.get("profiled_units"):
            result = _stretch(run["job"], run["clock"], run["first"] + ctx["units"],
                              run["cell"]["trace_units"])
        _RUNS.clear()
        _RUNS[key] = (ctx["unit_seconds"], result)
    return _RUNS[key][1]


def per_unit_ms(ops: list[Op], units: int) -> float:
    return sum(op.seconds for op in ops) / units * 1e3
