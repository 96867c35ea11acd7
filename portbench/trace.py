"""Device operations of a profiled stretch, read from ``torch.profiler``'s
events in memory.

Each operation that ran on the card (kernel, copy, fill) is tied to the
host call that launched it through the CUDA runtime or driver event of the
same correlation id, and given the chain of host ranges open on that
thread at the launch (outermost first): aten ops, autograd Functions
(``FftConvFunction``), their backward nodes
(``autograd::engine::evaluate_function: FftConvFunctionBackward``) and
``record_function`` spans such as the optimizer's ``Optimizer.step#``.
Attribution goes by the launching call's ranges, not by kernel name.
Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses

_DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    chain: tuple[str, ...]  # host ranges open at the launch, outermost first

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _activity(e) -> str | None:
    try:
        return e.activity_type()
    except (AttributeError, RuntimeError):
        return None


def _on_device(e) -> bool:
    act = _activity(e)
    if act is not None:
        return act in _DEVICE_ACTIVITIES
    return str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()


def _is_launch(e) -> bool:
    act = _activity(e)
    if act is not None:
        return act in _LAUNCH_ACTIVITIES
    return (not str(e.device_type()).endswith("CUDA")) and e.name().startswith(("cuda", "cu"))


def _is_range(e) -> bool:
    if str(e.device_type()).endswith("CUDA") or e.is_async():
        return False
    act = _activity(e)
    if act is not None:
        return act in ("cpu_op", "user_annotation", "python_function")
    return not e.name().startswith(("cuda", "cu"))


def _chains(ranges, launches) -> dict[int, tuple[str, ...]]:
    """{launch correlation id: names of the ranges open at its start on its
    thread}; ranges nest on a thread, so one sweep with a stack does it."""
    out = {}
    by_thread: dict[int, list] = {}
    for e in ranges:
        by_thread.setdefault(e.start_thread_id(), []).append((e.start_ns(), 0, e))
    for e in launches:
        by_thread.setdefault(e.start_thread_id(), []).append((e.start_ns(), 1, e))
    for items in by_thread.values():
        items.sort(key=lambda it: (it[0], it[1], -it[2].duration_ns()))
        stack = []
        for start, is_launch, e in items:
            while stack and stack[-1][0] <= start:
                stack.pop()
            if is_launch:
                out[e.correlation_id()] = tuple(name for _, name in stack)
            else:
                stack.append((e.end_ns(), e.name()))
    return out


def device_ops(prof) -> tuple[list[DeviceOp], float]:
    """The stretch's device operations in time order, and the share of
    their device time whose launch was found (1.0 when every one was)."""
    events = prof.profiler.kineto_results.events()
    ranges, launches, ops = [], [], []
    for e in events:
        if _on_device(e):
            ops.append(e)
        elif _is_launch(e):
            launches.append(e)
        elif _is_range(e):
            ranges.append(e)
    chains = _chains(ranges, launches)
    out, found, total = [], 0, 0
    for e in ops:
        chain = chains.get(e.correlation_id())
        total += e.duration_ns()
        if chain is not None:
            found += e.duration_ns()
        out.append(DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), chain or ()))
    out.sort(key=lambda op: op.start_ns)
    return out, (found / total if total else 0.0)


def busy_intervals(ops: list[DeviceOp]) -> list[tuple[int, int]]:
    """The union of the operations' intervals, merged, in time order."""
    merged: list[list[int]] = []
    for op in ops:
        if merged and op.start_ns <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], op.end_ns)
        else:
            merged.append([op.start_ns, op.end_ns])
    return [(a, b) for a, b in merged]


def short(name: str, n: int = 120) -> str:
    """A kernel's name without ``void `` and cut to n characters."""
    return name.removeprefix("void ")[:n]


def idle_gaps(ops: list[DeviceOp]) -> list[tuple[str, float]]:
    """Every gap in which no operation ran, labelled with the innermost host
    range that launched the operation ending it (what the host was doing
    while the card waited) or, in a trace without host ranges, with that
    operation's name; in seconds, longest first."""
    gaps, end = [], None
    for op in ops:
        if end is not None and op.start_ns > end:
            label = op.chain[-1] if op.chain else "before " + short(op.name)
            gaps.append((label, (op.start_ns - end) * 1e-9))
        end = op.end_ns if end is None else max(end, op.end_ns)
    return sorted(gaps, key=lambda g: -g[1])


def in_ranges(ops: list[DeviceOp], *prefixes: str) -> list[DeviceOp]:
    """The operations launched inside a host range whose name starts with
    one of ``prefixes``."""
    return [op for op in ops if any(r.startswith(prefixes) for r in op.chain)]


def top_ops(ops: list[DeviceOp], n: int = 10) -> list[tuple[str, float]]:
    """The n device operations that took most time in all, by name."""
    total: dict[str, float] = {}
    for op in ops:
        total[short(op.name)] = total.get(short(op.name), 0.0) + op.seconds
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]
