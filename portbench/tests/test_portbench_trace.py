"""The reduction of profiler events to device operations, busy time, idle
gaps and range attribution, on events made up for the purpose."""

from __future__ import annotations

from portbench import trace
from portbench.trace import DeviceOp


class _Ev:
    def __init__(self, name, start, dur, act, corr=0, thread=1, device="DeviceType.CPU"):
        self._n, self._s, self._d, self._a = name, start, dur, act
        self._c, self._t, self._dev = corr, thread, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._s + self._d

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._a

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def device_type(self):
        return self._dev

    def is_async(self):
        return False

    def is_user_annotation(self):
        return self._a.endswith("user_annotation")


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": lambda self: events})()})()


def test_ops_are_tied_to_the_ranges_open_at_their_launch():
    gpu = "DeviceType.CUDA"
    events = [
        _Ev("FftConvFunction", 0, 100, "cpu_op"),
        _Ev("aten::copy_", 10, 20, "cpu_op"),
        _Ev("cudaLaunchKernel", 15, 2, "cuda_runtime", corr=1),
        _Ev("cuLaunchKernelEx", 50, 2, "cuda_driver", corr=2),
        _Ev("Optimizer.step#AdamW.step", 200, 50, "user_annotation"),
        _Ev("cudaLaunchKernel", 210, 2, "cuda_runtime", corr=3, thread=2),
        _Ev("direct_copy_kernel", 1000, 10, "kernel", corr=1, device=gpu),
        _Ev("monarch_conv_kernel", 1015, 30, "kernel", corr=2, device=gpu),
        _Ev("Optimizer.step#AdamW.step", 1000, 500, "gpu_user_annotation", device=gpu),
        _Ev("adam_kernel", 1100, 5, "kernel", corr=3, device=gpu),
        _Ev("stray_kernel", 1200, 15, "kernel", corr=9, device=gpu),
    ]
    ops, share = trace.device_ops(_Prof(events))
    assert [op.name for op in ops] == ["direct_copy_kernel", "monarch_conv_kernel", "adam_kernel",
                                       "stray_kernel"]
    assert ops[0].chain == ("FftConvFunction", "aten::copy_")
    assert ops[1].chain == ("FftConvFunction",)
    assert ops[2].chain == ()  # launched on another thread, outside any range there
    assert ops[3].chain == ()  # no launch found
    assert share == 45 / 60
    assert [op.name for op in trace.in_ranges(ops, "FftConvFunction")] == [
        "direct_copy_kernel", "monarch_conv_kernel"]


def test_busy_time_and_idle_gaps():
    ops = [DeviceOp("a", 0, 10, ("x",)), DeviceOp("b", 5, 20, ("y",)),
           DeviceOp("c", 30, 40, ("z", "aten::mm")), DeviceOp("d", 41, 45, ())]
    assert trace.busy_intervals(ops) == [(0, 20), (30, 40), (41, 45)]
    assert [(n, round(s * 1e9)) for n, s in trace.idle_gaps(ops)] == [("aten::mm", 10), ("before d", 1)]
    assert [(n, round(s * 1e9)) for n, s in trace.top_ops(ops, 2)] == [("b", 15), ("a", 10)]
