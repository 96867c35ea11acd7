"""Benchmark and profiling helpers (PyTorch).

Port of the JAX package's ``utils/benchmarking.py``. On the card a time is
taken with CUDA events around a run of launches after a warm-up, and
``elapsed_time`` over the count (PyTorch returns before the device
finishes, so a host clock alone would time the enqueue); memory is
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``; a
trace is ``torch.profiler``'s. Every helper takes ``device`` ("cuda" by
default); with ``device="cpu"`` the timers use the host clock and the
memory probe reports nothing (NaN), so that no CPU number passes for a
device metric.

The FLOP models are the JAX package's: the algorithmic work of an FFT
conv (three FFTs and the pointwise product), the matmul FLOPs of its
Monarch chain (``monarch_tensor_core_flops``, the JAX package's
``monarch_mxu_flops``), and ``peak_flops``, the published dense peak of the
card by its name.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

from flashfftconv_tpu_torch.utils import tracing


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a device measurement needs the card "
                           "(pass device='cpu' for a host-clock time)")
    return device


def _timed_loop(fn: Callable, n: int, device: torch.device) -> float:
    """ms per call of n calls of fn, on the device's clock."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def benchmark_forward(fn: Callable, *args, repeats: int = 10, warmup: int = 3, desc: str = "",
                      verbose: bool = False, device="cuda") -> float:
    """ms a call of fn(*args): ``warmup`` calls, then ``repeats`` calls
    between two CUDA events (the host clock with device="cpu")."""
    device = _device(device)
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = _timed_loop(lambda: fn(*args), max(repeats, 1), device)
    if verbose:
        print(f"{desc}: {ms:.4f} ms")
    return ms


def _chain(fn: Callable, length: int) -> Callable:
    """fn applied ``length`` times, each output fed back as the next first
    argument (cast and reshaped to its), so that none can be skipped or
    overlapped."""

    def chained(u, *rest):
        c = u
        for _ in range(length):
            c = fn(c, *rest).to(u.dtype).reshape(u.shape)
        return c

    return chained


def benchmark_forward_amortized(fn: Callable, u: torch.Tensor, *rest, length: int = 16,
                                repeats: int = 10, warmup: int = 2, desc: str = "",
                                verbose: bool = False, device="cuda") -> float:
    """ms a call of fn when ``length`` applications are chained (``_chain``):
    the chain's time over ``length``."""
    t = benchmark_forward(_chain(fn, length), u, *rest, repeats=repeats, warmup=warmup,
                          device=device)
    per_call = t / length
    if verbose:
        print(f"{desc}: {per_call:.4f} ms/call (x{length} chain)")
    return per_call


def _grad_of_sum_of_squares(fn: Callable, args, argnums):
    leaves = [args[i].detach().requires_grad_() for i in argnums]
    full = list(args)
    for i, leaf in zip(argnums, leaves):
        full[i] = leaf

    def run():
        with torch.enable_grad():
            loss = (fn(*full).float() ** 2).sum()
            return torch.autograd.grad(loss, leaves)

    return run


def benchmark_backward(fn: Callable, *args, argnums=(0,), repeats: int = 10, warmup: int = 3,
                       desc: str = "", verbose: bool = False, device="cuda") -> float:
    """ms of the forward and backward of sum(fn(*args)**2) with respect to
    the arguments at ``argnums``."""
    run = _grad_of_sum_of_squares(fn, args, argnums)
    device = _device(device)
    for _ in range(warmup):
        run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = _timed_loop(run, max(repeats, 1), device)
    if verbose:
        print(f"{desc or 'backward'}: {ms:.4f} ms")
    return ms


def benchmark_backward_amortized(fn: Callable, u: torch.Tensor, *rest, argnums=(0,),
                                 length: int = 8, repeats: int = 10, warmup: int = 2,
                                 desc: str = "", verbose: bool = False, device="cuda") -> float:
    """The forward and backward of ``length`` chained applications of fn
    (``_chain``), over ``length``."""
    t = benchmark_backward(_chain(fn, length), u, *rest, argnums=argnums, repeats=repeats,
                           warmup=warmup, device=device)
    per_call = t / length
    if verbose:
        print(f"{desc}: {per_call:.4f} ms/call fwd+bwd (x{length} chain)")
    return per_call


def benchmark_memory(fn: Callable, *args, desc: str = "", verbose: bool = False,
                     device="cuda") -> float:
    """Peak device memory of one call of fn(*args) in MB, beyond what was
    allocated before it (its temporaries and outputs); NaN on the CPU."""
    device = _device(device)
    if device.type != "cuda":
        return float("nan")
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    torch.cuda.synchronize(device)
    mb = (torch.cuda.max_memory_allocated(device) - base) / 2**20
    del out
    if verbose:
        print(f"{desc}: {mb:.1f} MB")
    return mb


@contextlib.contextmanager
def profile_trace(logdir: str | None = None, device="cuda"):
    """torch.profiler over the block (the card's kernels too on CUDA),
    exported as a Chrome trace to ``logdir/trace.json`` (a new temporary
    directory when none is given). Yields the profiler; ``key_averages()``
    gives device time by kernel.

    The program's own tracing (``utils.tracing``) is on for the block: its
    spans join the trace as complete events of category ``program_span`` on
    the threads that ran them, and each unit's ``device_allocs`` as a
    counter event at the end of its root span, on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    device = _device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir or tempfile.mkdtemp(prefix="torch-trace-"))
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        tracing.enable()
        try:
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            tracing.disable()
    path = logdir / "trace.json"
    prof.export_chrome_trace(str(path))
    _add_program_spans(path, tracing.collect())


def _add_program_spans(path: Path, rec: dict) -> None:
    """Write ``tracing.collect()``'s spans and counters into the Chrome trace
    at ``path``; its times are microseconds after ``baseTimeNanoseconds``."""
    trace = json.loads(path.read_text())
    base, pid = trace.get("baseTimeNanoseconds", 0), os.getpid()
    events = trace.setdefault("traceEvents", [])
    ends = {}
    for s in rec["spans"]:
        if s["end_ns"] is None:
            continue
        ends[s["id"]] = s["end_ns"]
        events.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid,
                       "tid": s["thread"], "ts": (s["start_ns"] - base) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {"id": s["id"], "parent": s["parent"], "unit": s["unit"],
                                **s.get("attrs", {})}})
    for unit, counters in rec["counters"].items():
        if unit in ends:
            events.append({"ph": "C", "cat": "program_counter", "name": "program counters",
                           "pid": pid, "ts": (ends[unit] - base) / 1e3, "args": counters})
    path.write_text(json.dumps(trace))


# --- FLOP models --------------------------------------------------------------

# Dense peaks by device name (NVIDIA's data sheets, SXM parts, without
# sparsity, at the full power limit): bf16/f16 on the tensor cores, f32 on
# the CUDA cores.
_PEAK_FLOPS = (
    ("H100", {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}),
    ("H200", {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}),
)


def peak_flops(device="cuda", dtype: torch.dtype = torch.bfloat16) -> float | None:
    """The card's published dense peak FLOP/s for ``dtype``, from its name;
    None on the CPU or for a card not in the table."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAK_FLOPS:
        if key in name:
            return peaks.get(dtype)
    return None


def fftconv_algo_flops(seqlen: int, b: int, h: int, gated: bool = False) -> float:
    """Algorithmic FLOPs of one FFT convolution over (b, h) channels: 3
    complex FFTs at 5 N log2 N real FLOPs each, the 6N pointwise complex
    product and 4N more with gates."""
    n = float(seqlen)
    per_channel = 15.0 * n * math.log2(n) + 6.0 * n + (4.0 * n if gated else 0.0)
    return per_channel * b * h


def monarch_tensor_core_flops(seqlen: int, factors: tuple[int, ...], b: int, h: int) -> float:
    """Matrix-unit FLOPs of the JAX package's Monarch forward chain a conv,
    counted as its ``monarch_mxu_flops`` counts them (each complex matmul as
    3 real ones; per real channel 6 N^2 for one factor, 6 N (g n1 + n2) with
    g = 128 // n1 for two, 6 N (n1 + n2) for three, 6 N (n1 + n2 + f00) for
    four): the work a tensor-core Monarch chain would do."""
    n = float(seqlen)
    if len(factors) == 1:
        per = 6.0 * n * n
    elif len(factors) == 2:
        n1, n2 = factors
        g = max(1, 128 // n1)
        per = 6.0 * n * (g * n1 + n2)
    elif len(factors) == 3:
        _, n1, n2 = factors
        per = 6.0 * n * (n1 + n2)
    else:
        f00, _, n1, n2 = factors
        per = 6.0 * n * (n1 + n2 + f00)
    return per * b * h


def conv_throughput(seqlen: int, factors: tuple[int, ...], b: int, h: int, ms: float,
                    gated: bool = False, device="cuda") -> dict:
    """For one measured conv forward of ``ms``: algorithmic GFLOP/s, the
    Monarch chain's matrix GFLOP/s and its share of the card's bf16 peak
    ("mfu", NaN where the peak is unknown)."""
    secs = ms * 1e-3
    algo = fftconv_algo_flops(seqlen, b, h, gated=gated)
    mm = monarch_tensor_core_flops(seqlen, factors, b, h)
    peak = peak_flops(device)
    return {
        "gflops_algo": algo / secs / 1e9,
        "gflops_tensor_core": mm / secs / 1e9,
        "mfu": (mm / secs / peak) if peak else float("nan"),
    }


def flops_estimate(fn: Callable, *args) -> float:
    """FLOPs of one call of fn(*args) as ``torch.utils.flop_counter``
    counts them (matmuls, convolutions, attention)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())
