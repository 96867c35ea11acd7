"""The shared-memory probe (``utils/smem_probe.py``) and the benchmark
helpers (``utils/benchmarking.py``) of the port, on the CPU.

The TPU probe's kernels are closures inside ``main()`` of
``benchmarks/tpu_vmem_probe.py`` (``trial``'s body at l.46-50,
``copy_kernel`` at l.91-92) and cannot be imported, so the tests restate
their bodies here (a scratch written at its first and last (8, 128) rows
and read back; one multiply by 1.0001) and hold the port's plain versions
to them, bit for bit. The sweep's logic runs against a stub launcher that
refuses sizes above a set limit. The FLOP models are held to the JAX
package's formulas for the same arguments, exactly; the timers run with
``device="cpu"`` (host clock) and the memory probe reports NaN there;
``profile_trace`` writes the program's spans into its Chrome trace.
"""

import json
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashfftconv_tpu.utils import benchmarking as jbench
from flashfftconv_tpu_torch.utils import benchmarking as bench
from flashfftconv_tpu_torch.utils import smem_probe as sp
from flashfftconv_tpu_torch.utils import tracing

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CPU = "cpu"


def _tpu_trial_body(x: np.ndarray, rows: int) -> np.ndarray:
    """tpu_vmem_probe.py's trial kernel: scratch[0:8] = x*2,
    scratch[rows-8:rows] = x+1, o = scratch[0:8] + scratch[rows-8:rows]."""
    scratch = np.full((rows, 128), np.nan, np.float32)
    scratch[0:8, :] = x * np.float32(2.0)
    scratch[rows - 8 : rows, :] = x + np.float32(1.0)
    return scratch[0:8, :] + scratch[rows - 8 : rows, :]


@pytest.mark.parametrize("rows", [16, 4096])
def test_touch_plain_is_the_tpu_trial_kernel(rows):
    x = np.random.default_rng(rows).standard_normal(sp.PROBE_SHAPE).astype(np.float32)
    got = sp.touch_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tpu_trial_body(x, rows))
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x) * 2.0 + (jnp.asarray(x) + 1.0)), got)
    ones = torch.ones(sp.PROBE_SHAPE)
    assert torch.equal(sp.touch_plain(ones), torch.full(sp.PROBE_SHAPE, 4.0))


def test_copy_plain_is_the_tpu_copy_kernel():
    """o = x * 1.0001 in f32, bit for bit with numpy's and XLA's multiply."""
    x = np.random.default_rng(0).standard_normal(4096 * 4).astype(np.float32) * 100
    got = sp.copy_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x * np.float32(1.0001))
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x) * 1.0001))


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    x = torch.randn(sp.PROBE_SHAPE, generator=torch.Generator().manual_seed(1))
    n0, c0 = sp.smem_probe_touch.launches, sp.smem_copy.launches
    assert torch.equal(sp.smem_probe_touch(x, 300 * 1024), sp.touch_plain(x))
    y = torch.randn(1000)
    assert torch.equal(sp.smem_copy(y, 16 * 1024), sp.copy_plain(y))
    assert (sp.smem_probe_touch.launches, sp.smem_copy.launches) == (n0, c0)


SMEM_PROBE_CU = (Path(sp.__file__).resolve().parent.parent / "csrc" / "smem_probe.cu").read_text()


def _copy_walk(n: int, tile_bytes: int, slots: int, seed: int):
    """csrc/smem_probe.cu's smem_copy in Python: ffc_smem_copy's chunk size
    and grid for ``slots`` resident blocks, then the blocks' leaders run
    their walks one action at a time in an order drawn from ``seed``, all
    taking chunks from one counter as the kernel's atomicAdd does. Returns
    (chunk4, stage4, counter after the launch, {block: the leader's events
    ("load", chunk, stage), ("wait", ...), ("store", ...), ("read", ...)})."""
    stages, stage_bytes = sp.copy_stages(tile_bytes)
    n4, stage4 = n // 4, stage_bytes // 16
    rounds = -(-n4 // (slots * stage4))
    chunk4 = -(-n4 // (slots * rounds))
    chunk4 = -(-chunk4 // 64) * 64
    chunks = -(-n4 // chunk4)
    grid = min(chunks, slots)
    lag = 1 if stages > 2 else 0
    counter = [0, 0]
    events = {b: [] for b in range(grid)}

    def block(b):
        ids = {}

        def fetch(s):
            c = counter[0]
            counter[0] += 1
            ids[s] = c
            events[b].append(("load", c, s))

        for s in range(stages):
            fetch(s)
            yield
        j = 0
        while True:
            s = j % stages
            if ids[s] >= chunks:
                break
            events[b].append(("wait", ids[s], s))
            events[b].append(("store", ids[s], s))
            if j >= lag:
                r = (j - lag) % stages
                events[b].append(("read", ids[r], r))
                fetch(r)
            j += 1
            yield
        counter[1] += 1
        if counter[1] == grid:
            counter[0] = counter[1] = 0

    rng = np.random.default_rng(seed)
    live = {b: block(b) for b in range(grid)}
    while live:
        b = list(live)[rng.integers(len(live))]
        try:
            next(live[b])
        except StopIteration:
            del live[b]
    return chunk4, stage4, chunks, counter, events


@pytest.mark.parametrize("n,tile_kb,slots", [
    (256 * 2**18, 227, 132), (256 * 2**18, 64, 396), (256 * 2**18, 16, 1056),
    (3_000_004, 227, 132), (3_000_004, 16, 1056), (4, 227, 132), (14_332, 227, 132),
    (14_340, 16, 8), (1_000_000, 64, 3)])
def test_copy_walk_takes_each_float_once_through_a_free_stage(n, tile_kb, slots):
    """Whatever order the blocks ask in, the chunks taken cover x once, whole
    KB each but the last of x, at most a stage; a stage is loaded only when
    free (never loaded, or its last chunk waited on, multiplied, stored and
    read by its store), every block ends, and the counters are back at 0."""
    for seed in range(3):
        chunk4, stage4, chunks, counter, walks = _copy_walk(n, tile_kb * 1024, slots, seed)
        assert chunk4 % 64 == 0 and 0 < chunk4 <= stage4
        assert counter == [0, 0]
        covered = np.zeros(n // 4, np.int8)
        for events in walks.values():
            state = {}
            for kind, c, s in events:
                if kind == "load":
                    assert state.get(s, "read") == "read", (kind, c, s, state)
                    state[s] = "loaded" if c < chunks else "past the end"
                elif kind == "wait":
                    assert state[s] == "loaded"
                    covered[c * chunk4:(c + 1) * chunk4] += 1
                    state[s] = "multiplied"
                elif kind == "store":
                    assert state[s] == "multiplied"
                    state[s] = "stored"
                else:
                    assert state[s] == "stored"
                    state[s] = "read"
        assert (covered == 1).all()


def test_copy_constants_match_the_c_source():
    """copy_stages and _copy_walk restate csrc/smem_probe.cu: its kBarBytes,
    the stage count's choice, the whole-KB chunk, the refill lag and the
    counters' reset."""
    assert f"constexpr int kBarBytes = {sp.COPY_BARRIER_BYTES};" in SMEM_PROBE_CU
    assert "fetch((j - kLag) % S);" in SMEM_PROBE_CU
    assert "if (atomicAdd(&counter[1], 1u) == gridDim.x - 1) {" in SMEM_PROBE_CU
    assert "chunk4 = (chunk4 + 63) / 64 * 64;" in SMEM_PROBE_CU
    assert "constexpr int kLag = S > 2 ? 1 : 0;" in SMEM_PROBE_CU
    assert "stage_bytes % 1024" in SMEM_PROBE_CU
    assert sp.copy_stages(232448) == (4, 57344)
    assert sp.copy_stages(64 * 1024) == (4, 15360)
    assert sp.copy_stages(16 * 1024) == (2, 7168)
    for bad in (sp.COPY_MIN_TILE - 16, 16 * 1024 + 8):
        with pytest.raises(ValueError):
            sp.copy_stages(bad)


def test_grid_floor():
    assert sp.grid_floor(232448) == 227 * 1024
    assert sp.grid_floor(232447) == 224 * 1024
    assert sp.grid_floor(48 * 1024) == 48 * 1024
    assert sp.grid_floor(100) == 0
    assert sp.KB_GRID[-2:] == (227, 228)


class _Stub:
    """A launcher that refuses sizes above ``limit`` with the expected
    error of ``stage``, records the sizes it was asked for, and returns
    ``value`` everywhere (4, as the kernel does for ones)."""

    def __init__(self, limit, stage="attribute call", code=1, value=4.0, fault=None):
        self.limit, self.stage, self.code, self.value, self.fault = limit, stage, code, value, fault
        self.asked = []

    def __call__(self, nbytes):
        self.asked.append(nbytes)
        if self.fault is not None and nbytes >= self.fault[0]:
            raise self.fault[1]
        if nbytes > self.limit:
            raise sp.SmemLimitError(nbytes, self.stage, self.code, "refused")
        return torch.full(sp.PROBE_SHAPE, self.value)


@pytest.mark.parametrize("limit_kb,stage,code", [(227, "attribute call", 1), (100, "launch", 9),
                                                  (16, "launch", 701)])
def test_sweep_stops_at_the_first_refusal(limit_kb, stage, code):
    stub = _Stub(limit_kb * 1024, stage, code)
    records, best = sp.sweep(stub)
    assert best == sp.grid_floor(limit_kb * 1024)
    tried = [kb for kb in sp.KB_GRID if kb * 1024 <= best]
    first_refused = sp.KB_GRID[len(tried)]
    assert stub.asked == [kb * 1024 for kb in tried + [first_refused]]
    assert [r["ok"] for r in records] == [True] * len(tried) + [False]
    assert records[-1]["stage"] == stage and records[-1]["error"] == code


def test_sweep_fails_on_a_wrong_value_or_an_unexpected_error():
    with pytest.raises(AssertionError, match="away from 4.0"):
        sp.sweep(_Stub(227 * 1024, value=3.0))
    with pytest.raises(RuntimeError, match="illegal address"):
        sp.sweep(_Stub(227 * 1024, fault=(64 * 1024, RuntimeError("CUDA error 700 (an illegal "
                                                                  "memory access: illegal "
                                                                  "address)"))))
    records, best = sp.sweep(_Stub(0))
    assert best == 0 and len(records) == 1 and not records[0]["ok"]


def test_the_probe_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.run_probe(CPU)
    if not torch.cuda.is_available():
        assert sp.main([]) == 2


# --- benchmarking ----------------------------------------------------------------------

@pytest.mark.parametrize("seqlen,factors", [(256, (256,)), (16384, (128, 128)),
                                            (4096, (64, 64)), (131072, (4, 256, 128)),
                                            (2097152, (16, 4, 256, 128))])
@pytest.mark.parametrize("gated", [False, True])
def test_flop_models_are_the_jax_package_formulas(seqlen, factors, gated):
    assert bench.fftconv_algo_flops(seqlen, 4, 768, gated) == jbench.fftconv_algo_flops(
        seqlen, 4, 768, gated)
    assert bench.monarch_tensor_core_flops(seqlen, factors, 4, 768) == \
        jbench.monarch_mxu_flops(seqlen, factors, 4, 768)
    got = bench.conv_throughput(seqlen, factors, 4, 768, 2.0, gated, device=CPU)
    assert got["gflops_algo"] == pytest.approx(
        jbench.fftconv_algo_flops(seqlen, 4, 768, gated) / 2e-3 / 1e9)
    assert np.isnan(got["mfu"])  # no card, no peak


def test_peak_flops_is_none_off_the_card():
    assert bench.peak_flops(CPU) is None
    assert dict(bench._PEAK_FLOPS)["H100"][torch.bfloat16] == 989e12


def test_timers_and_memory_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    w = torch.randn(64, 64)
    f = lambda a, b: torch.tanh(a @ b)
    assert bench.benchmark_forward(f, x, w, repeats=3, warmup=1, device=CPU) > 0
    assert bench.benchmark_forward_amortized(f, x, w, length=4, repeats=2, device=CPU) > 0
    assert bench.benchmark_backward(f, x, w, argnums=(0, 1), repeats=2, device=CPU) > 0
    assert bench.benchmark_backward_amortized(f, x, w, length=3, repeats=2, device=CPU) > 0
    assert np.isnan(bench.benchmark_memory(f, x, w, device=CPU))
    assert bench.flops_estimate(lambda a, b: a @ b, torch.randn(8, 16), torch.randn(16, 4)) == \
        2 * 8 * 16 * 4
    with bench.profile_trace(str(tmp_path / "trace"), device=CPU) as prof:
        with tracing.span("model"):
            f(x, w)
    assert (tmp_path / "trace" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
    # the program's span over the kernels, on the trace's own clock
    with tracing.span("after"):  # tracing is off again after the block
        pass
    assert tracing.collect() == {"spans": [], "counters": {}}
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert [e["name"] for e in spans] == ["model"] and spans[0]["tid"] == threading.get_native_id()
    assert spans[0]["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= spans[0]["ts"] + spans[0]["dur"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.benchmark_forward(f, x, w)
