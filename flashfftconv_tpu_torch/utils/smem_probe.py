"""Probe the card's shared memory a block, and copy through large tiles.

The port's counterpart of ``benchmarks/tpu_vmem_probe.py``, which finds the
largest VMEM scratch a TPU kernel can use and times a copy through large
VMEM blocks. On Hopper the fast memory a block owns is its shared memory
(at most 227 KB, above 48 KB only as opted-in dynamic shared memory), so
the two kernels of ``csrc/smem_probe.cu`` probe that:

  - ``smem_probe_touch(x, nbytes)``: one block with ``nbytes`` of dynamic
    shared memory writes x*2 to its first and x+1 to its last 8x128 floats
    and returns their sum (4 for ones). ``sweep`` tries the sizes of
    ``KB_GRID`` in order and stops at the first that the card refuses;
  - ``smem_copy(x, tile_bytes)``: o = x * 1.0001 through shared-memory
    tiles, timed with CUDA events at 16 KB, 64 KB and the largest working
    tile over 256 MiB of f32.

A refused size is a measurement, not a fault, when the error is the
expected one: the opt-in attribute call's ``cudaErrorInvalidValue``, or a
launch-configuration error that ``cudaGetLastError`` clears
(``SmemLimitError``). Any other error, or a wrong value at a size that
launched, fails the probe; after the sweep a working size is launched again
to show that the context is sound. On CPU tensors the wrappers run their
plain versions, ``touch_plain`` and ``copy_plain``.

Run on the card:

    python -m flashfftconv_tpu_torch.utils.smem_probe [--out FILE] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from flashfftconv_tpu_torch.ops import _build
from flashfftconv_tpu_torch.ops.monarch_cuda import _stream, on_cpu
from flashfftconv_tpu_torch.utils.benchmarking import benchmark_forward

KB_GRID = (16, 32, 48, 64, 96, 128, 160, 192, 224, 227, 228)
PROBE_SHAPE = (8, 128)
COPY_BYTES = 256 * 2**20
COPY_TILES_KB = (16, 64)  # and the largest working size
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# cudaError_t of a refused size: cudaErrorInvalidValue at the attribute call;
# cudaErrorInvalidConfiguration or cudaErrorLaunchOutOfResources at the launch.
ATTRIBUTE_ERRORS = frozenset({1})
LAUNCH_ERRORS = frozenset({9, 701})
ATTR_NAMES = ("max_shared_per_block_optin", "shared_per_sm", "shared_per_block_default",
              "registers_per_block", "registers_per_sm", "sm_count",
              "touch_registers_per_thread", "copy_registers_per_thread")


class SmemLimitError(RuntimeError):
    """A shared-memory size the card refused with an expected error."""

    def __init__(self, nbytes: int, stage: str, code: int, message: str):
        super().__init__(f"{nbytes} bytes refused at the {stage}: CUDA error {code} ({message})")
        self.nbytes, self.stage, self.code = nbytes, stage, code


def touch_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU trial kernel's function: x*2 + (x+1)."""
    return x * 2.0 + (x + 1.0)


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU copy kernel's function: x * 1.0001, one f32 multiply."""
    return torch.mul(x, 1.0001)


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_attrs(device="cuda") -> dict[str, int]:
    """The card's shared-memory and register limits (``ATTR_NAMES``): the
    opt-in and default shared memory a block, the shared memory, registers
    and count of the SMs, the registers a block, and the registers a thread
    of each probe kernel as compiled."""
    device = torch.device(device)
    lib = _build.load("smem_probe")
    out = (torch.zeros(len(ATTR_NAMES), dtype=torch.int32)).numpy()
    rc = lib.ffc_smem_device_attrs(out.ctypes.data, device.index or 0)
    _build.check(lib, rc, "cudaDeviceGetAttribute")
    return dict(zip(ATTR_NAMES, (int(v) for v in out)))


def smem_probe_touch(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """x*2 + (x+1) for x (8, 128) f32, through one block with ``nbytes`` of
    dynamic shared memory (the plain version on the CPU). Raises
    ``SmemLimitError`` if the card refuses the size."""
    if on_cpu(x):
        return touch_plain(x)
    _check("x", x)
    if tuple(x.shape) != PROBE_SHAPE:
        raise ValueError(f"x must be {PROBE_SHAPE}, got {tuple(x.shape)}")
    lib = _build.load("smem_probe")
    rc = lib.ffc_smem_set_limit(int(nbytes))
    if rc in ATTRIBUTE_ERRORS:
        raise SmemLimitError(nbytes, "attribute call", rc, lib.ffc_error_string(rc).decode())
    _build.check(lib, rc, "cudaFuncSetAttribute")
    out = torch.empty_like(x)
    rc = lib.ffc_smem_probe_touch(x.data_ptr(), out.data_ptr(), int(nbytes), _stream(x.device))
    if rc in LAUNCH_ERRORS:
        raise SmemLimitError(nbytes, "launch", rc, lib.ffc_error_string(rc).decode())
    _build.check(lib, rc, "smem_probe_touch kernel")
    smem_probe_touch.launches += 1
    return out


smem_probe_touch.launches = 0


def smem_copy(x: torch.Tensor, tile_bytes: int) -> torch.Tensor:
    """x * 1.0001 for f32 x (numel a multiple of 4), through shared-memory
    tiles of ``tile_bytes`` (the plain version on the CPU)."""
    if on_cpu(x):
        return copy_plain(x)
    _check("x", x)
    if x.numel() % 4 or x.data_ptr() % 16 or x.numel() >= 2**31:
        raise ValueError("x needs a numel that is a multiple of 4 (below 2^31) and 16-byte "
                         "alignment")
    out = torch.empty_like(x)
    lib = _build.load("smem_probe")
    rc = lib.ffc_smem_copy(x.data_ptr(), out.data_ptr(), x.numel(), int(tile_bytes),
                           _stream(x.device))
    _build.check(lib, rc, "smem_copy kernel")
    smem_copy.launches += 1
    return out


smem_copy.launches = 0


def grid_floor(nbytes: int, grid_kb=KB_GRID) -> int:
    """The largest size of the grid (in bytes) at or below nbytes, else 0."""
    return max((kb * 1024 for kb in grid_kb if kb * 1024 <= nbytes), default=0)


def sweep(trial, sizes_kb=KB_GRID) -> tuple[list[dict], int]:
    """Run ``trial(nbytes)`` on each size in order until the first
    ``SmemLimitError``, which ends the sweep as a measurement. A size that
    launched must return 4.0 everywhere (AssertionError otherwise); any
    other error propagates. Returns (one record a size tried, the largest
    working size in bytes)."""
    records, best = [], 0
    for kb in sizes_kb:
        nbytes = kb * 1024
        try:
            out = trial(nbytes)
        except SmemLimitError as e:
            records.append({"kb": kb, "bytes": nbytes, "ok": False, "stage": e.stage,
                            "error": e.code, "message": str(e)})
            break
        err = float((out.float() - 4.0).abs().max())
        records.append({"kb": kb, "bytes": nbytes, "ok": err == 0.0, "max_abs_err": err})
        if err != 0.0:
            raise AssertionError(f"{kb} KB of shared memory launched but returned values "
                                 f"{err} away from 4.0")
        best = nbytes
    return records, best


def run_probe(device="cuda", seed: int = 0, copy_bytes: int = COPY_BYTES, log=print) -> dict:
    """The whole probe on the card: the limits, the sweep, a second launch
    at the largest working size, then ``smem_copy`` at each tile against
    ``copy_plain`` (bit for bit) and timed beside ``torch.mul``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe measures the card: it needs a CUDA device")
    attrs = device_attrs(device)
    log(f"smem_probe: limits {json.dumps(attrs)}")
    x = torch.ones(PROBE_SHAPE, dtype=torch.float32, device=device)
    records, best = sweep(lambda nbytes: smem_probe_touch(x, nbytes))
    for rec in records:
        log(f"smem_probe: {json.dumps(rec)}")
    again = smem_probe_touch(x, best)
    torch.cuda.synchronize(device)
    if not torch.equal(again, touch_plain(x)):
        raise AssertionError("a second launch at the largest working size disagrees")
    expected = grid_floor(attrs["max_shared_per_block_optin"])
    log(f"smem_probe: largest working size {best} B ({best // 1024} KB); the opt-in attribute "
        f"{attrs['max_shared_per_block_optin']} B on the grid is {expected} B")
    if best != expected:
        raise AssertionError(f"largest working size {best} B != the opt-in attribute on the "
                             f"grid, {expected} B")
    g = torch.Generator(device="cpu").manual_seed(seed)
    src = torch.randn(copy_bytes // 4, generator=g).to(device)
    bound_ms = 2 * copy_bytes / HBM_BYTES_PER_S * 1e3
    library_ms = benchmark_forward(copy_plain, src, repeats=10, warmup=3, device=device)
    copies = {}
    for tile in [kb * 1024 for kb in COPY_TILES_KB] + [best]:
        out = smem_copy(src, tile)
        torch.cuda.synchronize(device)
        if not torch.equal(out, copy_plain(src)):
            raise AssertionError(f"smem_copy at {tile} B tiles differs from x * 1.0001")
        del out
        ms = benchmark_forward(smem_copy, src, tile, repeats=10, warmup=3, device=device)
        copies[tile] = {"tile_bytes": tile, "ms": ms, "gb_per_s": 2 * copy_bytes / ms / 1e6,
                        "bound_ms": bound_ms, "library_ms": library_ms, "max_abs_err": 0.0}
        log(f"smem_probe: smem_copy {copy_bytes >> 20} MiB f32 through {tile // 1024} KB tiles: "
            f"{ms:.4f} ms, {copies[tile]['gb_per_s']:.1f} GB/s (bound {bound_ms:.4f} ms, "
            f"torch.mul {library_ms:.4f} ms), equal to x * 1.0001 bit for bit")
    return {"device": torch.cuda.get_device_name(device), "attrs": attrs, "trials": records,
            "max_working_bytes": best, "expected_bytes": expected, "copy": copies}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="write the results as JSON to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("smem_probe: needs a CUDA device", file=sys.stderr)
        return 2
    res = run_probe("cuda", seed=args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res["nvidia_smi"] = smi
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"max_working_bytes": res["max_working_bytes"],
                      "copy_gb_per_s": {t: c["gb_per_s"] for t, c in res["copy"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
