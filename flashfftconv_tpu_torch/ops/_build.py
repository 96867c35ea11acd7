"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. A build
happens at first use, into ``flashfftconv_tpu_torch/_build/``, from the
sources in this checkout only; the library's file name carries a hash of its
sources and flags, so an edited source is rebuilt. ``build_all`` starts one
``nvcc`` per source at once. A failed build raises with the compiler's
output; ``nvcc -Xptxas -v``'s register and shared-memory report is kept in
``_build/<lib>.log``. ``load`` declares the C signature of every function a
library exports (``SIGNATURES``), so that ctypes passes 64-bit pointers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("spectrum", "monarch_conv", "monarch_conv_bwd", "depthwise", "depthwise_bwd",
           "butterfly", "long_conv", "long_spectrum", "long_conv_bwd", "direct_conv",
           "band_conv", "flash_attn", "flash_attn_bwd", "splash_attn", "splash_attn_bwd",
           "smem_probe")
_P, _I = ctypes.c_void_p, ctypes.c_int
# {library: {function: argtypes}}; every function returns a CUDA error code
# (an int). Pointers first, then the int sizes, then the stream.
SIGNATURES = {
    "spectrum": {"ffc_spectrum": [_P] * 3 + [_I] * 3 + [_P]},
    "monarch_conv": {"ffc_monarch_conv": [_P] * 6 + [_I] * 5 + [_P]},
    "monarch_conv_bwd": {"ffc_monarch_conv_bwd": [_P] * 11 + [_I] * 6 + [_P],
                         "ffc_dk_finish": [_P] * 5 + [_I] * 8 + [_P]},
    "depthwise": {"ffc_depthwise": [_P] * 4 + [_I] * 8 + [_P]},
    "depthwise_bwd": {"ffc_depthwise_bwd": [_P] * 7 + [_I] * 8 + [_P],
                      "ffc_depthwise_bwd_tiles": [_I] * 2},
    "butterfly": {"ffc_butterfly_fwd": [_P] * 4 + [_I] * 5 + [_P],
                  "ffc_butterfly_inv": [_P] * 4 + [_I] * 5 + [_P]},
    "long_conv": {"ffc_long_conv": [_P] * 5 + [_I] * 4 + [_P]},
    "long_spectrum": {"ffc_long_spectrum": [_P] * 6 + [_I] * 7 + [_P]},
    "long_conv_bwd": {"ffc_long_conv_bwd": [_P] * 8 + [_I] * 4 + [_P],
                      "ffc_long_dk_finish": [_P] * 4 + [_I] * 4 + [_P]},
    "direct_conv": {"ffc_direct_conv": [_P] * 6 + [_I] * 5 + [_P]},
    "band_conv": {"ffc_band_conv": [_P] * 4 + [_I] * 4 + [_P]},
    "flash_attn": {"ffc_flash_attn_fwd": [_P] * 7 + [_I] * 10 + [_P]},
    "flash_attn_bwd": {"ffc_flash_attn_bwd_dkv": [_P] * 10 + [_I] * 10 + [_P],
                       "ffc_flash_attn_bwd_dq": [_P] * 10 + [_I] * 10 + [_P]},
    "splash_attn": {"ffc_splash_attn_fwd": [_P] * 7 + [_I] * 11 + [_P]},
    "splash_attn_bwd": {"ffc_splash_attn_bwd_dkv": [_P] * 10 + [_I] * 11 + [_P],
                        "ffc_splash_attn_bwd_dq": [_P] * 9 + [_I] * 11 + [_P]},
    "smem_probe": {"ffc_smem_device_attrs": [_P, _I], "ffc_smem_set_limit": [_I],
                   "ffc_smem_probe_touch": [_P, _P, _I, _P],
                   "ffc_smem_copy": [_P, _P, _P, _I, _I, _I, _I, _P]},
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, for the current sources."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; have {SOURCES}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cuh")) + [SOURCE_DIR / f"{name}.cu"]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, target: Path) -> tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.stem + ".", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    log = target.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE_DIR / f"{name}.cu")]
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n")
        f.flush()
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=SOURCE_DIR)
    return proc, Path(tmp), log


def build_all(names=SOURCES) -> dict[str, Path]:
    """Build every named library that is not built yet, one nvcc per source,
    all started together. Returns {name: library path}."""
    targets = {n: library_path(n) for n in names}
    jobs = {n: _start(n, t) for n, t in targets.items() if not t.exists()}
    failed = []
    for n, (proc, tmp, log) in jobs.items():
        if proc.wait() != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- nvcc {n}.cu failed:\n{log.read_text()}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's register report) for the current build of name."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        lib.ffc_error_string.argtypes = [ctypes.c_int]
        lib.ffc_error_string.restype = ctypes.c_char_p
        for fname, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.ffc_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
