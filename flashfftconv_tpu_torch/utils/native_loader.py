"""ctypes bindings for the native threaded LM batch loader (``csrc/dataloader.cpp``).

Port of the JAX package's ``utils/native_loader.py`` over the same
framework-neutral C++ source: it memory-maps a token file, and a
background thread fills a ring of (input, target) next-token batches so
that batch assembly overlaps the device's steps. The data order is a
function of (seed, consumed-batch counter), so ``restore(counter)`` resumes
the stream exactly.

The library is built with ``g++`` at first use into the port's
``_build/`` directory (the one the CUDA kernels build into), its file name
carrying a hash of the source and the flags; the source tree is not
written. ``available()`` says whether it builds and loads here; callers
that find it unavailable read ``utils.data.lm_batches`` instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from flashfftconv_tpu_torch.ops._build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "csrc" / "dataloader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libffc_dataloader-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.stem + ".", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    target = library_path()
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_uint64, ctypes.c_int]
    lib.dl_next.restype = None
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.dl_state.restype = ctypes.c_uint64
    lib.dl_state.argtypes = [ctypes.c_void_p]
    lib.dl_restore.restype = None
    lib.dl_restore.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dl_num_tokens.restype = ctypes.c_int64
    lib.dl_num_tokens.argtypes = [ctypes.c_void_p]
    lib.dl_destroy.restype = None
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class NativeLMLoader:
    """Threaded, prefetching LM batch loader over a memory-mapped token file
    (bytes, or int32 tokens with ``is_int32``).

    ``next()`` returns numpy int32 (x, y), both (batch_size, seq_len), y one
    token after x. ``state()`` is the consumed-batch counter and
    ``restore(counter)`` resumes the exact data order from it."""

    def __init__(self, path: str, batch_size: int, seq_len: int, seed: int = 0,
                 is_int32: bool = False):
        lib = _load()
        self._lib = lib
        self._h = lib.dl_create(os.fsencode(path), batch_size, seq_len, seed, int(is_int32))
        if not self._h:
            raise OSError(f"dl_create failed for {path} (missing, or no longer than "
                          f"seq_len + 1 = {seq_len + 1} tokens)")
        self.batch_size = batch_size
        self.seq_len = seq_len

    @property
    def num_tokens(self) -> int:
        return self._lib.dl_num_tokens(self._h)

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        x = np.empty((self.batch_size, self.seq_len), np.int32)
        y = np.empty((self.batch_size, self.seq_len), np.int32)
        self._lib.dl_next(self._h, x.ctypes.data_as(ctypes.c_void_p),
                          y.ctypes.data_as(ctypes.c_void_p))
        return x, y

    def __iter__(self):
        while True:
            yield self.next()

    def state(self) -> int:
        return int(self._lib.dl_state(self._h))

    def restore(self, counter: int) -> None:
        self._lib.dl_restore(self._h, counter)

    def close(self) -> None:
        if self._h:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
