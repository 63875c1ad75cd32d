"""The native token reader of the port: ``tpunative.cpp`` (a copy of
``tpu_engine/native/tpunative.cpp``) built with ``g++`` at first use and
bound with ``ctypes``.

:func:`ensure_built` compiles the shared library into
``tpu_engine_torch/_build/`` under a name keyed on a hash of the source
(a build writes a temporary file and renames it, so concurrent builds do
not clash). A failed build is logged once and kept (:func:`build_error`);
``tpu_engine_torch.data`` then reads through its numpy reader and says so
(``data_fn.reader``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "tpunative.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed: Optional[str] = None


class _TnHostStats(ctypes.Structure):
    _fields_ = [
        ("mem_total_gb", ctypes.c_double),
        ("mem_available_gb", ctypes.c_double),
        ("load_1m", ctypes.c_double),
        ("load_5m", ctypes.c_double),
        ("n_cpus", ctypes.c_int64),
    ]


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libtpunative_{digest}.so")


def ensure_built(force: bool = False) -> Optional[str]:
    """Compile the library if it is not built yet; its path, or None after
    a failed build (the error in :func:`build_error`)."""
    global _build_failed
    lib = library_path()
    with _lock:
        if not force and os.path.exists(lib):
            return lib
        if _build_failed is not None and not force:
            return None
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            err = None if proc.returncode == 0 else proc.stderr[-2000:] or f"rc {proc.returncode}"
        except (OSError, subprocess.TimeoutExpired) as e:
            err = f"{type(e).__name__}: {e}"
        if err is not None:
            os.unlink(tmp)
            _build_failed = err
            log.warning("native token reader: g++ build failed, the numpy reader serves: %s", err)
            return None
        os.replace(tmp, lib)
        _build_failed = None
        return lib


def build_error() -> Optional[str]:
    """The last failed build's error, or None."""
    return _build_failed


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built()
    if path is None:
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(path)
            lib.tn_open.restype = ctypes.c_void_p
            lib.tn_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
            lib.tn_num_sequences.restype = ctypes.c_int64
            lib.tn_num_sequences.argtypes = [ctypes.c_void_p]
            lib.tn_num_tokens.restype = ctypes.c_int64
            lib.tn_num_tokens.argtypes = [ctypes.c_void_p]
            lib.tn_read_batch.restype = ctypes.c_int
            lib.tn_read_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ]
            lib.tn_prefetch_start.restype = ctypes.c_int
            lib.tn_prefetch_start.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.tn_next_batch.restype = ctypes.c_int
            lib.tn_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
            lib.tn_epoch.restype = ctypes.c_int64
            lib.tn_epoch.argtypes = [ctypes.c_void_p]
            lib.tn_close.restype = None
            lib.tn_close.argtypes = [ctypes.c_void_p]
            lib.tn_host_stats.restype = ctypes.c_int
            lib.tn_host_stats.argtypes = [ctypes.POINTER(_TnHostStats)]
            _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def host_stats() -> Optional[dict]:
    """Host memory and load from the native /proc probe; None without the
    library."""
    lib = load()
    if lib is None:
        return None
    st = _TnHostStats()
    if lib.tn_host_stats(ctypes.byref(st)) != 0:
        return None
    return {"mem_total_gb": round(st.mem_total_gb, 3),
            "mem_available_gb": round(st.mem_available_gb, 3),
            "load_1m": st.load_1m, "load_5m": st.load_5m, "n_cpus": int(st.n_cpus)}


class NativeTokenReader:
    """The native mmap reader: a flat file of uint16 (``dtype_code=2``) or
    int32 (``dtype_code=4``) token ids read as consecutive sequences of
    ``seq_len``."""

    def __init__(self, path: str, seq_len: int, dtype_code: int = 2):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error()}")
        self._lib = lib
        self.seq_len = int(seq_len)
        self._h = lib.tn_open(path.encode(), self.seq_len, dtype_code)
        if not self._h:
            raise FileNotFoundError(
                f"tn_open failed for {path!r} (missing file, bad seq_len, or "
                f"file smaller than one sequence)")
        self._prefetch_batch: Optional[int] = None

    @property
    def num_sequences(self) -> int:
        return int(self._lib.tn_num_sequences(self._h))

    @property
    def num_tokens(self) -> int:
        return int(self._lib.tn_num_tokens(self._h))

    @property
    def epoch(self) -> int:
        return int(self._lib.tn_epoch(self._h))

    def read_batch(self, indices: np.ndarray, n_threads: int = 4) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.seq_len), dtype=np.int32)
        rc = self._lib.tn_read_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
        if rc != 0:
            raise IndexError("tn_read_batch failed (index out of range?)")
        return out

    def start_prefetch(self, batch: int, seed: int = 0, shuffle: bool = True) -> None:
        rc = self._lib.tn_prefetch_start(self._h, batch, seed, int(shuffle))
        if rc != 0:
            raise ValueError("tn_prefetch_start failed (batch > num_sequences?)")
        self._prefetch_batch = int(batch)

    def next_batch(self) -> np.ndarray:
        if self._prefetch_batch is None:
            raise RuntimeError("call start_prefetch first")
        out = np.empty((self._prefetch_batch, self.seq_len), dtype=np.int32)
        rc = self._lib.tn_next_batch(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f"tn_next_batch failed (rc={rc})")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.tn_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
