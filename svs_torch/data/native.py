"""The port's own loader of the C++ data runtime (``native/svs_native.cpp``),
through ctypes (the counterpart of ``svs_tpu/data/native.py``).

The source is the repository's; the shared library is the port's: it is
built with ``g++ -O3 -shared -fPIC -std=c++17 -lpthread`` into
``svs_torch/_build/`` (git-ignored) at first use, and again when the source
is newer, and nothing is ever written under ``native/``.  A build goes to a
temporary file first and is renamed into place, so processes that build at
once never load a half-written library.  :func:`available` is False when
there is no compiler, no source or a library of another ABI; callers with a
numpy path take it then, and ``PatchDataset(backend="native")`` raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_PATH = os.path.join(_ROOT, "native", "svs_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "svs_torch", "_build")
SO_PATH = os.path.join(BUILD_DIR, "libsvs_native.so")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()
_ABI = 2


def _build() -> bool:
    if not os.path.exists(SRC_PATH):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC_PATH, "-lpthread"],
                       check=True, capture_output=True, timeout=300)
        os.chmod(tmp, 0o755)
        os.replace(tmp, SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stale() -> bool:
    return not os.path.exists(SO_PATH) or (
        os.path.exists(SRC_PATH)
        and os.path.getmtime(SRC_PATH) > os.path.getmtime(SO_PATH))


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _stale() and not _build() and not os.path.exists(SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(SO_PATH)
        except OSError:
            return None
        p64 = ctypes.POINTER(ctypes.c_int64)
        pint = ctypes.POINTER(ctypes.c_int)
        pf = ctypes.POINTER(ctypes.c_float)
        lib.svs_open_npy.argtypes = [ctypes.c_char_p]
        lib.svs_open_npy.restype = ctypes.c_int
        lib.svs_npy_info.argtypes = [ctypes.c_int, p64, p64, pint]
        lib.svs_close_npy.argtypes = [ctypes.c_int]
        lib.svs_fill_batch.argtypes = [
            pint, pint, p64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, pf,
            pf, ctypes.c_int]
        lib.svs_fill_batch.restype = ctypes.c_int
        lib.svs_wav_info.argtypes = [ctypes.c_char_p, p64, pint, pint]
        lib.svs_wav_info.restype = ctypes.c_int
        lib.svs_read_wav_f32.argtypes = [ctypes.c_char_p, pf, ctypes.c_int64,
                                         ctypes.c_int]
        lib.svs_read_wav_f32.restype = ctypes.c_int
        lib.svs_native_abi_version.restype = ctypes.c_int
        if lib.svs_native_abi_version() != _ABI:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NpyHandle:
    """A ``.npy`` file mmap'd by the native registry."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native library is unavailable (no g++ "
                               "or no native/svs_native.cpp)")
        self._lib = lib
        self.handle = lib.svs_open_npy(path.encode())
        if self.handle < 0:
            raise OSError(f"svs_open_npy({path}) failed: {self.handle}")
        rows, cols, dt = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
        lib.svs_npy_info(self.handle, ctypes.byref(rows), ctypes.byref(cols),
                         ctypes.byref(dt))
        self.rows, self.cols = rows.value, cols.value
        self.dtype = "f4" if dt.value == 0 else "c8"

    def close(self):
        if self.handle >= 0:
            self._lib.svs_close_npy(self.handle)
            self.handle = -1

    def __del__(self):  # the registry's entry goes with the handle
        try:
            self.close()
        except Exception:
            pass


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def fill_batch(mag_handles: np.ndarray, phase_handles: Optional[np.ndarray],
               starts: np.ndarray, *, drop_dc: bool, out_len: int, rows: int,
               n_threads: int = 4
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(B, rows, out_len) magnitude (and phase-angle) batch buffers from
    native handles, cropped or zero-padded (and ``atan2f`` for angles) in
    C++ threads.  ``phase_handles=None`` fills magnitudes only and returns
    ``(mag, None)``: the dataset's path, which takes angles from its shared
    per-song cache so that every backend gives the same bits."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is unavailable")
    b = len(mag_handles)
    mag = np.empty((b, rows, out_len), np.float32)
    ang = (np.empty((b, rows, out_len), np.float32)
           if phase_handles is not None else None)
    mags = np.ascontiguousarray(mag_handles, np.int32)
    phases = (np.ascontiguousarray(phase_handles, np.int32)
              if phase_handles is not None else None)
    starts = np.ascontiguousarray(starts, np.int64)
    rc = lib.svs_fill_batch(
        _ptr(mags, ctypes.c_int),
        _ptr(phases, ctypes.c_int) if phases is not None else None,
        _ptr(starts, ctypes.c_int64), b, 1 if drop_dc else 0, out_len,
        _ptr(mag, ctypes.c_float),
        _ptr(ang, ctypes.c_float) if ang is not None else None, n_threads)
    if rc != 0:
        raise RuntimeError(f"svs_fill_batch failed: {rc}")
    return mag, ang


def read_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Native WAV decode -> (float32 (T,) or (C, T), sample rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is unavailable")
    frames, ch, sr = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = lib.svs_wav_info(path.encode(), ctypes.byref(frames),
                          ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise OSError(f"svs_wav_info({path}) failed: {rc}")
    n = frames.value if mono else frames.value * ch.value
    out = np.empty(n, np.float32)
    rc = lib.svs_read_wav_f32(path.encode(), _ptr(out, ctypes.c_float), n,
                              1 if mono else 0)
    if rc != 0:
        raise OSError(f"svs_read_wav_f32({path}) failed: {rc}")
    if not mono and ch.value > 1:
        out = out.reshape(frames.value, ch.value).T.copy()
    return out, sr.value
