"""ctypes bindings for the native (C++) host data path.

The reference's loaders/validators are native C (ref: src/cloudsc_c/cloudsc/
load_state.c, cloudsc_validate.c); this module is their equivalent around the
device compute path. The shared library is built lazily with g++ on first use and
cached next to the source; every entry point has a NumPy fallback so the
framework works without a compiler (CLOUDSC_NATIVE=0 forces the fallback).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_SO = _DIR / "libcloudsc_native.so"
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", str(_DIR)],
            check=True, capture_output=True, timeout=120,
        )
        return _SO.exists()
    except Exception:
        return False


def get_lib():
    """The loaded library, or None (disabled / no compiler)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("CLOUDSC_NATIVE", "1") == "0":
        _lib_failed = True
        return None
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        # always invoke make: it is a no-op when the library is current and
        # rebuilds when the source is newer (a stale binary built elsewhere
        # with -march=native could SIGILL at call time on this host)
        if not _build() and not _SO.exists():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            _lib_failed = True
            return None
        try:
            _bind(lib)
        except AttributeError:
            # a stale .so missing newer symbols (e.g. the build failed and
            # an old binary was loaded): honor the numpy-fallback contract
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def _bind(lib):
    """Declare argtypes for every exported symbol; raises AttributeError if
    the loaded binary predates any of them (caller falls back to numpy)."""
    i64, i32 = ctypes.c_int64, ctypes.c_int
    pd = ctypes.POINTER(ctypes.c_double)
    for suffix, cptr in (
        ("f64", ctypes.POINTER(ctypes.c_double)),
        ("f32", ctypes.POINTER(ctypes.c_float)),
        ("i32", ctypes.POINTER(ctypes.c_int32)),
        ("u8", ctypes.POINTER(ctypes.c_uint8)),
    ):
        for stem in ("cs_expand_", "cs_expand_grouped_"):
            fn = getattr(lib, f"{stem}{suffix}")
            fn.argtypes = [cptr, cptr, i64, i64, i64, i32]
            fn.restype = None
    for suffix, cptr in (
        ("f64", ctypes.POINTER(ctypes.c_double)),
        ("f32", ctypes.POINTER(ctypes.c_float)),
    ):
        fn = getattr(lib, f"cs_field_stats_{suffix}")
        fn.argtypes = [cptr, cptr, i64, i32, pd]
        fn.restype = None
    lib.cs_hardware_threads.restype = ctypes.c_int


_EXPAND = {
    np.dtype(np.float64): ("cs_expand_f64", ctypes.c_double),
    np.dtype(np.float32): ("cs_expand_f32", ctypes.c_float),
    np.dtype(np.int32): ("cs_expand_i32", ctypes.c_int32),
    np.dtype(np.bool_): ("cs_expand_u8", ctypes.c_uint8),
    np.dtype(np.uint8): ("cs_expand_u8", ctypes.c_uint8),
}


def expand_native(field: np.ndarray, ngptot: int, nthreads: int = 0,
                  grouped: bool = False):
    """Threaded tile of the trailing axis (cyclic, or grouped = each source
    column's copies contiguous); None if unavailable."""
    lib = get_lib()
    if lib is None or field.dtype not in _EXPAND:
        return None
    field = np.ascontiguousarray(field)
    name, ctype = _EXPAND[field.dtype]
    if grouped:
        name = name.replace("cs_expand_", "cs_expand_grouped_")
    klon = field.shape[-1]
    nrows = int(np.prod(field.shape[:-1], dtype=np.int64)) if field.ndim > 1 else 1
    dst = np.empty(field.shape[:-1] + (ngptot,), dtype=field.dtype)
    fn = getattr(lib, name)
    ptr = ctypes.POINTER(ctype)
    fn(field.ctypes.data_as(ptr), dst.ctypes.data_as(ptr),
       nrows, klon, ngptot, nthreads)
    return dst


def field_stats_native(field: np.ndarray, ref: np.ndarray, nthreads: int = 0):
    """(min, max, maxabserr, errsum, refsum) in one threaded pass; None if
    unavailable. The stat set mirrors VALIDATE (ref: validate_mod.F90:263-296)."""
    lib = get_lib()
    if lib is None:
        return None
    if field.dtype != ref.dtype or field.dtype not in (
        np.dtype(np.float64), np.dtype(np.float32)
    ):
        return None
    field = np.ascontiguousarray(field)
    ref = np.ascontiguousarray(ref)
    out = np.zeros(5, dtype=np.float64)
    name = "cs_field_stats_f64" if field.dtype == np.float64 else "cs_field_stats_f32"
    ctype = ctypes.c_double if field.dtype == np.float64 else ctypes.c_float
    ptr = ctypes.POINTER(ctype)
    fn = getattr(lib, name)
    fn(field.ctypes.data_as(ptr), ref.ctypes.data_as(ptr),
       field.size, nthreads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return tuple(out)
