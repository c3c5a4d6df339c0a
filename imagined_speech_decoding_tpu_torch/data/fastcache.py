"""ctypes bindings for libeegcache, the native binary corpus cache.

Counterpart of ``imagined_speech_decoding_tpu/data/fastcache.py``, over
the port's own copy of the library (``native/eegcache.cpp`` in this
package, built by ``_native.py`` into ``build/isd_torch_native/``): a
dependency-free binary tensor file (``'EEGC'`` magic, version, dtype,
dims, then the row-major payload) with multi-threaded reads, a faster
alternative to the HDF5 caches for the hot path. The file format is the
JAX package's, so each package reads the other's caches. A library that
does not build or load raises ``RuntimeError``; a closed reader raises
instead of handing the native code a NULL handle.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .._native import load_native_lib

_DTYPES = {np.dtype(np.float32): 0, np.dtype(np.uint8): 1}
_DTYPES_INV = {code: dt for dt, code in _DTYPES.items()}

_P, _U32, _U64, _INT = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    "eegcache_write": ([ctypes.c_char_p, _P, _U32, _U32, ctypes.POINTER(_U64)], _INT),
    "eegcache_open": ([ctypes.c_char_p], _P),
    "eegcache_close": ([_P], None),
    "eegcache_dtype": ([_P], _U32),
    "eegcache_ndim": ([_P], _U32),
    "eegcache_dims": ([_P, ctypes.POINTER(_U64)], None),
    "eegcache_read_all": ([_P, _P, _INT], _INT),
    "eegcache_read_rows": ([_P, _U64, _U64, _P, _INT], _INT),
}


def _load_lib() -> ctypes.CDLL:
    lib = load_native_lib("eegcache")
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def available() -> bool:
    """True if the native cache builds and loads on this host."""
    try:
        _load_lib()
        return True
    except RuntimeError:
        return False


def write_cache(path: str, array: np.ndarray) -> str:
    """Write a float32 or uint8 numpy tensor to a native cache file."""
    lib = _load_lib()
    arr = np.ascontiguousarray(array)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {arr.dtype}; use float32/uint8")
    dims = (_U64 * arr.ndim)(*arr.shape)
    rc = lib.eegcache_write(path.encode(), arr.ctypes.data_as(_P), _DTYPES[arr.dtype], arr.ndim,
                            dims)
    if rc != 0:
        raise IOError(f"eegcache_write({path}) failed with code {rc}")
    return path


class FastCache:
    """Reader handle over a native cache file (a context manager)."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.eegcache_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open cache {path}")
        code = self._lib.eegcache_dtype(self._h)
        if code not in _DTYPES_INV:
            self.close()  # no __del__ would free the C handle
            raise TypeError(f"cache {path} has on-disk dtype code {code} with no numpy mapping "
                            "on this reader (supported: float32, uint8)")
        self.dtype = _DTYPES_INV[code]
        ndim = self._lib.eegcache_ndim(self._h)
        dims = (_U64 * ndim)()
        self._lib.eegcache_dims(self._h, dims)
        self.shape: Tuple[int, ...] = tuple(int(d) for d in dims)

    def _handle(self):
        if not self._h:
            raise RuntimeError("cache reader is closed")
        return self._h

    def read_all(self, n_threads: int = 8) -> np.ndarray:
        h = self._handle()
        out = np.empty(self.shape, self.dtype)
        rc = self._lib.eegcache_read_all(h, out.ctypes.data_as(_P), n_threads)
        if rc != 0:
            raise IOError(f"eegcache_read_all failed with code {rc}")
        return out

    def read_rows(self, start: int, count: int, n_threads: int = 8) -> np.ndarray:
        h = self._handle()
        if start < 0 or count < 0:
            raise ValueError(f"start/count must be non-negative, got {start}/{count}")
        out = np.empty((count,) + self.shape[1:], self.dtype)
        rc = self._lib.eegcache_read_rows(h, start, count, out.ctypes.data_as(_P), n_threads)
        if rc != 0:
            raise IOError(f"eegcache_read_rows failed with code {rc}")
        return out

    def close(self):
        if self._h:
            self._lib.eegcache_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
