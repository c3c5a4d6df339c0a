"""ctypes bindings for libeegring, the native acquisition ring buffer.

Counterpart of ``imagined_speech_decoding_tpu/ringbuf.py``, over the
port's own copy of the ring (``native/eegring.cpp`` in this package,
built by ``_native.py``): a lock-free single-producer ring that an
acquisition thread fills while the decode loop snapshots the latest
window, without the GIL serialising producer and consumer (the numpy
ring of ``serving.StreamingDecoder`` does). Snapshots are tear-checked;
the end index they return is monotonic; a closed ring raises instead of
handing the native code a NULL handle.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ._native import load_native_lib

_P, _U32, _U64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
_SIGNATURES = {
    # name: (argtypes, restype)
    "eegring_create": ([_U32, _U32], _P),
    "eegring_destroy": ([_P], None),
    "eegring_channels": ([_P], _U32),
    "eegring_capacity": ([_P], _U32),
    "eegring_total": ([_P], _U64),
    "eegring_push": ([_P, _P, _U64], None),
    "eegring_snapshot": ([_P, _P, _U64, ctypes.c_int], ctypes.c_longlong),
}


def _load_lib() -> ctypes.CDLL:
    lib = load_native_lib("eegring")
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def native_available() -> bool:
    """True if the native ring builds and loads on this host."""
    try:
        _load_lib()
        return True
    except RuntimeError:
        return False


class NativeRingBuffer:
    """Lock-free ``(C, capacity)`` sample ring; see the module docstring.

    ``push`` may be called from another thread than ``snapshot_latest``;
    snapshots are tear-checked and retried.
    """

    def __init__(self, n_channels: int, capacity: int):
        self._lib = _load_lib()
        self._ptr = self._lib.eegring_create(n_channels, capacity)
        if not self._ptr:
            raise ValueError("invalid ring dimensions")
        self.n_channels = n_channels
        self.capacity = capacity

    def _handle(self):
        """Guard every C call: the native code would dereference the NULL
        handle of a closed ring (a segfault, not an exception)."""
        if not self._ptr:
            raise RuntimeError("ring buffer is closed")
        return self._ptr

    def push(self, chunk: np.ndarray) -> None:
        """Append ``(C, n)`` samples (producer side)."""
        h = self._handle()
        chunk = np.ascontiguousarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[0] != self.n_channels:
            raise ValueError(f"expected ({self.n_channels}, n), got {chunk.shape}")
        self._lib.eegring_push(h, chunk.ctypes.data_as(ctypes.c_void_p), chunk.shape[1])

    @property
    def total_pushed(self) -> int:
        return int(self._lib.eegring_total(self._handle()))

    def ready(self, window: int) -> bool:
        return self.total_pushed >= window

    def snapshot_latest(self, window: int, max_retries: int = 64) -> tuple:
        """Copy the latest ``(C, window)`` samples.

        Returns ``(samples, end_index)``, ``end_index`` the global sample
        count at capture (monotonic: callers can detect duplicate or
        skipped windows). Raises if fewer than ``window`` samples were
        ever pushed, or if the producer outran the consumer
        ``max_retries`` times (a window too close to the capacity).
        """
        h = self._handle()
        if window > self.capacity:
            raise ValueError(f"window {window} exceeds ring capacity {self.capacity}")
        out = np.empty((self.n_channels, window), np.float32)
        rc = self._lib.eegring_snapshot(h, out.ctypes.data_as(ctypes.c_void_p), window,
                                        max_retries)
        if rc == -1:
            raise RuntimeError(f"ring has {self.total_pushed} samples; need {window}")
        if rc == -2:
            raise RuntimeError(
                f"snapshot torn {max_retries} times; enlarge capacity "
                f"(window {window} / capacity {self.capacity})"
            )
        return out, int(rc)

    def close(self) -> None:
        if self._ptr:
            self._lib.eegring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
