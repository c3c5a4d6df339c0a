"""The port's native acquisition ring (``ringbuf.py`` over its own copy of
``eegring.cpp``, built by ``_native.py``) against the JAX package's
``NativeRingBuffer`` and the numpy ring of the JAX ``StreamingDecoder``,
on the same pushes: snapshots and end indices equal exactly (the rings
copy samples; no arithmetic), misuse raises the same errors, and no
snapshot tears under a concurrent producer.

The JAX ring is built from a copy of the repository's ``native/`` in a
temporary directory, so these tests write nothing there."""

import os
import shutil
import threading

import numpy as np
import pytest

from imagined_speech_decoding_tpu import _native as jax_native
from imagined_speech_decoding_tpu import ringbuf as jax_ringbuf
from imagined_speech_decoding_tpu.serving import StreamingDecoder as JaxStreamingDecoder
from imagined_speech_decoding_tpu_torch import _native, ringbuf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ring(tmp_path_factory):
    """The JAX ``ringbuf`` module, its library built in a copy of ``native/``."""
    d = tmp_path_factory.mktemp("jax_native")
    for name in ("build.sh", "eegcache.cpp", "eegring.cpp", "isd_client.c"):
        shutil.copy(os.path.join(ROOT, "native", name), d)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "native_dir", lambda: str(d))
    mp.setattr(jax_ringbuf, "_lib", None)
    if not jax_ringbuf.native_available():
        mp.undo()
        pytest.fail("the JAX ring did not build from a copy of native/")
    yield jax_ringbuf
    mp.undo()


def _pattern(n_channels, start, n):
    """(C, n) chunk whose sample with global index g on channel c is the
    exactly representable float32 g + c/8."""
    g = np.arange(start, start + n, dtype=np.float32)
    return g[None, :] + np.arange(n_channels, dtype=np.float32)[:, None] / 8.0


def test_library_is_built_under_build_not_native():
    native_before = sorted(os.listdir(os.path.join(ROOT, "native")))
    path = _native.build("eegring")
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "isd_torch_native")
    assert os.path.basename(path).startswith("libeegring_") and os.path.isfile(path)
    assert ringbuf.native_available()
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == native_before


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: ``RuntimeError``, never a fallback."""
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "_loaded", {})
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        _native.load_native_lib("eegring")
    assert not ringbuf.native_available()


# (channels, capacity, window, chunk sizes): a round trip, wraparound, a chunk
# larger than the ring, ragged chunks that wrap at odd offsets.
PUSHES = {
    "roundtrip": (4, 32, 8, [10]),
    "wraparound": (2, 16, 16, [5] * 10),
    "oversized": (3, 16, 16, [100]),
    "ragged": (5, 64, 40, [7, 33, 1, 50, 129, 64, 3]),
}


@pytest.mark.parametrize("case", sorted(PUSHES))
def test_same_snapshots_as_the_jax_rings(jax_ring, case):
    channels, capacity, window, sizes = PUSHES[case]
    ours = ringbuf.NativeRingBuffer(channels, capacity)
    theirs = jax_ring.NativeRingBuffer(channels, capacity)
    numpy_ring = JaxStreamingDecoder(None, channels, window)
    start = 0
    try:
        for n in sizes:
            chunk = _pattern(channels, start, n)
            for ring in (ours, theirs, numpy_ring):
                ring.push(chunk)
            start += n
            assert ours.total_pushed == theirs.total_pushed == start
            assert ours.ready(window) == theirs.ready(window) == numpy_ring.ready
            if ours.ready(window):
                (a, end_a), (b, end_b) = ours.snapshot_latest(window), theirs.snapshot_latest(window)
                assert end_a == end_b == start
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, numpy_ring.buffer)
                np.testing.assert_array_equal(a, _pattern(channels, start - window, window))
    finally:
        ours.close()
        theirs.close()


MISUSE = {
    "too_few_samples": (RuntimeError, "need 8", lambda r: (r.push(_pattern(2, 0, 4)),
                                                           r.snapshot_latest(8))),
    "window_over_capacity": (ValueError, "capacity", lambda r: (r.push(_pattern(2, 0, 16)),
                                                                r.snapshot_latest(32))),
    "closed_push": (RuntimeError, "closed", lambda r: (r.close(), r.push(_pattern(2, 0, 4)))),
    "closed_snapshot": (RuntimeError, "closed", lambda r: (r.close(), r.snapshot_latest(8))),
    "wrong_channels": (ValueError, "expected", lambda r: r.push(_pattern(3, 0, 4))),
}


@pytest.mark.parametrize("case", sorted(MISUSE))
def test_misuse_raises_as_the_jax_ring(jax_ring, case):
    """A closed ring raises instead of handing the native code a NULL handle."""
    error, match, misuse = MISUSE[case]
    for module in (ringbuf, jax_ring):
        ring = module.NativeRingBuffer(2, 16)
        with pytest.raises(error, match=match):
            misuse(ring)
        ring.close()


def test_invalid_dimensions_raise():
    with pytest.raises(ValueError, match="invalid"):
        ringbuf.NativeRingBuffer(0, 16)


def test_monotonic_end_index():
    with ringbuf.NativeRingBuffer(2, 64) as ring:
        ring.push(_pattern(2, 0, 32))
        _, e1 = ring.snapshot_latest(16)
        ring.push(_pattern(2, 32, 8))
        _, e2 = ring.snapshot_latest(16)
        assert (e1, e2) == (32, 40)


def test_no_torn_snapshots_under_concurrent_push():
    """A producer thread streams the global-index pattern; every snapshot
    the consumer takes meanwhile must be one contiguous stretch of it (a
    torn copy would mix samples of two generations)."""
    n_channels, capacity, window, total = 4, 1024, 256, 100_000
    ring = ringbuf.NativeRingBuffer(n_channels, capacity)

    def produce():
        start, rng = 0, np.random.default_rng(0)
        while start < total:
            n = int(rng.integers(1, 64))
            ring.push(_pattern(n_channels, start, n))
            start += n

    producer = threading.Thread(target=produce)
    producer.start()
    checked = 0
    try:
        while producer.is_alive() or checked == 0:
            if not ring.ready(window):
                continue
            out, end = ring.snapshot_latest(window)
            np.testing.assert_array_equal(out, _pattern(n_channels, end - window, window))
            checked += 1
    finally:
        producer.join(timeout=60)
    assert not producer.is_alive()
    out, end = ring.snapshot_latest(window)
    assert end >= total
    np.testing.assert_array_equal(out, _pattern(n_channels, end - window, window))
    assert checked > 10, f"only {checked} concurrent snapshots exercised"
    ring.close()
