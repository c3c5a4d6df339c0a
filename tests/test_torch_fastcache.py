"""The port's native corpus cache (``data/fastcache.py`` over its own copy of
``eegcache.cpp``, built by ``_native.py``) against the JAX package's
``data/fastcache.py``: a file written by either package reads back bit for
bit through the other (f32 and uint8, whole and by rows, one thread and
several), misuse raises as JAX's does (a file that is no cache, an
unsupported dtype to write or on disk, a closed reader), and the library
builds under ``build/``, never into the repository's ``native/``.

The JAX library is built from a copy of the repository's ``native/`` in a
temporary directory, so these tests write nothing there."""

import os
import shutil
import struct

import numpy as np
import pytest

from imagined_speech_decoding_tpu import _native as jax_native
from imagined_speech_decoding_tpu.data import fastcache as jax_fastcache
from imagined_speech_decoding_tpu_torch import _native
from imagined_speech_decoding_tpu_torch.data import fastcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """The JAX ``fastcache`` module, its library built in a copy of ``native/``."""
    d = tmp_path_factory.mktemp("jax_native")
    for name in ("build.sh", "eegcache.cpp", "eegring.cpp", "isd_client.c"):
        shutil.copy(os.path.join(ROOT, "native", name), d)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "native_dir", lambda: str(d))
    mp.setattr(jax_fastcache, "_lib", None)
    if not jax_fastcache.available():
        mp.undo()
        pytest.fail("the JAX cache did not build from a copy of native/")
    yield jax_fastcache
    mp.undo()


def test_library_is_built_under_build_not_native():
    native_before = sorted(os.listdir(os.path.join(ROOT, "native")))
    path = _native.build("eegcache")
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "isd_torch_native")
    assert os.path.basename(path).startswith("libeegcache_") and os.path.isfile(path)
    assert fastcache.available()
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == native_before


def test_source_is_the_jax_packages_own():
    """The port's copy differs from ``native/eegcache.cpp`` in its header comment only."""
    with open(os.path.join(ROOT, "native", "eegcache.cpp")) as f:
        ref = f.read()
    with open(os.path.join(_native.NATIVE_SRC, "eegcache.cpp")) as f:
        ours = f.read()
    assert ours.split("#include", 1)[1] == ref.split("#include", 1)[1]


ARRAYS = {
    "f32": lambda: np.random.default_rng(0).normal(size=(7, 4, 50)).astype(np.float32),
    "u8": lambda: np.random.default_rng(1).integers(0, 5, (30,)).astype(np.uint8),
    "corpus": lambda: np.random.default_rng(2).normal(size=(64, 16, 100)).astype(np.float32),
}


@pytest.mark.parametrize("name", list(ARRAYS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_package_round_trip(jax_cache, tmp_path, name, writer):
    arr = ARRAYS[name]()
    path = str(tmp_path / "c.eegc")
    (fastcache if writer == "port" else jax_cache).write_cache(path, arr)
    reader = jax_cache if writer == "port" else fastcache
    with reader.FastCache(path) as c:
        assert c.shape == arr.shape and c.dtype == arr.dtype
        np.testing.assert_array_equal(c.read_all(), arr)
        np.testing.assert_array_equal(c.read_all(n_threads=1), arr)
        np.testing.assert_array_equal(c.read_all(n_threads=7), arr)
        np.testing.assert_array_equal(c.read_rows(2, 3), arr[2:5])
    with fastcache.FastCache(path) as c:  # and the writer's own package
        np.testing.assert_array_equal(c.read_all(), arr)


def test_files_are_byte_identical(jax_cache, tmp_path):
    arr = ARRAYS["f32"]()
    fastcache.write_cache(str(tmp_path / "a.eegc"), arr)
    jax_cache.write_cache(str(tmp_path / "b.eegc"), arr)
    assert (tmp_path / "a.eegc").read_bytes() == (tmp_path / "b.eegc").read_bytes()


def test_out_of_range_and_negative_rows(tmp_path):
    arr = np.arange(6 * 3 * 4, dtype=np.float32).reshape(6, 3, 4)
    path = fastcache.write_cache(str(tmp_path / "r.eegc"), arr)
    with fastcache.FastCache(path) as c:
        np.testing.assert_array_equal(c.read_rows(5, 1), arr[5:])
        with pytest.raises(IOError):
            c.read_rows(4, 5)
        with pytest.raises(ValueError, match="non-negative"):
            c.read_rows(-1, 2)


def test_bad_file_rejected(tmp_path):
    path = tmp_path / "junk.eegc"
    path.write_bytes(b"not a cache file at all........")
    with pytest.raises(IOError, match="cannot open"):
        fastcache.FastCache(str(path))


def test_bad_dtype_rejected(tmp_path):
    with pytest.raises(TypeError, match="unsupported dtype"):
        fastcache.write_cache(str(tmp_path / "x.eegc"), np.zeros(3, np.float64))


def test_unmapped_on_disk_dtype_rejected(tmp_path):
    """A bf16 file (dtype code 2, which the format defines) has no numpy
    mapping here: ``TypeError``, the handle closed."""
    path = tmp_path / "bf16.eegc"
    header = struct.pack("<IIII", 0x43474545, 1, 2, 1) + struct.pack("<8Q", 4, *([0] * 7))
    path.write_bytes(header + b"\0" * 8)
    with pytest.raises(TypeError, match="dtype code 2"):
        fastcache.FastCache(str(path))


def test_closed_reader_raises_not_segfaults(tmp_path):
    p = fastcache.write_cache(str(tmp_path / "c.eegc"), np.arange(12, dtype=np.float32).reshape(3, 4))
    fc = fastcache.FastCache(p)
    fc.close()
    fc.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fc.read_all()
    with pytest.raises(RuntimeError, match="closed"):
        fc.read_rows(0, 1)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: ``RuntimeError``, never a fallback."""
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "_loaded", {})
    assert not fastcache.available()
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        fastcache.write_cache("/nonexistent.eegc", np.zeros(3, np.float32))
