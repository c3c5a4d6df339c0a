"""The port's HDF5 caches (``data/cache.py``) against the JAX package's: a
cache built by either package equals the other's in dataset names,
dtypes, compression, attributes and values; each package's loaders and
``manifest_check`` read the other's cache; the manifest refuses the same
short splits with the same message; missing splits are tolerated and a
``SchemaError`` never is; and without ``h5py`` a cache call raises
``ImportError`` naming the file."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from bcic_fixture import SUBJECTS, write_tree
from imagined_speech_decoding_tpu.data import cache as jax_cache
from imagined_speech_decoding_tpu.data import ingest as jax_ingest
from imagined_speech_decoding_tpu_torch.data import cache, ingest

torch.set_num_threads(1)

h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("bcic"))
    write_tree(base, SUBJECTS[:2], (6, 4, 50), seed=5)
    return base


def _datasets(path):
    """``{name: (dtype, shape, compression, values)}`` and the file's attrs."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, (o.dtype, o.shape, o.compression, o[()]))
                     if isinstance(o, h5py.Dataset) else None)
        attrs = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
    return out, attrs


def _assert_same_file(ours, ref):
    (d1, a1), (d2, a2) = _datasets(ours), _datasets(ref)
    assert sorted(d1) == sorted(d2)
    for name in d2:
        assert d1[name][:3] == d2[name][:3], name
        np.testing.assert_array_equal(d1[name][3], d2[name][3], err_msg=name)
    assert a1 == a2


@pytest.mark.parametrize("compression", ["gzip", None])
def test_official_cache_equals_jax(tree, tmp_path, compression):
    ours = cache.build_official_cache(tree, str(tmp_path / "port.h5"), compression=compression,
                                      verbose=False, strict=True)
    ref = jax_cache.build_official_cache(tree, str(tmp_path / "jax.h5"),
                                         compression=compression, verbose=False, strict=True)
    _assert_same_file(ours, ref)
    with h5py.File(ours, "r") as f:
        assert sorted(f) == ["X_test", "X_train", "X_valid", "Y_test", "Y_train", "Y_valid"]
        assert f["X_train"].shape == (12, 64, 800) and f["X_train"].dtype == np.float32
        assert f["Y_train"].dtype == np.uint8
        assert f.attrs["name"] == "BCIC2020Track3" and f.attrs["sfreq"] == 250


def test_each_package_reads_the_others_cache(tree, tmp_path):
    ours = cache.build_official_cache(tree, str(tmp_path / "port.h5"), verbose=False)
    ref = jax_cache.build_official_cache(tree, str(tmp_path / "jax.h5"), verbose=False)
    for path in (ours, ref):
        a, b = cache.load_official_h5(path), jax_cache.load_official_h5(path)
        assert list(a) == list(b) == ["train", "valid", "test"]
        for split in a:
            for u, v in zip(a[split], b[split]):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


def test_manifest_refuses_short_splits_like_jax(tree, tmp_path):
    """File checks do not count trials; only the manifest sees that the
    fixture's splits are short (12 train trials is no multiple of 300)."""
    ours = cache.build_official_cache(tree, str(tmp_path / "port.h5"), verbose=False,
                                      strict=True)
    ref = jax_cache.build_official_cache(tree, str(tmp_path / "jax.h5"), verbose=False,
                                         strict=True)
    for path in (ours, ref):
        errors = []
        for mod, err in ((cache, ingest.SchemaError), (jax_cache, jax_ingest.SchemaError)):
            with pytest.raises(err) as info:
                mod.manifest_check(path, verbose=False)
            errors.append(str(info.value))
        assert errors[0] == errors[1] and "split 'train' has X(12, 64, 800)" in errors[0]


def test_manifest_accepts_full_splits_from_either_package(tmp_path):
    """The documented trial counts (reshaped into a cache by hand: writing
    300 real-width trials a subject would cost the CPU tier too much)."""
    path = str(tmp_path / "full.h5")
    with h5py.File(path, "w") as f:
        for split, n in (("train", 300), ("valid", 50), ("test", 50)):
            f.create_dataset(f"X_{split}", shape=(n, 64, 800), dtype=np.float32)
            f.create_dataset(f"Y_{split}", data=np.zeros(n, np.uint8))
    assert cache.manifest_check(path, verbose=False) == jax_cache.manifest_check(path,
                                                                                 verbose=False)
    with h5py.File(path, "a") as f:
        del f["Y_valid"]
    errors = []
    for mod, err in ((cache, ingest.SchemaError), (jax_cache, jax_ingest.SchemaError)):
        with pytest.raises(err) as info:
            mod.manifest_check(path, verbose=False)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "no Y_valid" in errors[0]


@pytest.mark.parametrize("split,xs,ys", [
    ("train", (600, 64, 800), (600,)),
    ("valid", (12, 64, 800), (12,)),
    ("test", (50, 63, 800), (50,)),
    ("train", (300, 64, 795), (300,)),
    ("valid", (50, 64, 800), (49,)),
    ("test", (50, 64), (50,)),
])
def test_split_shape_rule_is_the_manifests(tmp_path, split, xs, ys):
    """``check_split_shape`` on shapes in memory (as ``chip_smoke.py``
    holds arrays to it) accepts and refuses what JAX's ``manifest_check``
    does on a cache of the same shapes, with the same message."""
    path = str(tmp_path / "one.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset(f"X_{split}", shape=xs, dtype=np.float32)
        f.create_dataset(f"Y_{split}", shape=ys, dtype=np.uint8)
    try:
        jax_cache.manifest_check(path, verbose=False)
        want = None
    except jax_ingest.SchemaError as e:
        want = str(e)
    try:
        cache.check_split_shape(path, split, xs, ys)
        got = None
    except ingest.SchemaError as e:
        got = str(e)
    assert got == want
    assert (want is None) == (xs == (600, 64, 800))


def test_subject_cache_equals_jax(tree, tmp_path):
    subjects = SUBJECTS[:2]
    ours = cache.build_subject_cache(tree, str(tmp_path / "port.h5"), subjects=subjects,
                                     verbose=False, strict=True)
    ref = jax_cache.build_subject_cache(tree, str(tmp_path / "jax.h5"), subjects=subjects,
                                        verbose=False, strict=True)
    _assert_same_file(ours, ref)
    for path in (ours, ref):
        for u, v, shape in zip(cache.load_standardized_h5(path, verbose=False),
                               jax_cache.load_standardized_h5(path, verbose=False),
                               ((2, 10, 64, 800), (2, 10))):
            assert u.dtype == v.dtype and u.shape == shape
            np.testing.assert_array_equal(u, v)
        errors = []
        for mod, err in ((cache, ingest.SchemaError), (jax_cache, jax_ingest.SchemaError)):
            with pytest.raises(err) as info:
                mod.manifest_check(path, verbose=False)
            errors.append(str(info.value))
        assert errors[0] == errors[1] and "subject 01 has X(10, 64, 800)" in errors[0]


def test_missing_split_is_tolerated_and_a_schema_error_is_not(tree, tmp_path, capsys):
    partial = str(tmp_path / "partial")
    shutil.copytree(tree, partial)
    shutil.rmtree(os.path.join(partial, "Validation set"))
    ours = cache.build_official_cache(partial, str(tmp_path / "port.h5"), verbose=False)
    ref = jax_cache.build_official_cache(partial, str(tmp_path / "jax.h5"), verbose=False)
    _assert_same_file(ours, ref)
    with h5py.File(ours, "r") as f:
        assert "X_valid" not in f and "X_train" in f
    assert "[warn] split 'valid' failed: FileNotFoundError" in capsys.readouterr().out

    import scipy.io

    bad = os.path.join(partial, "Training set", "Data_Sample01.mat")
    scipy.io.savemat(bad, {"epo_train": {"x": np.zeros((795, 60, 2)), "y": np.eye(5)[:, :2]}})
    for mod, err in ((cache, ingest.SchemaError), (jax_cache, jax_ingest.SchemaError)):
        with pytest.raises(err, match="60 channels"):
            mod.build_official_cache(partial, str(tmp_path / "bad.h5"), verbose=False,
                                     strict=True)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for mod in (cache, jax_cache):
        with pytest.raises(RuntimeError, match="all splits failed"):
            mod.build_official_cache(empty, str(tmp_path / "none.h5"), verbose=False)


def test_hdf5_without_h5py_raises_naming_the_file(tree, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = str(tmp_path / "port.h5")
    for call in (lambda: cache.build_official_cache(tree, path, verbose=False),
                 lambda: cache.build_subject_cache(tree, path, verbose=False),
                 lambda: cache.manifest_check(path), lambda: cache.load_official_h5(path),
                 lambda: cache.load_standardized_h5(path)):
        with pytest.raises(ImportError, match=f"{path}: reading or writing HDF5 needs h5py"):
            call()
    test_file = os.path.join(tree, "Test set", "Data_Sample01.mat")
    with pytest.raises(ImportError, match="Data_Sample01.mat: reading or writing HDF5"):
        ingest._load_mat73_test(test_file)
    # the v5 splits need scipy only
    x, y = ingest.load_subject_train_val(tree, "01", strict=True)
    assert x.shape == (10, 64, 800) and y.dtype == np.uint8
