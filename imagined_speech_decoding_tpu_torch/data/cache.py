"""HDF5 caches of the raw dataset, in the JAX package's layout.

Counterpart of ``imagined_speech_decoding_tpu/data/cache.py``, with the
same dataset names, dtypes, compression and attributes, so that each
package reads the other's caches:

1. **Per-subject groups** ``{SID}/X (N, C, T)``, ``{SID}/Y (N,)``:
   ``build_subject_cache`` (each subject's train and validation trials
   merged, read on a thread pool).
2. **Official splits** ``X_train``, ``Y_train``, ``X_valid``, ``Y_valid``,
   ``X_test``, ``Y_test`` with the dataset's metadata as attributes:
   ``build_official_cache``.

``h5py`` is imported inside each function; without it a read or write
raises ``ImportError`` naming the file.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from . import ingest
from .constants import CLASSES, Electrodes, NAME, SFREQ, SUBJECTS, TARGET_TIMEPOINTS

OFFICIAL_SPLIT_TRIALS = {  # trials a subject in each official split
    "train": ingest.SPLIT_TRIALS["epo_train"],
    "valid": ingest.SPLIT_TRIALS["epo_validation"],
    "test": ingest.SPLIT_TRIALS["epo_test"],
}


def build_subject_cache(src_folder: str, out_path: str, subjects: Tuple[str, ...] = SUBJECTS,
                        max_workers: int = 8, verbose: bool = True, strict: bool = False,
                        timings: Optional[dict] = None) -> str:
    """Merge each subject's train and validation trials; write one group a
    subject. ``timings``, if given, receives the host seconds of the
    ingest (``ingest_s``) and of the write (``write_s``)."""
    h5py = ingest.h5py_for(out_path)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    def one(sid: str):
        x, y = ingest.load_subject_train_val(src_folder, sid, strict=strict)
        return sid, x, y

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(one, subjects))
    t1 = time.perf_counter()
    with h5py.File(out_path, "w") as f:
        for sid, x, y in results:
            f.create_dataset(f"{sid}/X", data=x)
            f.create_dataset(f"{sid}/Y", data=y)
            if verbose:
                print(f"  cached S{sid}: {x.shape} {np.bincount(y)}")
    if timings is not None:
        timings.update(ingest_s=t1 - t0, write_s=time.perf_counter() - t1)
    return out_path


def build_official_cache(src_folder: str, out_path: str, excel_path: Optional[str] = None,
                         compression: Optional[str] = "gzip", verbose: bool = True,
                         strict: bool = False, timings: Optional[dict] = None) -> str:
    """One HDF5 file with the three official splits and the metadata attrs.

    A split that fails to load is skipped with a warning, and the build
    fails only if none loads; a ``SchemaError`` (a present file that
    deviates) is never tolerated. ``timings``, if given, receives the
    host seconds of the ingest (``ingest_s``) and of the write
    (``write_s``)."""
    h5py = ingest.h5py_for(out_path)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    splits = {}
    loaders = {
        "train": lambda: ingest.load_training_set(src_folder, verbose, strict=strict),
        "valid": lambda: ingest.load_validation_set(src_folder, verbose, strict=strict),
        "test": lambda: ingest.load_test_set(
            src_folder, ingest.resolve_excel_path(src_folder, excel_path), verbose,
            strict=strict),
    }
    t0 = time.perf_counter()
    for name, fn in loaders.items():
        try:
            splits[name] = fn()
        except ingest.SchemaError:
            raise
        except Exception as e:  # noqa: BLE001 -- tolerance covers missing data only
            print(f"  [warn] split {name!r} failed: {type(e).__name__}: {e}")
    if not splits:
        raise RuntimeError("all splits failed to load — nothing to cache")

    t1 = time.perf_counter()
    with h5py.File(out_path, "w") as f:
        for name, (x, y) in splits.items():
            f.create_dataset(f"X_{name}", data=x, compression=compression)
            f.create_dataset(f"Y_{name}", data=y, compression=compression)
        f.attrs["n_subjects"] = len(SUBJECTS)
        f.attrs["classes"] = list(CLASSES)
        f.attrs["electrodes"] = list(Electrodes)
        f.attrs["sfreq"] = SFREQ
        f.attrs["name"] = NAME
    if timings is not None:
        timings.update(ingest_s=t1 - t0, write_s=time.perf_counter() - t1)
    return out_path


def check_split_shape(where: str, split: str, xs: tuple, ys: tuple) -> None:
    """The manifest's rule for the official split ``split`` (train, valid
    or test) held in ``where``: ``X`` of shape ``xs`` must be ``(k *
    split_trials, 64, 800)`` and ``Y`` of shape ``ys`` ``(k *
    split_trials,)``. Raises ``ingest.SchemaError`` otherwise."""
    n_per, n_ch = OFFICIAL_SPLIT_TRIALS[split], len(Electrodes)
    if (len(xs) != 3 or xs[0] % n_per or xs[1] != n_ch
            or xs[2] != TARGET_TIMEPOINTS or tuple(ys) != (xs[0],)):
        raise ingest.SchemaError(
            f"{where}: split {split!r} has X{tuple(xs)} / "
            f"Y{tuple(ys)}; expected (k*{n_per}, {n_ch}, "
            f"{TARGET_TIMEPOINTS}) with matching Y")


def manifest_check(cache_path: str, verbose: bool = True) -> Dict[str, tuple]:
    """Validate a built cache against the documented per-split manifest.

    Official splits: each ``X_{split}`` must be ``(k * split_trials, 64,
    800)`` with a matching ``Y``. Per-subject groups: ``(n, 64, 800)`` with
    n one of 300, 50 or 350 (a missing split is incomplete, not wrong).
    Returns ``{dataset: shape}``; raises ``ingest.SchemaError`` otherwise.
    """
    h5py = ingest.h5py_for(cache_path)
    n_ch = len(Electrodes)
    shapes: Dict[str, tuple] = {}
    with h5py.File(cache_path, "r") as f:
        if any(f"X_{s}" in f for s in OFFICIAL_SPLIT_TRIALS):
            for split in OFFICIAL_SPLIT_TRIALS:
                if f"X_{split}" not in f:
                    continue
                if f"Y_{split}" not in f:
                    raise ingest.SchemaError(
                        f"{cache_path}: split {split!r} has X_{split} but no Y_{split}")
                xs, ys = f[f"X_{split}"].shape, f[f"Y_{split}"].shape
                shapes[f"X_{split}"], shapes[f"Y_{split}"] = xs, ys
                check_split_shape(cache_path, split, xs, ys)
        else:
            n_tr, n_va = OFFICIAL_SPLIT_TRIALS["train"], OFFICIAL_SPLIT_TRIALS["valid"]
            allowed = {n_tr, n_va, n_tr + n_va}
            for sid in sorted(f.keys()):
                g = f[sid]
                if "X" not in g or "Y" not in g:
                    raise ingest.SchemaError(
                        f"{cache_path}: subject {sid} group must have X and "
                        f"Y; contains {sorted(g.keys())}")
                xs, ys = g["X"].shape, g["Y"].shape
                shapes[f"{sid}/X"], shapes[f"{sid}/Y"] = xs, ys
                if (len(xs) != 3 or xs[0] not in allowed or xs[1] != n_ch
                        or xs[2] != TARGET_TIMEPOINTS or ys != (xs[0],)):
                    raise ingest.SchemaError(
                        f"{cache_path}: subject {sid} has X{tuple(xs)} / "
                        f"Y{tuple(ys)}; expected (n, {n_ch}, "
                        f"{TARGET_TIMEPOINTS}) with n in {sorted(allowed)} "
                        f"and matching Y")
    if verbose:
        for k, v in shapes.items():
            print(f"  manifest OK: {k} {tuple(v)}")
    return shapes


def load_standardized_h5(cache_path: str, verbose: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """A per-subject cache -> ``(S, N, C, T)`` float32 and ``(S, N)``
    labels, subjects in sorted key order."""
    h5py = ingest.h5py_for(cache_path)
    xs, ys = [], []
    with h5py.File(cache_path, "r") as f:
        for sid in sorted(f.keys()):
            xs.append(f[sid]["X"][()])
            ys.append(f[sid]["Y"][()])
    x, y = np.asarray(xs), np.asarray(ys)
    if verbose:
        print(f"loaded {cache_path}: X{x.shape} Y{y.shape}")
    return x, y


def load_official_h5(cache_path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """An official-splits cache -> ``{split: (X, Y)}``."""
    h5py = ingest.h5py_for(cache_path)
    out = {}
    with h5py.File(cache_path, "r") as f:
        for name in ("train", "valid", "test"):
            if f"X_{name}" in f:
                out[name] = (f[f"X_{name}"][()], f[f"Y_{name}"][()])
    return out
