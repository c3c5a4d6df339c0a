"""Raw dataset ingest: BCIC2020 Track #3 ``.mat`` files and the answer sheet.

Counterpart of ``imagined_speech_decoding_tpu/data/ingest.py`` with the
same loaders, schema checks and messages, restated without pandas. The
training and validation splits are MATLAB v5 files (``scipy.io.loadmat``)
holding ``epo_train`` / ``epo_validation`` structs with ``x (T, C, N)``
and one-hot ``y (K, N)``; the test split is MATLAB v7.3 (HDF5, read with
``h5py``) and its labels come from the competition's answer sheet
(``.xlsx``, read with the standard library, or a ``.csv`` export). Every
trial is edge-padded from 795 to ``TARGET_TIMEPOINTS`` (800) samples.

Everything here returns numpy ``(N, C, T)`` float32 arrays and uint8
labels on the host: ingest is file I/O and needs no device. ``scipy.io``
and ``h5py`` are imported inside the functions that open such files;
without ``h5py`` a v7.3 read raises ``ImportError`` naming the file.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .constants import Electrodes, SUBJECTS, TARGET_TIMEPOINTS

Arrays = Tuple[np.ndarray, np.ndarray]

#: Documented raw-file geometry: 795 samples a trial before the pad, 64
#: electrodes, 5 classes, and 300 train / 50 validation / 50 test trials a
#: subject. Strict mode fails loudly on a file that deviates.
RAW_TIMEPOINTS = 795
N_CLASSES = 5
SPLIT_TRIALS = {"epo_train": 300, "epo_validation": 50, "epo_test": 50}


class SchemaError(ValueError):
    """A raw dataset file deviates from the documented BCIC2020 schema
    (raised only with ``strict=True``)."""


def _check(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise SchemaError(f"{path}: {msg}")


def h5py_for(path: str):
    """The ``h5py`` module, or ``ImportError`` naming ``path`` when it is
    not installed (HDF5 files are the v7.3 test split and the caches)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path}: reading or writing HDF5 needs h5py, which is not "
                          "installed") from e
    return h5py


def _validate_v5_epochs(path: str, struct: str, x_disk, y_disk) -> None:
    """Strict checks on an on-disk v5 epoch struct: ``x (T, C, N)``, ``y
    (K, N)`` exactly one-hot, the documented electrode, sample and class
    counts. Trial totals are ``cache.manifest_check``'s job."""
    n_ch = len(Electrodes)
    _check(x_disk.ndim == 3, path,
           f"'{struct}.x' must be 3-D (T, C, N); got shape {x_disk.shape}")
    t, c, n = x_disk.shape
    _check(t in (RAW_TIMEPOINTS, TARGET_TIMEPOINTS), path,
           f"'{struct}.x' has {t} samples per trial; expected {RAW_TIMEPOINTS} "
           f"raw (or {TARGET_TIMEPOINTS} pre-padded)")
    _check(c == n_ch, path,
           f"'{struct}.x' has {c} channels; the documented montage has {n_ch} "
           f"electrodes")
    _check(y_disk.ndim == 2 and y_disk.shape == (N_CLASSES, n), path,
           f"'{struct}.y' must be one-hot ({N_CLASSES}, {n}); got shape "
           f"{getattr(y_disk, 'shape', None)}")
    y_num = np.asarray(y_disk, np.float64)
    ok = np.isin(y_num, (0.0, 1.0)).all() and (y_num.sum(axis=0) == 1.0).all()
    _check(ok, path,
           f"'{struct}.y' is not exactly-one-hot (each column must have a "
           f"single 1); label decoding via argmax would be silently wrong")


def _edge_pad_time(x: np.ndarray, target: int = TARGET_TIMEPOINTS) -> np.ndarray:
    """Edge-pad the trailing time axis of ``(N, C, T)`` up to ``target``."""
    t = x.shape[-1]
    if t >= target:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, target - t)], mode="edge")


def _load_mat_epochs(path: str, struct: str, strict: bool = False) -> Arrays:
    """One v5 ``.mat`` epoch struct -> ``(N, C, T)`` float32 and uint8
    labels; on disk ``x (T, C, N)`` and one-hot ``y (K, N)``."""
    import scipy.io

    data = scipy.io.loadmat(path)
    if strict and struct not in data:
        keys = [k for k in data if not k.startswith("__")]
        raise SchemaError(f"{path}: missing '{struct}' struct; file contains {keys}")
    node = data[struct]
    if strict:
        fields = getattr(node.dtype, "names", None) or ()
        _check("x" in fields and "y" in fields, path,
               f"'{struct}' struct must have 'x' and 'y' fields; got {list(fields)}")
    x = np.asarray(node["x"][0][0])
    y_disk = np.asarray(node["y"][0][0])
    if strict:
        _validate_v5_epochs(path, struct, x, y_disk)
    y = y_disk.argmax(0)
    x = np.transpose(x, (2, 1, 0)).astype(np.float32)
    return _edge_pad_time(x), y.astype(np.uint8)


def _load_mat73_test(path: str, strict: bool = False) -> np.ndarray:
    """A v7.3 test ``.mat`` -> ``(N, C, T)`` float32 (no labels inside)."""
    h5py = h5py_for(path)
    with h5py.File(path, "r") as f:
        if "epo_test" not in f:
            if strict:
                raise SchemaError(f"{path}: no 'epo_test' group; file contains "
                                  f"{sorted(f.keys())}")
            raise KeyError(f"{path}: no 'epo_test' group")
        if strict and "x" not in f["epo_test"]:
            raise SchemaError(f"{path}: 'epo_test' group has no 'x' dataset; contains "
                              f"{sorted(f['epo_test'].keys())}")
        x = np.array(f["epo_test"]["x"])
    if strict:
        _check(x.ndim == 3, path, f"'epo_test/x' must be 3-D (N, C, T); got shape {x.shape}")
        _, c, t = x.shape
        _check(t in (RAW_TIMEPOINTS, TARGET_TIMEPOINTS), path,
               f"'epo_test/x' has {t} samples per trial; expected "
               f"{RAW_TIMEPOINTS} raw (or {TARGET_TIMEPOINTS} pre-padded)")
        _check(c == len(Electrodes), path,
               f"'epo_test/x' has {c} channels; the documented montage has "
               f"{len(Electrodes)} electrodes")
    return _edge_pad_time(x.astype(np.float32))


def _read_xlsx_stdlib(path: str) -> List[list]:
    """The first worksheet of an OOXML ``.xlsx`` as a header-less grid of
    rows (``None`` for an empty cell), read with zipfile and ElementTree.
    Cells ``t`` of ``n`` (number, as float), ``s`` (shared string),
    ``str`` (formula-cached string) and ``inlineStr``."""
    import re
    import xml.etree.ElementTree as ET
    import zipfile

    m_ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"

    def q(tag):
        return f"{{{m_ns}}}{tag}"

    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        shared = []
        if "xl/sharedStrings.xml" in names:
            for si in ET.fromstring(z.read("xl/sharedStrings.xml")).iter(q("si")):
                shared.append("".join(t.text or "" for t in si.iter(q("t"))))
        sheets = sorted(n for n in names if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n))
        if not sheets:
            raise ValueError(f"{path}: no worksheets found")
        cells, max_r, max_c = {}, -1, -1
        for c in ET.fromstring(z.read(sheets[0])).iter(q("c")):
            ref = re.fullmatch(r"([A-Z]+)(\d+)", c.get("r", ""))
            if not ref:
                continue
            col = 0
            for ch in ref.group(1):
                col = col * 26 + (ord(ch) - 64)
            row, col = int(ref.group(2)) - 1, col - 1
            t, v = c.get("t", "n"), c.find(q("v"))
            if t == "inlineStr":
                is_el = c.find(q("is"))
                val = ("".join(tt.text or "" for tt in is_el.iter(q("t")))
                       if is_el is not None else None)
            elif v is None or v.text is None:
                val = None
            elif t == "s":
                val = shared[int(v.text)]
            elif t == "str":
                val = v.text
            else:
                val = float(v.text)
            if val is not None:
                cells[(row, col)] = val
                max_r, max_c = max(max_r, row), max(max_c, col)
    return [[cells.get((r, c)) for c in range(max_c + 1)] for r in range(max_r + 1)]


def _read_csv_grid(path: str) -> List[list]:
    """A header-less ``.csv`` sheet as a grid of rows, blank lines skipped
    and short rows padded with ``None`` (``pandas.read_csv(header=None)``'s
    shape)."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    width = max((len(r) for r in rows), default=0)
    return [[v if v != "" else None for v in r] + [None] * (width - len(r)) for r in rows]


def _number(v) -> float:
    """A sheet cell as a float, NaN where it is empty or not a number
    (``pandas.to_numeric(errors="coerce")``)."""
    if v is None:
        return math.nan
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return float(str(v).strip())
    except ValueError:
        return math.nan


def load_excel_labels(excel_path: str, n_subjects: int = len(SUBJECTS),
                      strict: bool = False) -> Dict[str, np.ndarray]:
    """Parse the competition answer sheet -> per-subject labels (0-4).

    Subject ``i`` (1-based) occupies column ``2*i``, rows 4-53 of the
    sheet, values 1-5. ``.xlsx`` is read by :func:`_read_xlsx_stdlib`
    (a sibling ``.csv`` export is the fallback if that fails); a ``.csv``
    path is read directly. A blank, non-numeric or out-of-range cell
    raises ``ValueError``."""
    csv_fallback = os.path.splitext(excel_path)[0] + ".csv"
    if excel_path.endswith(".csv"):
        grid = _read_csv_grid(excel_path)
    else:
        try:
            grid = _read_xlsx_stdlib(excel_path)
        except Exception:
            if not os.path.exists(csv_fallback):
                raise
            grid = _read_csv_grid(csv_fallback)
    n_cols = len(grid[0]) if grid else 0
    out: Dict[str, np.ndarray] = {}
    n_rows = SPLIT_TRIALS["epo_test"]
    for i in range(n_subjects):
        col = 2 * (i + 1)
        if col >= n_cols:
            if strict:
                raise SchemaError(
                    f"{excel_path}: answer sheet has only {n_cols} columns "
                    f"but subject {SUBJECTS[i]}'s labels live in column {col} "
                    f"(layout: subject i occupies column 2*i, rows 4-53)")
            raise IndexError(f"{excel_path}: column {col} is out of bounds ({n_cols} columns)")
        raw = np.array([_number(row[col]) for row in grid[3 : 3 + n_rows]], np.float64)
        if strict and raw.shape[0] != n_rows:
            raise SchemaError(
                f"{excel_path}: answer sheet column {col} (subject "
                f"{SUBJECTS[i]}) has {raw.shape[0]} label rows; the official "
                f"test split has {n_rows}")
        # Validate before the uint8 cast: a NaN or out-of-range value would
        # wrap to a fake class id.
        bad = ~np.isfinite(raw) | (raw < 1) | (raw > 5) | (raw != np.floor(raw))
        if bad.any():
            rows = (np.nonzero(bad)[0] + 4).tolist()  # 1-based sheet rows
            raise ValueError(
                f"answer sheet column {col} (subject {SUBJECTS[i]}) has "
                f"invalid label cells at sheet rows {rows[:10]} "
                f"(values must be integers 1-5)")
        out[SUBJECTS[i]] = (raw - 1).astype(np.uint8)
    return out


def _collect_split(base_folder: str, split: str, struct: str, verbose: bool = True,
                   strict: bool = False) -> Arrays:
    xs, ys = [], []
    folder = os.path.join(base_folder, split)
    for sid in SUBJECTS:
        path = os.path.join(folder, f"Data_Sample{sid}.mat")
        if not os.path.exists(path):
            continue
        x, y = _load_mat_epochs(path, struct, strict=strict)
        xs.append(x)
        ys.append(y)
        if verbose:
            print(f"  {split} S{sid}: {x.shape}")
    if not xs:
        raise FileNotFoundError(f"no subject files under {folder}")
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


def load_training_set(base_folder: str, verbose: bool = True, strict: bool = False) -> Arrays:
    """All subjects' official training trials, concatenated ``(N, C, T)``;
    missing subject files are skipped."""
    return _collect_split(base_folder, "Training set", "epo_train", verbose, strict)


def load_validation_set(base_folder: str, verbose: bool = True, strict: bool = False) -> Arrays:
    """All subjects' official validation trials, concatenated."""
    return _collect_split(base_folder, "Validation set", "epo_validation", verbose, strict)


def load_test_set(base_folder: str, excel_path: str, verbose: bool = True,
                  strict: bool = False) -> Arrays:
    """All subjects' official test trials and answer-sheet labels."""
    per_subject = load_test_set_per_subject(base_folder, excel_path, verbose, strict)
    xs = [per_subject[sid][0] for sid in SUBJECTS if sid in per_subject]
    ys = [per_subject[sid][1] for sid in SUBJECTS if sid in per_subject]
    if not xs:
        raise FileNotFoundError(f"no test files under {base_folder}")
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


def load_test_set_per_subject(base_folder: str, excel_path: str, verbose: bool = True,
                              strict: bool = False) -> Dict[str, Arrays]:
    """The official test split keyed by subject ID."""
    folder = os.path.join(base_folder, "Test set")
    labels = load_excel_labels(excel_path, strict=strict)
    out: Dict[str, Arrays] = {}
    for sid in SUBJECTS:
        path = os.path.join(folder, f"Data_Sample{sid}.mat")
        if not os.path.exists(path):
            continue
        x = _load_mat73_test(path, strict=strict)
        if strict and x.shape[0] != labels[sid].shape[0]:
            raise SchemaError(
                f"{path}: {x.shape[0]} test trials but the answer sheet has "
                f"{labels[sid].shape[0]} labels for subject {sid}")
        out[sid] = (x, labels[sid])
        if verbose:
            print(f"  Test S{sid}: {x.shape}")
    return out


def load_subject_train_val(base_folder: str, sid: str, strict: bool = False) -> Arrays:
    """One subject's training and validation trials merged (its CV pool)."""
    parts_x, parts_y = [], []
    for split, struct in (("Training set", "epo_train"), ("Validation set", "epo_validation")):
        path = os.path.join(base_folder, split, f"Data_Sample{sid}.mat")
        if os.path.exists(path):
            x, y = _load_mat_epochs(path, struct, strict=strict)
            parts_x.append(x)
            parts_y.append(y)
    if not parts_x:
        raise FileNotFoundError(f"no data for subject {sid} under {base_folder}")
    return np.concatenate(parts_x, axis=0), np.concatenate(parts_y, axis=0)


def resolve_data_folder(data_folder: str, extra_candidates: Optional[list] = None) -> str:
    """The raw-data folder, else ``BCIC2020Track3`` at the repository root."""
    candidates = [os.path.abspath(data_folder)]
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(repo_root, "BCIC2020Track3"))
    candidates.extend(extra_candidates or [])
    for path in candidates:
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"BCIC2020Track3 folder not found. Tried: {candidates}")


def resolve_excel_path(base_folder: str, excel_path: Optional[str] = None) -> str:
    """The answer sheet: ``excel_path``, else the dataset's own ``.xlsx``
    or ``.csv`` under ``Test set``."""
    candidates = []
    if excel_path:
        candidates.append(os.path.abspath(excel_path))
    candidates.append(os.path.join(base_folder, "Test set", "Track3_Answer Sheet_Test.xlsx"))
    candidates.append(os.path.join(base_folder, "Test set", "Track3_Answer Sheet_Test.csv"))
    for path in candidates:
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"Test answer sheet not found. Tried: {candidates}")
