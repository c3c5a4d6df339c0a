"""A BCIC2020 Track #3 raw tree at the documented schema, for tests and the
card's smoke run (no dataset ships with the repository).

``write_tree`` writes, under a base folder::

    Training set/Data_Sample<SID>.mat     v5, struct epo_train: x (T, C, N), one-hot y (5, N)
    Validation set/Data_Sample<SID>.mat   v5, struct epo_validation
    Test set/Data_Sample<SID>.mat         v7.3 (HDF5 with MATLAB's 512-byte header),
                                          group epo_test, dataset x stored as (N, C, T)
    Test set/Track3_Answer Sheet_Test.xlsx and .csv
                                          subject i's labels 1-5 in column 2*i, rows 4-53

Trials are unit Gaussian noise plus a class-dependent sinusoid (6 + 4k Hz
for class k, a phase a channel), so that a model can learn them. Imports
numpy, scipy and h5py (the v7.3 files), nothing of either package.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Sequence, Tuple

import numpy as np

SUBJECTS = tuple(f"{i:02d}" for i in range(1, 16))
SPLITS = (("Training set", "epo_train"), ("Validation set", "epo_validation"),
          ("Test set", "epo_test"))
N_CLASSES = 5
ANSWER_ROWS = 50  # the answer sheet's rows a subject
SHEET = "Track3_Answer Sheet_Test"


def class_templates(n_channels: int, t_raw: int, amplitude: float = 0.5) -> np.ndarray:
    """``(5, C, T)`` float32: class k's sinusoid at 6 + 4k Hz (250 Hz
    sampling), one phase a channel."""
    t = np.arange(t_raw) / 250.0
    phase = np.linspace(0.0, np.pi, n_channels)[:, None]
    return np.stack([amplitude * np.sin(2 * np.pi * (6 + 4 * k) * t + phase)
                     for k in range(N_CLASSES)]).astype(np.float32)


def trials(rng: np.random.Generator, labels: np.ndarray, templates: np.ndarray,
           dtype=np.float32) -> np.ndarray:
    """``(N, C, T)`` trials of ``labels``: noise plus each label's template."""
    n = len(labels)
    x = rng.standard_normal((n,) + templates.shape[1:], dtype=np.float32)
    x += templates[labels]
    return x.astype(dtype, copy=False)


def write_mat_v5(path: str, struct: str, x: np.ndarray, labels: np.ndarray) -> None:
    """A v5 ``.mat`` with the competition's layout: ``x (T, C, N)`` and
    one-hot ``y (5, N)``."""
    import scipy.io

    y = np.eye(N_CLASSES)[labels].T
    scipy.io.savemat(path, {struct: {"x": np.transpose(x, (2, 1, 0)), "y": y}})


def write_mat73(path: str, x: np.ndarray) -> None:
    """What MATLAB's ``save -v7.3`` writes for ``epo_test.x`` of MATLAB
    shape (T, C, N): a 512-byte user block with the MAT-file text header,
    version 0x0200 and the 'IM' endian marker; ``epo_test`` a group with
    ``MATLAB_class`` struct; ``x`` with its dimensions reversed, i.e.
    ``(N, C, T)`` in h5py's row-major view."""
    import h5py

    cls = {np.dtype(np.float64): "double", np.dtype(np.float32): "single"}[x.dtype]
    with h5py.File(path, "w", userblock_size=512) as f:
        g = f.create_group("epo_test")
        g.attrs["MATLAB_class"] = np.bytes_("struct")
        d = g.create_dataset("x", data=x)
        d.attrs["MATLAB_class"] = np.bytes_(cls)
    header = ("MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: Wed Aug 19 "
              "00:00:00 2026 HDF5 schema 1.00 .").encode()
    block = header[:116].ljust(116, b" ") + b"\x00" * 8
    block += (0x0200).to_bytes(2, "little") + b"IM"
    with open(path, "r+b") as fo:
        fo.write(block.ljust(512, b"\x00"))


def _col_name(c: int) -> str:
    s = ""
    c += 1
    while c:
        c, r = divmod(c - 1, 26)
        s = chr(65 + r) + s
    return s


def write_xlsx(path: str, grid) -> None:
    """An OOXML ``.xlsx`` workbook of one sheet, written with the standard
    library: numeric cells ``t="n"``, text cells ``inlineStr``."""
    rows_xml = []
    for r, row in enumerate(grid):
        cells = []
        for c, val in enumerate(row):
            if val is None or val == "":
                continue
            ref = f"{_col_name(c)}{r + 1}"
            try:
                float(val)
                cells.append(f'<c r="{ref}"><v>{val}</v></c>')
            except (TypeError, ValueError):
                cells.append(f'<c r="{ref}" t="inlineStr"><is><t>{val}</t></is></c>')
        rows_xml.append(f'<row r="{r + 1}">{"".join(cells)}</row>')
    m = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    rel = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
    pkg = "http://schemas.openxmlformats.org/package/2006/relationships"
    head = '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    sheet = f'{head}<worksheet xmlns="{m}"><sheetData>{"".join(rows_xml)}</sheetData></worksheet>'
    workbook = (f'{head}<workbook xmlns="{m}" xmlns:r="{rel}"><sheets>'
                '<sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>')
    wb_rels = (f'{head}<Relationships xmlns="{pkg}"><Relationship Id="rId1" '
               f'Type="{rel}/worksheet" Target="worksheets/sheet1.xml"/></Relationships>')
    root_rels = (f'{head}<Relationships xmlns="{pkg}"><Relationship Id="rId1" '
                 f'Type="{rel}/officeDocument" Target="xl/workbook.xml"/></Relationships>')
    ct = "application/vnd.openxmlformats-officedocument.spreadsheetml"
    content_types = (
        f'{head}<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType='
        '"application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        f'<Override PartName="/xl/workbook.xml" ContentType="{ct}.sheet.main+xml"/>'
        f'<Override PartName="/xl/worksheets/sheet1.xml" ContentType="{ct}.worksheet+xml"/>'
        "</Types>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def answer_grid(labels_per_subject: Sequence[np.ndarray], title: bool = True):
    """The answer sheet as a grid of strings: a title, a header row of
    sample names, subject i's labels + 1 in column 2*i from row 4."""
    n_cols = 2 * (len(labels_per_subject) + 1)
    grid = [["" for _ in range(n_cols)] for _ in range(3 + ANSWER_ROWS)]
    if title:
        grid[0][0] = "Track#3 Imagined speech answer sheet"
    for i, labels in enumerate(labels_per_subject):
        col = 2 * (i + 1)
        grid[2][col] = f"Data_Sample{i + 1:02d}" if title else ""
        for r, lab in enumerate(labels):
            grid[3 + r][col] = str(int(lab) + 1)
    return grid


def write_csv(path: str, grid) -> None:
    with open(path, "w") as f:
        for row in grid:
            f.write(",".join(row) + "\n")


def write_tree(base: str, subjects: Sequence[str] = SUBJECTS,
               trials_per_split: Tuple[int, int, int] = (300, 50, 50), n_channels: int = 64,
               t_raw: int = 795, seed: int = 0, dtype=np.float32, test_files: bool = True,
               verbose: bool = False) -> Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]:
    """Write the raw tree for ``subjects`` under ``base``; return
    ``{(split folder, subject): (x (N, C, t_raw), labels (N,))}`` as
    written. The answer sheet holds labels for all 15 subjects (the
    loaders read every column); a subject's test labels are its first
    ``trials_per_split[2]`` rows of it. ``test_files=False`` writes no
    v7.3 test file (they need h5py) and only returns their arrays."""
    templates = class_templates(n_channels, t_raw)
    answers = [np.random.default_rng((seed, 100, j)).integers(0, N_CLASSES, ANSWER_ROWS)
               for j in range(len(SUBJECTS))]
    expected = {}
    for (folder, struct), n in zip(SPLITS, trials_per_split):
        os.makedirs(os.path.join(base, folder), exist_ok=True)
        for sid in subjects:
            j = SUBJECTS.index(sid)
            rng = np.random.default_rng((seed, SPLITS.index((folder, struct)), j))
            labels = answers[j][:n] if struct == "epo_test" else rng.integers(0, N_CLASSES, n)
            x = trials(rng, labels, templates, dtype)
            path = os.path.join(base, folder, f"Data_Sample{sid}.mat")
            if struct == "epo_test":
                if test_files:
                    write_mat73(path, x)
            else:
                write_mat_v5(path, struct, x, labels)
            expected[(folder, sid)] = (x, labels)
            if verbose:
                print(f"  wrote {folder}/Data_Sample{sid}.mat {x.shape}", flush=True)
    grid = answer_grid(answers)
    write_xlsx(os.path.join(base, "Test set", SHEET + ".xlsx"), grid)
    write_csv(os.path.join(base, "Test set", SHEET + ".csv"), grid)
    return expected
