"""The port's raw-data ingest (``data/ingest.py``) against the JAX package's
on the same fixture files (``tests/bcic_fixture.py``): arrays and labels
equal element for element, the strict schema checks raise the same
``SchemaError`` on each kind of deviating file, the ``.xlsx`` and ``.csv``
answer sheets read alike, and a blank or out-of-range cell raises."""

import os

import numpy as np
import pytest
import torch

from bcic_fixture import (
    SHEET,
    SUBJECTS,
    answer_grid,
    write_csv,
    write_mat73,
    write_mat_v5,
    write_tree,
    write_xlsx,
)
from imagined_speech_decoding_tpu.data import ingest as jax_ingest
from imagined_speech_decoding_tpu_torch.data import ingest

torch.set_num_threads(1)

TRIALS = (6, 4, 50)  # train, validation, test trials a subject (the sheet has 50 rows)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("bcic"))
    return base, write_tree(base, SUBJECTS[:2], TRIALS, seed=3)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strict", [True, False])
def test_loaders_match_jax(tree, strict):
    base, expected = tree
    sheet = ingest.resolve_excel_path(base)
    assert sheet == jax_ingest.resolve_excel_path(base)
    for name, args in (("load_training_set", (base,)), ("load_validation_set", (base,)),
                       ("load_test_set", (base, sheet))):
        ours = getattr(ingest, name)(*args, verbose=False, strict=strict)
        ref = getattr(jax_ingest, name)(*args, verbose=False, strict=strict)
        for a, b in zip(ours, ref):
            _equal(a, b)
    ours = ingest.load_test_set_per_subject(base, sheet, verbose=False, strict=strict)
    ref = jax_ingest.load_test_set_per_subject(base, sheet, verbose=False, strict=strict)
    assert list(ours) == list(ref) == list(SUBJECTS[:2])
    for sid in ours:
        for a, b in zip(ours[sid], ref[sid]):
            _equal(a, b)
        x, y = ingest.load_subject_train_val(base, sid, strict=strict)
        xr, yr = jax_ingest.load_subject_train_val(base, sid, strict=strict)
        _equal(x, xr)
        _equal(y, yr)
        # and against what the writer wrote: (N, C, 795) edge-padded to 800
        xw = np.concatenate([expected[(f, sid)][0] for f in ("Training set", "Validation set")])
        np.testing.assert_array_equal(x[..., :795], xw)
        np.testing.assert_array_equal(x[..., 795:], np.repeat(xw[..., -1:], 5, axis=-1))
        np.testing.assert_array_equal(
            y, np.concatenate([expected[(f, sid)][1] for f in ("Training set", "Validation set")]))


def test_resolve_paths_match_jax(tree, tmp_path):
    base, _ = tree
    assert ingest.resolve_data_folder(base) == jax_ingest.resolve_data_folder(base)
    for fn in (ingest.resolve_data_folder, jax_ingest.resolve_data_folder):
        with pytest.raises(FileNotFoundError, match="BCIC2020Track3 folder not found"):
            fn(str(tmp_path / "nowhere"), extra_candidates=[str(tmp_path / "none")])
    for fn in (ingest.resolve_excel_path, jax_ingest.resolve_excel_path):
        with pytest.raises(FileNotFoundError, match="answer sheet not found"):
            fn(str(tmp_path))


@pytest.mark.parametrize("kind", ["xlsx", "csv", "xlsx_without_title"])
def test_answer_sheets_match_jax(tmp_path, kind):
    labels = [np.random.default_rng(j).integers(0, 5, 50) for j in range(len(SUBJECTS))]
    grid = answer_grid(labels, title=kind != "xlsx_without_title")
    path = str(tmp_path / (SHEET + (".csv" if kind == "csv" else ".xlsx")))
    (write_csv if kind == "csv" else write_xlsx)(path, grid)
    for strict in (True, False):
        ours = ingest.load_excel_labels(path, strict=strict)
        ref = jax_ingest.load_excel_labels(path, strict=strict)
        assert list(ours) == list(ref) == list(SUBJECTS)
        for sid, lab in zip(SUBJECTS, labels):
            _equal(ours[sid], ref[sid])
            np.testing.assert_array_equal(ours[sid], lab)


def test_xlsx_falls_back_to_the_csv_export(tmp_path):
    """A workbook with no worksheet: both read the ``.csv`` export beside it."""
    import zipfile

    labels = [np.full(50, j % 5) for j in range(len(SUBJECTS))]
    write_csv(str(tmp_path / (SHEET + ".csv")), answer_grid(labels))
    broken = str(tmp_path / (SHEET + ".xlsx"))
    with zipfile.ZipFile(broken, "w") as z:
        z.writestr("xl/workbook.xml", "<workbook/>")
    ours, ref = ingest.load_excel_labels(broken), jax_ingest.load_excel_labels(broken)
    for sid in SUBJECTS:
        _equal(ours[sid], ref[sid])


@pytest.mark.parametrize("cell", ["", "6", "0", "2.5", "x"])
@pytest.mark.parametrize("fmt", ["xlsx", "csv"])
def test_invalid_label_cell_raises_like_jax(tmp_path, cell, fmt):
    """A blank, non-numeric or out-of-range cell raises ``ValueError``
    naming the sheet row, in both packages."""
    labels = [np.zeros(50, int) for _ in SUBJECTS]
    grid = answer_grid(labels)
    grid[3 + 7][2 * 2] = cell  # subject 02, sheet row 11
    path = str(tmp_path / f"sheet.{fmt}")
    (write_csv if fmt == "csv" else write_xlsx)(path, grid)
    errors = []
    for mod in (ingest, jax_ingest):
        with pytest.raises(ValueError) as info:
            mod.load_excel_labels(path)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "sheet rows [11]" in errors[0] and "subject 02" in errors[0]


def _v5(path, struct="epo_train", x=None, y=None):
    """A v5 file whose struct holds ``x`` and ``y`` (defaults: 3 valid
    trials; ``False`` leaves the field out)."""
    import scipy.io

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, 3)
    fields = {"x": rng.normal(size=(795, 64, 3)) if x is None else x,
              "y": np.eye(5)[labels].T if y is None else y}
    scipy.io.savemat(path, {struct: {k: v for k, v in fields.items() if v is not False}})


def _deviating_v5(kind, path):
    rng = np.random.default_rng(1)
    if kind == "missing_struct":
        _v5(path, struct="epo_other")
    elif kind == "no_y_field":
        _v5(path, y=False)
    elif kind == "x_2d":
        _v5(path, x=rng.normal(size=(795, 64)))
    elif kind == "wrong_samples":
        _v5(path, x=rng.normal(size=(700, 64, 3)))
    elif kind == "wrong_channels":
        _v5(path, x=rng.normal(size=(795, 62, 3)))
    elif kind == "y_not_one_hot":
        y = np.eye(5)[[0, 1, 2]].T
        y[3, 0] = 1.0
        _v5(path, y=y)
    elif kind == "y_wrong_shape":
        _v5(path, y=np.eye(4)[[0, 1, 2]].T)


V5_KINDS = ["missing_struct", "no_y_field", "x_2d", "wrong_samples", "wrong_channels",
            "y_not_one_hot", "y_wrong_shape"]


@pytest.mark.parametrize("kind", V5_KINDS)
def test_strict_v5_schema_errors_match_jax(tmp_path, kind):
    path = str(tmp_path / "Data_Sample01.mat")
    _deviating_v5(kind, path)
    errors = []
    for mod in (ingest, jax_ingest):
        with pytest.raises(mod.SchemaError) as info:
            mod._load_mat_epochs(path, "epo_train", strict=True)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and errors[0].startswith(path)
    assert issubclass(ingest.SchemaError, ValueError)


def test_non_strict_loads_a_deviating_montage_like_jax(tmp_path):
    path = str(tmp_path / "Data_Sample01.mat")
    _deviating_v5("wrong_channels", path)
    ours = ingest._load_mat_epochs(path, "epo_train")
    ref = jax_ingest._load_mat_epochs(path, "epo_train")
    for a, b in zip(ours, ref):
        _equal(a, b)
    assert ours[0].shape == (3, 62, 800)


def _deviating_mat73(kind, path):
    import h5py

    rng = np.random.default_rng(2)
    if kind == "no_group":
        with h5py.File(path, "w") as f:
            f.create_dataset("other", data=np.zeros(3))
    elif kind == "no_x":
        with h5py.File(path, "w") as f:
            f.create_group("epo_test").create_dataset("y", data=np.zeros(3))
    elif kind == "x_2d":
        write_mat73(path, rng.normal(size=(3, 64)))
    elif kind == "wrong_channels":
        write_mat73(path, rng.normal(size=(3, 60, 795)))
    elif kind == "wrong_samples":
        write_mat73(path, rng.normal(size=(3, 64, 790)))


@pytest.mark.parametrize("kind", ["no_group", "no_x", "x_2d", "wrong_channels", "wrong_samples"])
def test_strict_mat73_schema_errors_match_jax(tmp_path, kind):
    path = str(tmp_path / "Data_Sample01.mat")
    _deviating_mat73(kind, path)
    errors = []
    for mod in (ingest, jax_ingest):
        with pytest.raises(mod.SchemaError) as info:
            mod._load_mat73_test(path, strict=True)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    if kind == "no_group":  # without strict it is a KeyError in both
        for mod in (ingest, jax_ingest):
            with pytest.raises(KeyError, match="no 'epo_test' group"):
                mod._load_mat73_test(path)


def test_strict_sheet_and_test_split_errors_match_jax(tree, tmp_path):
    base, _ = tree
    narrow = str(tmp_path / "narrow.csv")
    write_csv(narrow, answer_grid([np.zeros(50, int)] * 3))  # columns for 3 subjects only
    errors = []
    for mod in (ingest, jax_ingest):
        with pytest.raises(mod.SchemaError) as info:
            mod.load_excel_labels(narrow, strict=True)
        errors.append(str(info.value))
        with pytest.raises(IndexError):  # without strict: the column is out of bounds
            mod.load_excel_labels(narrow)
    assert errors[0] == errors[1] and "only 8 columns" in errors[0]

    short = str(tmp_path / "short")  # a test file with 40 trials against 50 labels
    os.makedirs(os.path.join(short, "Test set"))
    write_mat73(os.path.join(short, "Test set", "Data_Sample01.mat"),
                np.zeros((40, 64, 795), np.float32))
    sheet = os.path.join(base, "Test set", SHEET + ".xlsx")
    errors = []
    for mod in (ingest, jax_ingest):
        with pytest.raises(mod.SchemaError) as info:
            mod.load_test_set_per_subject(short, sheet, verbose=False, strict=True)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "40 test trials" in errors[0]


def test_missing_files(tmp_path):
    for mod in (ingest, jax_ingest):
        with pytest.raises(FileNotFoundError, match="no subject files"):
            mod.load_training_set(str(tmp_path), verbose=False)
        with pytest.raises(FileNotFoundError, match="no data for subject 01"):
            mod.load_subject_train_val(str(tmp_path), "01")


def test_v5_float64_files_match_jax(tmp_path):
    """MATLAB's double precision on disk: both cast to float32 alike."""
    path = str(tmp_path / "Data_Sample01.mat")
    x = np.random.default_rng(4).normal(size=(5, 64, 795))
    write_mat_v5(path, "epo_validation", x, np.arange(5) % 5)
    ours = ingest._load_mat_epochs(path, "epo_validation", strict=True)
    ref = jax_ingest._load_mat_epochs(path, "epo_validation", strict=True)
    for a, b in zip(ours, ref):
        _equal(a, b)
    np.testing.assert_array_equal(ours[0][..., :795], x.astype(np.float32))
