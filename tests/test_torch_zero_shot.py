"""The port's zero-shot transfer matrix (``cli.zero_shot``) on the CPU,
against the JAX package: ``transfer_matrix`` on transplanted stacked
weights (in chunks and whole), the checkpoint path over a results tree
and a test split, the synthetic CLI's matrix shape and labels, ``_subset_zones``,
and the card required by default."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.cli import zero_shot as jax_zero_shot
from imagined_speech_decoding_tpu.data.constants import Electrodes, Zones
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu_torch.cli import zero_shot
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.transplant import (
    from_jax_params,
    init_jax_layout_params,
    stack_trees,
)

torch.set_num_threads(1)

SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.1,
)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.asarray([r[1:] for r in rows[1:]], float)


@pytest.mark.parametrize("batch", [4, 64])
def test_transfer_matrix_matches_jax(batch):
    """3 models x 3 targets of 10 trials, on weights drawn for the port and
    transplanted into the JAX model; the labels chosen so that accuracies
    differ across cells."""
    s = 3
    params = init_jax_layout_params(FASTConfig(**SMALL), 4, s)
    rng = np.random.default_rng(0)
    tests = [(rng.normal(size=(10, 8, 200)).astype(np.float32), rng.integers(0, 5, 10))
             for _ in range(s)]
    model = FAST(FASTConfig(**SMALL), n_models=s)
    model.load_state_dict(from_jax_params(params))
    ours = zero_shot.transfer_matrix(model, tests, batch)
    jmodel = make_fast_model(jax_config.FASTConfig(**SMALL))
    _, state = jax_cv.stacked_init(jmodel, jax.random.PRNGKey(0), s)
    ref = jax_zero_shot.transfer_matrix(jmodel, jax.tree.map(jnp.asarray, params), state, tests,
                                        batch)
    assert ours.shape == (s, s) and ours.dtype == np.asarray(ref).dtype == np.float32
    np.testing.assert_array_equal(ours, np.asarray(ref))
    # each model alone gives its row
    one = FAST(FASTConfig(**SMALL), n_models=1)
    one.load_state_dict(from_jax_params(jax.tree.map(lambda v: v[1:2], params)))
    np.testing.assert_array_equal(zero_shot.transfer_matrix(one, tests, batch)[0], ours[1])


def test_subset_zones_matches_jax():
    electrodes = Electrodes[:16]
    ours = zero_shot._subset_zones(Zones, electrodes)
    assert ours == jax_zero_shot._subset_zones(Zones, electrodes)
    assert set(c for chs in ours.values() for c in chs) == set(electrodes)


def test_save_artifacts_writes_pandas_text(tmp_path):
    m = np.asarray([[0.1, 1 / 3], [0.25, 2 / 3]], np.float32)
    csv_path, _ = zero_shot.save_artifacts(str(tmp_path / "port"), m, ["01", "02"])
    jax_csv, _ = jax_zero_shot.save_artifacts(str(tmp_path / "jax"), m, ["01", "02"])
    with open(csv_path) as f, open(jax_csv) as g:
        assert f.read() == g.read() == ",test_S01,test_S02\nmodel_S01,0.1,0.33333334\n" \
                                       "model_S02,0.25,0.6666667\n"


@pytest.fixture(scope="module")
def synthetic_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero_shot")
    argv = ["--synthetic", "3", "--synthetic_trials", "8", "--synthetic_epochs", "1",
            "--config", "none.yaml"]
    ours = zero_shot.main(argv + ["--output_dir", str(root / "port")], device="cpu")
    ref = jax_zero_shot.main(argv + ["--output_dir", str(root / "jax")])
    return ours, np.asarray(ref), root


def test_synthetic_cli_matrix_and_labels_match_jax(synthetic_runs):
    ours, ref, root = synthetic_runs
    assert ours.shape == ref.shape == (3, 3) and ours.dtype == ref.dtype
    assert ((ours >= 0) & (ours <= 1)).all()
    head, index, values = read_csv(root / "port" / "zero_shot_matrix.csv")
    ref_head, ref_index, _ = read_csv(root / "jax" / "zero_shot_matrix.csv")
    assert head == ref_head == ["", "test_S01", "test_S02", "test_S03"]
    assert index == ref_index == ["model_S01", "model_S02", "model_S03"]
    np.testing.assert_array_equal(values, ours)
    # the 2 validation trials a subject are its test trials: accuracies in halves
    assert set(np.unique(ours * 2)) <= {0.0, 1.0, 2.0}


def test_checkpoint_path_reads_the_results_tree(tmp_path, monkeypatch):
    """Without ``--synthetic``: the test split of each subject with a
    ``sub-XX/best_subject.npz``, those checkpoints stacked in subject order."""
    from imagined_speech_decoding_tpu_torch.data import ingest
    from imagined_speech_decoding_tpu_torch.train.checkpoint import save_model_npz

    cfg = FASTConfig.default()
    rng = np.random.default_rng(1)
    split = {sid: (rng.normal(size=(6, 64, 800)).astype(np.float32), rng.integers(0, 5, 6))
             for sid in ("01", "03")}
    for i, sid in enumerate(("01", "03")):
        save_model_npz(str(tmp_path / "FAST" / f"sub-{sid}" / "best_subject.npz"),
                       init_jax_layout_params(cfg, 10 + i), {"head": {}})
    monkeypatch.setattr(ingest, "resolve_data_folder", lambda folder: folder)
    monkeypatch.setattr(ingest, "resolve_excel_path", lambda base, path: path)
    monkeypatch.setattr(ingest, "load_test_set_per_subject", lambda *a, **k: split)
    matrix = zero_shot.main(["--results_dir", str(tmp_path / "FAST"), "--config", "none.yaml",
                             "--output_dir", str(tmp_path / "out")], device="cpu")
    stacked = FAST(cfg, n_models=2)
    stacked.load_state_dict(from_jax_params(
        stack_trees([init_jax_layout_params(cfg, 10), init_jax_layout_params(cfg, 11)])))
    np.testing.assert_array_equal(matrix, zero_shot.transfer_matrix(stacked, list(split.values())))
    assert os.path.exists(tmp_path / "out" / "zero_shot_matrix.csv")


def test_cli_needs_the_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        zero_shot.main(["--synthetic", "2"])
