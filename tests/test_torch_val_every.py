"""A ``--val_every`` that does not divide the epoch count: the port's
training CLI (plain path on the CPU) against the JAX CLI on the same flags.

Both run ``--synthetic 1 --synthetic_trials 20 --epochs 10 --val_every 3
--precision f32`` with FAST's widths cut by a ``--config`` YAML and
dropout 0. The port starts from the JAX package's initial weights (its
own draw from a numpy seed is patched out), and 16 training trials at the
default batch of 64 make one full step per epoch, so the batch order does
not matter and the two runs follow the same trajectory. The JAX function
rounds its segment down to 9 epochs and freezes the surplus; the port
runs 12 epochs and freezes the last two. Both must validate at 0-based
epochs 2, 5 and 8 only, pick the same best epochs and keep 10 history
rows.
"""

import csv
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.cli import train_fast as jax_train_fast
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.train import cv

torch.set_num_threads(1)

ARGV = ["--synthetic", "1", "--synthetic_trials", "20", "--epochs", "10", "--val_every", "3",
        "--precision", "f32"]
SMALL_YAML = ("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n  num_heads: 4\n"
              "  dropout: 0.0\n")
VALIDATED = [2, 5, 8]


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {h: [r[i] for r in rows[1:]] for i, h in enumerate(rows[0])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("val_every")
    cfg_path = root / "small.yaml"
    cfg_path.write_text(SMALL_YAML)
    argv = ARGV + ["--config", str(cfg_path)]

    def jax_init(cfg, seed, n_models):
        model = make_fast_model(jax_config.FASTConfig(**dataclasses.asdict(cfg)))
        params, _ = jax_cv.stacked_init(model, jax.random.PRNGKey(seed), n_models)
        return jax.tree.map(np.asarray, params)

    mp = pytest.MonkeyPatch()
    mp.setattr(cv, "stacked_init", jax_init)
    try:
        ours = train_fast.main(argv + ["--output_dir", str(root / "port")], device="cpu")
    finally:
        mp.undo()
    ref = jax_train_fast.main(argv + ["--output_dir", str(root / "jax")])
    return ours, ref, root


def test_history_has_the_budget_and_validates_every_third_epoch(runs):
    ours, ref, _ = runs
    for name, res in (("port", ours), ("jax", ref)):
        va = np.asarray(res.fit.history["val_acc"])
        assert va.shape == (5, 10), name
        assert [e for e in range(10) if np.isfinite(va[:, e]).all()] == VALIDATED, name
        assert np.isnan(np.delete(va, VALIDATED, axis=1)).all(), name
        for k in ("loss", "acc"):
            assert np.isfinite(np.asarray(res.fit.history[k])).all(), (name, k)


def test_best_epochs_match_jax(runs):
    ours, ref, _ = runs
    np.testing.assert_array_equal(ours.fit.best_epoch, np.asarray(ref.fit.best_epoch))
    assert set(ours.fit.best_epoch.tolist()) <= set(VALIDATED)
    np.testing.assert_allclose(ours.fit.best_val_acc, np.asarray(ref.fit.best_val_acc),
                               rtol=1e-4)
    np.testing.assert_allclose(ours.fit.history["val_acc"], np.asarray(ref.fit.history["val_acc"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fold", range(5))
def test_fold_history_csv_matches_jax(runs, fold):
    """Ten rows, ``val_*`` filled at epochs 2, 5 and 8 and empty elsewhere,
    in both trees."""
    _, _, root = runs
    name = os.path.join("sub-01", f"fold-{fold}_history.csv")
    ours, theirs = read_csv(root / "port" / name), read_csv(root / "jax" / name)
    assert list(ours) == list(theirs)
    for tree in (ours, theirs):
        assert len(tree["val_acc"]) == 10
        assert [e for e, v in enumerate(tree["val_acc"]) if v not in ("", "nan")] == VALIDATED
    for col in ours:
        a = np.array([v if v else "nan" for v in ours[col]], float)
        b = np.array([v if v else "nan" for v in theirs[col]], float)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=col)
