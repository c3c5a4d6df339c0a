"""The port's benchmark CLI (``cli/benchmark.py``, no pandas) against the
JAX CLI on the same result trees, with and without the global predictions
file: ``<model>_Subject_Metrics.csv`` and ``Model_Summary.csv`` have the
same columns, subjects and models, and the same numbers (the port counts
in float32 as the JAX package does: rtol 1e-6). ``Acc_Mean`` is the mean
of the subjects' accuracies."""

import csv

import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu.cli import benchmark as jax_benchmark
from imagined_speech_decoding_tpu_torch.cli import benchmark
from imagined_speech_decoding_tpu_torch.train import metrics
from imagined_speech_decoding_tpu_torch.train.artifacts import save_predictions_csv

torch.set_num_threads(1)

RTOL = 1e-6


def _tree(root, models, with_global, n_subjects=4):
    rng = np.random.default_rng(0)
    for model in models:
        preds, trues = [], []
        for s in range(n_subjects):
            true = rng.integers(0, 5, 50)
            pred = np.where(rng.random(50) < 0.4 + 0.1 * s, true, rng.integers(0, 5, 50))
            save_predictions_csv(str(root / model / f"sub-{s + 1:02d}" / "test_predictions.csv"),
                                 pred, true)
            preds.append(pred)
            trues.append(true)
        if with_global:
            save_predictions_csv(str(root / model / "global_test_predictions.csv"),
                                 np.concatenate(preds), np.concatenate(trues))
    (root / "empty_model").mkdir()  # no predictions: skipped by both


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_same_csv(ours, ref):
    a, b = _read(ours), _read(ref)
    assert a[0] == b[0] and len(a) == len(b)
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[0] == rb[0]
        for u, v in zip(ra[1:], rb[1:]):
            if v == "":
                assert u == ""
            else:
                np.testing.assert_allclose(float(u), float(v), rtol=RTOL)


@pytest.mark.parametrize("with_global", [True, False], ids=["global", "mean_of_subjects"])
def test_csvs_match_jax(tmp_path, with_global):
    ours_dir, ref_dir = tmp_path / "port", tmp_path / "jax"
    for root in (ours_dir, ref_dir):
        _tree(root, ("FAST", "EEGNet"), with_global)
    summaries = benchmark.main(["--results_dir", str(ours_dir)])
    ref = jax_benchmark.main(["--results_dir", str(ref_dir)])
    assert [s["Model"] for s in summaries] == [s["Model"] for s in ref] == ["EEGNet", "FAST"]
    for name in ("FAST_Subject_Metrics.csv", "EEGNet_Subject_Metrics.csv", "Model_Summary.csv"):
        _assert_same_csv(ours_dir / name, ref_dir / name)
    assert not (ours_dir / "empty_model_Subject_Metrics.csv").exists()
    rows = _read(ours_dir / "FAST_Subject_Metrics.csv")
    summary = dict(zip(*_read(ours_dir / "Model_Summary.csv")[:2]))
    assert summary["Model"] == "EEGNet"
    fast = dict(zip(_read(ours_dir / "Model_Summary.csv")[0],
                    _read(ours_dir / "Model_Summary.csv")[2]))
    assert float(fast["Acc_Mean"]) == np.mean([float(r[1]) for r in rows[1:]])


def test_one_subject_has_no_t_test(tmp_path):
    for name, mod in (("port", benchmark), ("jax", jax_benchmark)):
        _tree(tmp_path / name, ("FAST",), False, n_subjects=1)
        mod.main(["--results_dir", str(tmp_path / name), "--models", "FAST"])
    _assert_same_csv(tmp_path / "port" / "Model_Summary.csv",
                     tmp_path / "jax" / "Model_Summary.csv")
    row = dict(zip(*_read(tmp_path / "port" / "Model_Summary.csv")))
    assert row["TTest_vs_Chance"] == row["P_Value_OneSided"] == row["F1_Std"] == ""


def test_metric_helpers_match_jax():
    import jax.numpy as jnp

    from imagined_speech_decoding_tpu.train import metrics as jax_metrics

    rng = np.random.default_rng(5)
    for _ in range(5):
        pred, true = rng.integers(0, 5, 40), rng.integers(0, 4, 40)  # class 4 never true
        cm = metrics.confusion_matrix(torch.as_tensor(pred), torch.as_tensor(true), 5)
        ref = jax_metrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), 5)
        for a, b in zip(metrics.precision_recall_from_confusion(cm),
                        jax_metrics.precision_recall_from_confusion(ref)):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL)
    accs = rng.random(15)
    for chance in (0.2, 0.9):
        assert metrics.ttest_vs_chance(accs, chance) == jax_metrics.ttest_vs_chance(accs, chance)
