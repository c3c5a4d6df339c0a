"""``ops.csp``, ``models.classical`` and ``cli.svm_baseline`` against the
JAX package on the CPU.

CSP filters, patterns, feature statistics and features are held at rtol
1e-4 / atol 1e-4 * max|ref| (both packages in f32). The pipeline's features are held the same way
after each band-pass (``fir``, ``iir``, the filterbank). Its SVM and LDA
predictions, and the CLI's summary and prediction files, are held equal:
a prediction that flipped on an SVC tie would fail them (none does here).
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu.cli import svm_baseline as jax_cli
from imagined_speech_decoding_tpu.models import classical as jax_classical
from imagined_speech_decoding_tpu.ops import csp as jax_csp
from imagined_speech_decoding_tpu_torch.cli import svm_baseline
from imagined_speech_decoding_tpu_torch.models.classical import CSPClassifierPipeline
from imagined_speech_decoding_tpu_torch.ops import csp

torch.set_num_threads(1)
pytest.importorskip("sklearn")

RTOL = 1e-4


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _trials(n_classes, n=60, c=12, t=200, seed=0):
    """Trials whose classes differ in the variance of one channel each."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % n_classes
    x = rng.normal(size=(n, c, t)).astype(np.float32)
    for k in range(n_classes):
        x[y == k, k] *= 2.0
    return x, y


@pytest.mark.parametrize("n_classes,n_components", [(2, 4), (2, 8), (5, 10)])
def test_csp_matches_jax(n_classes, n_components):
    x, y = _trials(n_classes)
    ref = jax_csp.csp_fit(jnp.asarray(x), jnp.asarray(y), n_classes, n_components)
    got = csp.csp_fit(torch.from_numpy(x), torch.from_numpy(y), n_classes, n_components)
    for field in csp.CSPModel._fields:
        _close(getattr(got, field).numpy(), getattr(ref, field))
    xt = _trials(n_classes, n=10, seed=1)[0]
    for standardize in (True, False):
        _close(csp.csp_transform(torch.from_numpy(xt), got, standardize).numpy(),
               jax_csp.csp_transform(jnp.asarray(xt), ref, standardize))
    model, feats = csp.csp_fit_transform(torch.from_numpy(x), torch.from_numpy(y), n_classes,
                                         n_components)
    assert torch.equal(feats, csp.csp_transform(torch.from_numpy(x), model))
    assert torch.equal(model.filters, got.filters)


def test_csp_refuses_an_uneven_one_vs_rest():
    x, y = _trials(3)
    with pytest.raises(ValueError, match="must be divisible by n_classes=3"):
        csp.csp_fit(torch.from_numpy(x), torch.from_numpy(y), 3, 8)


@pytest.mark.parametrize("kw", [dict(filter_method="fir"), dict(filter_method="iir"),
                                dict(filter_method="iir", bands=[(4, 8), (8, 13), (13, 30)],
                                     n_components=5, classifier="lda")])
def test_pipeline_matches_jax(kw, tmp_path):
    """Band-pass, CSP features and the classifier's predictions on trials
    near chance (noise with a faint class trace), where the decision
    boundary is close to many test trials."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(80, 16, 400)).astype(np.float32)
    y = np.arange(80) % 5
    x[np.arange(80), y] *= 1.15
    x_test = rng.normal(size=(40, 16, 400)).astype(np.float32)
    ref = jax_classical.CSPClassifierPipeline(sfreq=250.0, **kw).fit(x, y)
    ours = CSPClassifierPipeline(sfreq=250.0, device="cpu", **kw).fit(x, y)
    for a, b in zip(ours.csp_models, ref.csp_models):
        _close(a.filters.numpy(), b.filters)
    _close(ours.features(x_test), ref._features(jnp.asarray(x_test), fit=False))
    pred = ours.predict(x_test)
    np.testing.assert_array_equal(pred, ref.predict(x_test))
    assert len(set(pred.tolist())) > 1
    assert ours.score(x, y) == ref.score(x, y)
    path = ours.save(str(tmp_path / "pipe.joblib"))
    loaded = CSPClassifierPipeline.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict(x_test), pred)


@pytest.mark.parametrize("extra", [[], ["--filter_method", "iir"],
                                   ["--filterbank", "--classifier", "lda"]])
def test_svm_cli_files_equal_jax(extra, tmp_path, capsys):
    """Over 2 synthetic subjects the summary and each subject's test
    predictions equal the JAX CLI's byte for byte, and both write the same
    files."""
    argv = ["--synthetic", "2", "--synthetic_trials", "40", "--n_folds", "3", *extra]
    jax_cli.main(argv + ["--output_dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    rows = svm_baseline.main(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")
    assert capsys.readouterr().out == jax_out
    for d in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "sub-01", "sub-01_pipeline.joblib", "sub-02", "sub-02_pipeline.joblib",
            "svm_baseline_summary.csv"]
    for f in ("svm_baseline_summary.csv", "sub-01/test_predictions.csv",
              "sub-02/test_predictions.csv"):
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f
    assert [r["Subject"] for r in rows] == ["01", "02"]
    assert list(rows[0]) == list(svm_baseline.SUMMARY_COLUMNS)
    loaded = CSPClassifierPipeline.load(str(tmp_path / "port" / "sub-01_pipeline.joblib"),
                                        device="cpu")
    assert loaded.clf is not None and loaded.csp_models[0].filters.device.type == "cpu"
