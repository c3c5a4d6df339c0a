"""The port's baseline pipelines (``pipelines.py``) and
``cli.train_baselines`` against the JAX package on the CPU: both
featurizers (the band-power filters as one chain of kernel B1's plain
version) and their warnings, ``featurize_corpus``, the registry, a CV run
of each pipeline without randomness (dropout off in both packages, each
fold's training set in one batch, JAX's initial weights transplanted),
and the CLI's result tree, its ``--augment`` refusal, ``--subject_group``
and ``--mesh``.

Tolerances: the band-power features at rtol 1e-4 / atol 1e-5 (logs of
powers near 1 sit near 0; the stop-band powers are the filters' rounding
floor, whose logs agree to ~2e-5 relative); the STFT planes at rtol 1e-4
/ atol 1e-5; CV runs at rtol 1e-4 / atol 1e-5 (tests/test_torch_parity.py)."""

import csv
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu import pipelines as jax_pipelines
from imagined_speech_decoding_tpu.cli import train_baselines as jax_cli
from imagined_speech_decoding_tpu.models import eegnet as jax_eegnet
from imagined_speech_decoding_tpu.models import mlp as jax_mlp
from imagined_speech_decoding_tpu.models import rnn as jax_rnn
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu_torch import config, pipelines
from imagined_speech_decoding_tpu_torch.cli import train_baselines
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
from imagined_speech_decoding_tpu_torch.models import api
from imagined_speech_decoding_tpu_torch.ops.augment import augment_batch
from imagined_speech_decoding_tpu_torch.ops.cuda import iir
from imagined_speech_decoding_tpu_torch.train import cv

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
C, T, K = 8, 256, 5
NAMES = ["bandpower_mlp", "stft_eegnet", "cnn_bilstm"]


@pytest.fixture(scope="module")
def corpus():
    """2 subjects x 20 trials of 8 channels x 256 samples, 5 classes."""
    return synthetic_corpus(3, 2, 20, C, T)


def test_bandpower_featurize_matches_jax(corpus):
    """Notch then 8-70 Hz band-pass (one chain: B1's plain version on the
    CPU), then 2-s Welch log-bandpower, against the JAX function's
    ``sosfiltfilt`` scans; the chain's filters are the notch section and
    the 4 band-pass sections, each with ``sosfiltfilt``'s default padlen."""
    x = corpus[0][0]
    ours = pipelines.bandpower_featurize(torch.from_numpy(x), sfreq=250.0)
    ref = jax_pipelines.bandpower_featurize(jnp.asarray(x), sfreq=250.0, use_pallas=False)
    assert ours.shape == (20, C * 5)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    notch, band = pipelines.bandpower_filters(250.0)
    assert (notch.n_sections, notch.padlen, band.n_sections, band.padlen) == (1, 9, 4, 27)
    before = iir.sosfiltfilt_chain.launches
    pipelines.bandpower_featurize(torch.from_numpy(x[:2]), sfreq=250.0)
    assert iir.sosfiltfilt_chain.launches == before  # the CPU runs the plain version


def test_stft_image_featurize_matches_jax_with_its_warnings(corpus):
    """The band-binned STFT log-magnitude planes and ``stft_n_frames``; at
    ``nperseg`` 8 the Delta and Theta bands have no bin (each warns, and
    takes its nearest) and resolve to the same one (a duplicate-planes
    warning), with the JAX function's messages."""
    x = corpus[0][0]
    ours = pipelines.stft_image_featurize(torch.from_numpy(x), sfreq=250.0)
    ref = jax_pipelines.stft_image_featurize(jnp.asarray(x), sfreq=250.0)
    assert ours.shape == (20, 5, C, pipelines.stft_n_frames(T))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    for n in (256, 255, 800, 17):
        assert pipelines.stft_n_frames(n) == jax_pipelines.stft_n_frames(n)
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        small = pipelines.stft_image_featurize(torch.from_numpy(x[:2]), nperseg=8, step=4)
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref_small = jax_pipelines.stft_image_featurize(jnp.asarray(x[:2]), nperseg=8, step=4)
    msgs = [str(w.message) for w in ours_w]
    assert msgs == [str(w.message) for w in ref_w] and len(msgs) >= 3
    assert any("identical rfft bins" in m for m in msgs)
    np.testing.assert_allclose(small.numpy(), ref_small, rtol=RTOL, atol=ATOL)


def test_featurize_corpus_and_registry(corpus):
    """``featurize_corpus``: the band-power features of the whole split in
    one call equal the per-subject ones, the test sets keep their labels,
    raw pipelines pass through; the registry's names, descriptions and
    ``augmentable`` flags are the JAX package's; a CUDA device without a
    card raises."""
    X, Y = corpus
    test = {"01": (X[0, :4], Y[0, :4]), "02": (X[1, :3], Y[1, :3])}
    Xf, testf = pipelines.featurize_corpus(pipelines.PIPELINES["bandpower_mlp"], X, test,
                                           device="cpu")
    assert Xf.shape == (2, 20, C * 5) and Xf.dtype == np.float32
    for s in range(2):
        np.testing.assert_allclose(Xf[s], pipelines.bandpower_featurize(
            torch.from_numpy(X[s])).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(testf["02"][0], Xf[1, :3], rtol=1e-6, atol=1e-6)
    assert testf["02"][1] is test["02"][1]
    Xs, tests = pipelines.featurize_corpus(pipelines.PIPELINES["stft_eegnet"], X, test,
                                           device="cpu")
    assert Xs.shape == (2, 20, 5, C, pipelines.stft_n_frames(T)) and tests["01"][0].shape[0] == 4
    Xr, testr = pipelines.featurize_corpus(pipelines.PIPELINES["cnn_bilstm"], X, test,
                                           device="cpu")
    assert Xr is X and testr is test
    assert sorted(pipelines.PIPELINES) == sorted(jax_pipelines.PIPELINES)
    for name, pipe in pipelines.PIPELINES.items():
        ref = jax_pipelines.PIPELINES[name]
        assert (pipe.description, pipe.augmentable) == (ref.description, ref.augmentable)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            pipelines.featurize_corpus(pipelines.PIPELINES["bandpower_mlp"], X)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {h: [r[i] for r in rows[1:]] for i, h in enumerate(rows[0])}


def _no_dropout(mp):
    """The JAX models' dropout off (their applies read these module names
    when called)."""
    for mod, name in ((jax_mlp, "mlp_apply"), (jax_eegnet, "eegnet_apply"),
                      (jax_rnn, "cnn_bilstm_apply")):
        mp.setattr(mod, name, functools.partial(getattr(mod, name), dropout=0.0))


PORT_MODELS = {
    "bandpower_mlp": lambda: api.make_mlp_model(C * 5, K, dropout=0.0),
    "stft_eegnet": lambda: api.make_stft_eegnet_model(C, T, K, dropout=0.0),
    "cnn_bilstm": lambda: api.make_cnn_bilstm_model(C, T, K, dropout=0.0),
}


@pytest.fixture(scope="module", params=NAMES)
def cv_runs(request, corpus, tmp_path_factory):
    """Each package's CV of 2 subjects x 20 trials on its own features, 5
    folds (16 + 4 trials, one full-batch step an epoch), 2 epochs, f32,
    dropout off, JAX's initial weights in both."""
    name = request.param
    X, Y = corpus
    subjects = ["01", "02"]
    test = {sid: (X[i, :6], Y[i, :6]) for i, sid in enumerate(subjects)}
    kw = dict(max_epochs=2, batch_size=16, learning_rate=1e-3, warmup_epochs=1, precision="f32",
              seed=42, n_folds=5)
    jdir, odir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        jpipe = jax_pipelines.PIPELINES[name]
        jmodel = jpipe.make_model(C, T, K, jnp.float32)
        params0, state0 = jax_cv.stacked_init(jmodel, jax.random.PRNGKey(7), 10)
        Xj, testj = jax_pipelines.featurize_corpus(jpipe, X, test)
        ref = jax_cv.train_per_subject_cv(
            jmodel, jax_config.TrainConfig(**kw), Xj, Y, subjects, K, test_per_subject=testj,
            save_dir=str(jdir), warm_start=(params0, state0), verbose=False)
    Xo, testo = pipelines.featurize_corpus(pipelines.PIPELINES[name], X, test, device="cpu")
    ours = cv.train_per_subject_cv(
        PORT_MODELS[name](), config.TrainConfig(**kw), Xo, Y, subjects, K,
        test_per_subject=testo, save_dir=str(odir),
        warm_start=(jax.tree.map(np.asarray, params0), jax.tree.map(np.asarray, state0)),
        verbose=False, device="cpu")
    return ref, ours, str(jdir), str(odir)


def test_cv_run_matches_jax(cv_runs):
    """History, best epochs, best folds, the summary, every history CSV and
    the test predictions byte for byte."""
    ref, ours, jdir, odir = cv_runs
    for k in ("loss", "acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(ours.fit.history[k], np.asarray(ref.fit.history[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(ours.fit.best_epoch, np.asarray(ref.fit.best_epoch))
    assert ours.best_fold_per_subject == ref.best_fold_per_subject
    for col in ("Best_Val_Acc", "Test_Acc", "Test_F1"):
        np.testing.assert_allclose([r[col] for r in ours.summary], ref.summary[col].to_numpy(),
                                   rtol=RTOL, err_msg=col)
    for name in ("summary_per_subject.csv", "sub-02/fold-3_history.csv",
                 "sub-01/fold_metrics.csv"):
        a, b = _read(os.path.join(odir, name)), _read(os.path.join(jdir, name))
        assert list(a) == list(b), name
        for col in b:
            if col != "Subject":
                np.testing.assert_allclose(np.array(a[col], float), np.array(b[col], float),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{name}:{col}")
    for name in ("sub-01/test_predictions.csv", "global_test_predictions.csv"):
        with open(os.path.join(odir, name)) as a, open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(odir, "sub-02", "best_subject.npz")) as a, \
            np.load(os.path.join(jdir, "sub-02", "best_subject.npz")) as b:
        assert sorted(a.files) == sorted(b.files)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs if not f.endswith(".png"))


ARGV = ["--synthetic", "2", "--synthetic_trials", "20", "--epochs", "2"]


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """The JAX CLI's tree for ``bandpower_mlp`` (every pipeline's tree is
    ``train_per_subject_cv``'s)."""
    out = tmp_path_factory.mktemp("jax_cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("imagined_speech_decoding_tpu.cli.enable_cache", lambda: None)
        jax_cli.main(["--pipeline", "bandpower_mlp", *ARGV, "--output_dir", str(out)])
    return str(out)


@pytest.mark.parametrize("name", NAMES)
def test_cli_tree_matches_jax(name, jax_tree, tmp_path):
    """``cli.train_baselines --pipeline <p> --synthetic 2 --synthetic_trials
    20 --epochs 2`` (bf16, the default): the parser is the JAX CLI's, and
    the run writes the JAX CLI's files, CSV columns and test labels."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices)
                for a in parser._actions if a.dest != "help"}

    assert options(train_baselines.build_parser()) == options(jax_cli.build_parser())
    out = tmp_path / name
    res = train_baselines.main(["--pipeline", name, *ARGV, "--output_dir", str(out)],
                               device="cpu")
    assert _files(str(out)) == _files(jax_tree)
    assert [r["Subject"] for r in res.summary] == ["01", "02"]
    assert np.isfinite(res.fit.history["loss"]).all()
    for f in ("summary_per_subject.csv", "sub-01/fold-2_history.csv", "sub-02/test_predictions.csv"):
        a, b = _read(str(out / f)), _read(os.path.join(jax_tree, f))
        assert list(a) == list(b), f
        if "True" in b:
            assert a["True"] == b["True"] and len(b["True"]) == 6  # the first third of 20


def test_cli_subject_group_augment_and_mesh(tmp_path):
    """``--subject_group 1``: the tree of an ungrouped run, with one checkpoint
    directory a group, as the JAX CLI's grouped run writes (same layout);
    ``--augment`` on a feature pipeline exits with the JAX CLI's parser
    error, before any data; on ``cnn_bilstm`` it trains, and the engine's
    augmentation refuses feature inputs."""
    argv = ["--pipeline", "bandpower_mlp", "--synthetic", "2", "--synthetic_trials", "10",
            "--epochs", "1", "--precision", "f32", "--subject_group", "1"]
    ours, ref = tmp_path / "port", tmp_path / "jax"
    train_baselines.main(argv + ["--output_dir", str(ours)], device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("imagined_speech_decoding_tpu.cli.enable_cache", lambda: None)
        jax_cli.main(argv + ["--output_dir", str(ref)])
    assert _files(str(ours)) == _files(str(ref))
    assert "checkpoints/group-1/segment_carry.npz" in _files(str(ours))
    for pkg in (train_baselines, jax_cli):
        with pytest.raises(SystemExit) as e:
            pkg.main(["--pipeline", "stft_eegnet", "--synthetic", "1", "--augment"])
        assert e.value.code == 2
    res = train_baselines.main(["--pipeline", "cnn_bilstm", "--synthetic", "1",
                                "--synthetic_trials", "10", "--epochs", "1", "--augment",
                                "--output_dir", str(tmp_path / "aug")], device="cpu")
    assert np.isfinite(res.fit.history["loss"]).all()
    with pytest.raises(ValueError, match="raw trials"):  # the engine's augmentation of features
        augment_batch(torch.zeros(2, 3, C * 5), generator=torch.Generator())
