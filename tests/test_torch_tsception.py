"""The port's TSception (``models/tsception.py``), its CV run in subject
groups (``train.cv._train_grouped``) and ``cli.train_tsception`` against
the JAX package on the CPU: logits, batch-norm state and gradients, one
model and a stack; a grouped CV run without randomness (dropout off, each
fold's training set in one batch, JAX's initial weights) against JAX's,
result tree and checkpoints; the CLIs' trees on synthetic data, the
parts that do not depend on ``jax.random``."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.cli import train_tsception as jax_cli
from imagined_speech_decoding_tpu.models import tsception as jax_ts
from imagined_speech_decoding_tpu.ops.norm import BNState as JaxBNState
from imagined_speech_decoding_tpu.train import checkpoint as jax_ckpt
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu_torch import config
from imagined_speech_decoding_tpu_torch.cli import train_tsception
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
from imagined_speech_decoding_tpu_torch.models.api import make_tsception_model
from imagined_speech_decoding_tpu_torch.models.tsception import TSception
from imagined_speech_decoding_tpu_torch.train import cv
from imagined_speech_decoding_tpu_torch.train.checkpoint import load_model_npz

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
C, T, SFREQ = 8, 128, 64.0  # kernels of 32, 16 and 8 samples, hemispheres of 4


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax(seed=0, m=None):
    model = jax_ts.make_tsception_model(C, T, n_classes=5, sfreq=SFREQ)
    if m is None:
        return model, model.init(jax.random.PRNGKey(seed))
    return model, jax_cv.stacked_init(model, jax.random.PRNGKey(seed), m)


def _port(params, state, n_models=None):
    mdef = make_tsception_model(C, T, 5, sfreq=SFREQ)
    module = mdef.build(n_models)
    mdef.load(module, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return mdef, module


def _x(b=6, seed=1, lead=()):
    return np.random.default_rng(seed).normal(size=lead + (b, C, T)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_and_state_match_jax(train):
    jmodel, (params, state) = _jax()
    x = _x()
    ref, ref_state = jmodel.apply(params, state, jnp.asarray(x), train=train)
    mdef, module = _port(params, state)
    module.train(train)
    with torch.no_grad():
        ours = module(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    ours_s, ref_s = _leaves(mdef.dump(module.state_dict())[1]), _leaves(ref_state)
    assert ours_s.keys() == ref_s.keys() and len(ours_s) == 4
    for k in ref_s:
        np.testing.assert_allclose(ours_s[k], ref_s[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_stacked_gradients_and_state_match_jax():
    """A stack of 2 (one grouped conv over the models) against
    ``jax.vmap`` of JAX's apply: train-mode logits, new state and the
    parameter gradients of a loss summed over the models."""
    jmodel, (params, state) = _jax(seed=2, m=2)
    x = _x(b=5, seed=3, lead=(2,))

    def loss(p):
        logits, ns = jax.vmap(lambda pp, ss, xx: jmodel.apply(pp, ss, xx, train=True))(
            p, state, jnp.asarray(x))
        return jnp.sum(logits ** 2), (logits, ns)

    (_, (ref, ref_state)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    mdef, module = _port(params, state, n_models=2)
    module.train()
    ours = module(torch.from_numpy(x))
    (ours ** 2).sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    got_p, got_s = mdef.dump({**{k: p.grad for k, p in module.named_parameters()},
                              **{k: b for k, b in module.named_buffers()}})
    for ours_t, ref_t in ((got_p, grads), (got_s, ref_state)):
        a, b = _leaves(ours_t), _leaves(ref_t)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_init_layout_matches_jax():
    """``tsception_init`` draws JAX's tree: keys, shapes, BN init; the
    conv weights within U(+-1/sqrt(fan_in))."""
    _, (params, state) = _jax()
    mdef = make_tsception_model(C, T, 5, sfreq=SFREQ)
    ours_p, ours_s = mdef.init(3, None)
    for got, want in ((ours_p, params), (ours_s, state)):
        a, b = _leaves(got), _leaves(want)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].shape == b[k].shape, k
    assert np.abs(ours_p["s1"]["w"]).max() <= 1 / np.sqrt(3 * 15 * C)
    stacked_p, _ = mdef.init(3, 2, total=4, offset=1)
    full_p, _ = mdef.init(3, 4)
    np.testing.assert_array_equal(stacked_p["t1"]["w"], full_p["t1"]["w"][1:3])
    assert TSception(C, T, sfreq=SFREQ).meta == jax_ts.tsception_meta(C, SFREQ)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {h: [r[i] for r in rows[1:]] for i, h in enumerate(rows[0])}


@pytest.fixture(scope="module")
def grouped_runs(tmp_path_factory):
    """Both packages' CV of 3 subjects x 10 trials in groups of 2 subjects
    (2 + 1), dropout off, 8 training trials in one batch of 8, 2 epochs,
    JAX's initial weights and state in both."""
    x, y = synthetic_corpus(4, 3, 10, C, T)
    subjects = ["01", "02", "03"]
    test = {sid: (x[i, :4], y[i, :4]) for i, sid in enumerate(subjects)}
    jax_model = jax_ts.make_tsception_model(C, T, n_classes=5, sfreq=SFREQ)
    params0, state0 = jax_cv.stacked_init(jax_model, jax.random.PRNGKey(5), 15)
    kw = dict(max_epochs=2, batch_size=8, learning_rate=1e-3, warmup_epochs=0,
              final_lr_scale=1.0, weight_decay=0.0, seed=42, n_folds=5, precision="f32")
    jdir, odir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    orig = jax_ts.tsception_apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ts, "tsception_apply", lambda *a, **k: orig(*a, **{**k, "dropout": 0.0}))
        ref = jax_cv.train_per_subject_cv(
            jax_model, jax_config.TrainConfig(**kw), x, y, subjects, 5, test_per_subject=test,
            save_dir=str(jdir), warm_start=(params0, state0), verbose=False,
            subject_group_size=2)
    ours = cv.train_per_subject_cv(
        make_tsception_model(C, T, 5, sfreq=SFREQ, dropout=0.0), config.TrainConfig(**kw), x, y,
        subjects, 5, test_per_subject=test, save_dir=str(odir),
        warm_start=(jax.tree.map(np.asarray, params0), jax.tree.map(np.asarray, state0)),
        verbose=False, subject_group_size=2, device="cpu")
    return ref, ours, str(jdir), str(odir)


def test_grouped_cv_matches_jax(grouped_runs):
    ref, ours, jdir, odir = grouped_runs
    assert ours.best_fold_per_subject == ref.best_fold_per_subject
    assert ours.meta == ref.meta
    for col in ("Best_Val_Acc", "Test_Acc", "Test_F1"):
        np.testing.assert_allclose([r[col] for r in ours.summary], ref.summary[col].to_numpy(),
                                   rtol=RTOL, err_msg=col)
    for name in ("summary_per_subject.csv", "sub-03/fold-4_history.csv",
                 "sub-01/fold_metrics.csv"):
        a, b = _read(os.path.join(odir, name)), _read(os.path.join(jdir, name))
        assert list(a) == list(b), name
        for col in b:
            if col != "Subject":
                np.testing.assert_allclose(np.array(a[col], float), np.array(b[col], float),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{name}:{col}")
    for name in ("sub-02/test_predictions.csv", "global_test_predictions.csv"):
        with open(os.path.join(odir, name)) as a, open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read(), name
    np.testing.assert_allclose(ours.fit.history["val_acc"], np.asarray(ref.fit.history["val_acc"]),
                               rtol=RTOL, atol=ATOL)
    for k in ours.fit.best_model_state:
        assert ours.fit.best_model_state[k].shape[0] == 15


def test_checkpoints_read_across_packages(grouped_runs):
    """``best_subject.npz`` holds ``state.bn_t.mean`` and the other state
    keys in both packages' files; each package reads the other's, and the
    weights and statistics agree."""
    _, _, jdir, odir = grouped_runs
    jmodel, (tp, ts) = _jax()
    mdef = make_tsception_model(C, T, 5, sfreq=SFREQ)
    np_tp, np_ts = mdef.init(0, None)
    for sid in ("01", "03"):
        ours_path = os.path.join(odir, f"sub-{sid}", "best_subject.npz")
        ref_path = os.path.join(jdir, f"sub-{sid}", "best_subject.npz")
        with np.load(ours_path) as a, np.load(ref_path) as b:
            assert sorted(a.files) == sorted(b.files)
            assert {"state.bn_t.mean", "state.bn_t.var", "state.bn_s.mean",
                    "state.bn_s.var"} <= set(a.files)
        jp, js, had = jax_ckpt.load_model_npz(ours_path, tp, ts)
        assert had and isinstance(js["bn_t"], JaxBNState)
        p, s, had2 = load_model_npz(ref_path, np_tp, np_ts)
        assert had2
        for a, b in ((_leaves(jp), _leaves(p)), (_leaves(js), _leaves(s))):
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-4, err_msg=k)


def test_cli_trees_match_jax(tmp_path, monkeypatch):
    """``cli.train_tsception --synthetic 2`` in both packages: the parser,
    the subjects, the files of the tree, the CSV columns and the test
    labels (the predictions and accuracies depend on ``jax.random``)."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type)
                for a in parser._actions if a.dest != "help"}

    assert options(train_tsception.build_parser()) == options(jax_cli.build_parser())
    for spec, n in (("0-2", 3), ("1,2", 3), (None, 2), ("1-9", 4)):
        assert train_tsception.parse_subjects(spec, n) == jax_cli._parse_subjects(spec, n)
    argv = ["--synthetic", "2", "--synthetic_trials", "10", "--epochs", "1", "--subjects", "0-1"]
    jdir, odir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr("imagined_speech_decoding_tpu.cli.enable_cache", lambda: None)
    jax_cli.main(argv + ["--output_dir", str(jdir)])
    res = train_tsception.main(argv + ["--output_dir", str(odir)], device="cpu")
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                             for r, _, fs in os.walk(d) for f in fs if not f.endswith(".png"))
    assert files(str(odir)) == files(str(jdir))
    assert [r["Subject"] for r in res.summary] == ["01"]
    for name in ("summary_per_subject.csv", "sub-01/fold-2_history.csv",
                 "sub-01/fold_metrics.csv", "sub-01/test_predictions.csv"):
        a, b = _read(str(odir / name)), _read(str(jdir / name))
        assert list(a) == list(b), name
        if "True" in b:  # the test labels of test_predictions.csv
            assert a["True"] == b["True"] and len(b["True"]) == 10  # [:20] of 10 trials
        if "Subject" in b:
            assert a["Subject"] == b["Subject"]
    with np.load(odir / "sub-01" / "best_subject.npz") as a, \
            np.load(jdir / "sub-01" / "best_subject.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape, k
