"""The batch-norm heads through the port's CV driver and CLI against the
JAX package on the CPU: a per-subject CV run of each head without
randomness (head dropout off in both packages, each fold's training set
in one batch, JAX's initial weights and state in both), its result tree
and its ``best_subject.npz`` (with ``state.head.bn1.mean`` and the other
state keys) read across packages both ways; and ``cli.train_fast
--head CVBlock`` on a synthetic tree against the JAX CLI's, the parts
that do not depend on ``jax.random``."""

import csv
import functools
import os

import jax
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.cli import train_fast as jax_train_fast
from imagined_speech_decoding_tpu.models import heads as jax_heads
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.ops.norm import BNState as JaxBNState
from imagined_speech_decoding_tpu.train import checkpoint as jax_ckpt
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu_torch import config, transplant
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
from imagined_speech_decoding_tpu_torch.models import heads
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.norm import BNState
from imagined_speech_decoding_tpu_torch.train import cv
from imagined_speech_decoding_tpu_torch.train.checkpoint import load_model_npz

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
HEADS = ["CVBlock", "EEGNet_Encoder", "HeadConv_Paper_Version"]
SMALL = dict(  # zones of 3, 2, 4 and 1 channels, padded to 4
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
BN1 = {"CVBlock": "bn1", "EEGNet_Encoder": "bn1", "HeadConv_Paper_Version": "norm1"}


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {h: [r[i] for r in rows[1:]] for i, h in enumerate(rows[0])}


def _no_head_dropout(mp):
    """CVBlock's and EEGNet_Encoder's fixed head dropout off in both packages."""
    for name in ("CVBlock", "EEGNet_Encoder"):
        enc = jax_heads.HEAD_REGISTRY[name]
        mp.setitem(jax_heads.HEAD_REGISTRY, name,
                   enc._replace(apply=functools.partial(enc.apply, dropout_rate=0.0)))
    mp.setattr(heads.CVBlockHead, "DROPOUT", 0.0)
    mp.setattr(heads.EEGNetEncoderHead, "DROPOUT", 0.0)


@pytest.fixture(scope="module", params=HEADS)
def runs(request, tmp_path_factory):
    """S = 2 subjects x 10 trials, 5 folds (8 train + 2 val trials, one
    full-batch step an epoch), 2 epochs, f32."""
    head = request.param
    kw = dict(SMALL, head=head)
    jcfg = jax_config.FASTConfig(**kw)
    x, y = synthetic_corpus(0, 2, 10, 10, 200)
    subjects = ["01", "02"]
    test = {sid: (x[i, :4], y[i, :4]) for i, sid in enumerate(subjects)}
    model = make_fast_model(jcfg)
    params0, state0 = jax_cv.stacked_init(model, jax.random.PRNGKey(42), 10)
    jtc = jax_config.TrainConfig(max_epochs=2, batch_size=8, precision="f32",
                                 learning_rate=1e-3, warmup_epochs=1)
    jdir, odir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        _no_head_dropout(mp)
        ref = jax_cv.train_per_subject_cv(
            model, jtc, x, y, subjects, 5, test_per_subject=test, save_dir=str(jdir),
            warm_start=(params0, state0), verbose=False)
        ours = cv.train_per_subject_cv(
            config.FASTConfig(**kw), config.TrainConfig(**jtc.__dict__), x, y, subjects, 5,
            test_per_subject=test, save_dir=str(odir),
            warm_start=(jax.tree.map(np.asarray, params0), jax.tree.map(np.asarray, state0)),
            verbose=False, device="cpu")
    return head, ref, ours, str(jdir), str(odir)


def test_summary_history_and_predictions_match_jax(runs):
    head, ref, ours, jdir, odir = runs
    assert ours.best_fold_per_subject == ref.best_fold_per_subject
    for col in ("Best_Val_Acc", "Test_Acc", "Test_F1"):
        np.testing.assert_allclose([r[col] for r in ours.summary], ref.summary[col].to_numpy(),
                                   rtol=RTOL, err_msg=col)
    for name in ("summary_per_subject.csv", "sub-01/fold_metrics.csv",
                 "sub-02/fold-3_history.csv", "sub-01/fold-0_history.csv"):
        a, b = _read(os.path.join(odir, name)), _read(os.path.join(jdir, name))
        assert list(a) == list(b), name
        for col in b:
            if col != "Subject":
                np.testing.assert_allclose(np.array(a[col], float), np.array(b[col], float),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{head} {name}:{col}")
    for name in ("sub-01/test_predictions.csv", "global_test_predictions.csv"):
        with open(os.path.join(odir, name)) as a, open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read(), name


def test_fit_state_matches_jax(runs):
    """The final and best running statistics of all 10 models."""
    head, ref, ours, _, _ = runs
    for ours_sd, ref_state in ((ours.fit.model_state, ref.fit.model_state),
                               (ours.fit.best_model_state, ref.fit.best_model_state)):
        got = transplant.to_jax_state(ours_sd)["head"]
        want = ref_state["head"]
        assert sorted(got) == sorted(want) and got
        for name in want:
            for field in ("mean", "var"):
                np.testing.assert_allclose(getattr(got[name], field),
                                           np.asarray(getattr(want[name], field)),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{head} {name}")


def test_best_checkpoints_read_across_packages(runs):
    """Both packages' ``best_subject.npz`` hold the same keys, the state's
    among them; the JAX loader reads the port's file into ``BNState``
    leaves, the port's loader reads JAX's, and the two agree; a FAST with
    the loaded params and state reproduces the subject's test predictions."""
    head, _, ours, jdir, odir = runs
    cfg = config.FASTConfig(**dict(SMALL, head=head))
    jcfg = jax_config.FASTConfig(**dict(SMALL, head=head))
    jp0, js0 = make_fast_model(jcfg).init(jax.random.PRNGKey(0))
    sd = FAST(cfg).state_dict()
    tp, ts = transplant.to_jax_params(sd), transplant.to_jax_state(sd)
    for sid in ("01", "02"):
        ours_path = os.path.join(odir, f"sub-{sid}", "best_subject.npz")
        ref_path = os.path.join(jdir, f"sub-{sid}", "best_subject.npz")
        with np.load(ours_path) as a, np.load(ref_path) as b:
            assert sorted(a.files) == sorted(b.files)
            assert {f"state.head.{BN1[head]}.mean", f"state.head.{BN1[head]}.var"} <= set(a.files)
        jp, js, had = jax_ckpt.load_model_npz(ours_path, jp0, js0)
        assert had and isinstance(js["head"][BN1[head]], JaxBNState)
        p, s, had2 = load_model_npz(ref_path, tp, ts)
        assert had2 and isinstance(s["head"][BN1[head]], BNState)
        for a, b in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((p, s))):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-3, atol=1e-4)
        mine, mine_s, _ = load_model_npz(ours_path, tp, ts)
        model = FAST(cfg).eval()
        model.load_state_dict(transplant.from_jax_params(mine, mine_s))
        x, _ = synthetic_corpus(0, 2, 10, 10, 200)
        with torch.no_grad():
            pred = model(torch.from_numpy(x[int(sid) - 1, :4])).argmax(-1).numpy()
        y_pred, _ = np.loadtxt(os.path.join(odir, f"sub-{sid}", "test_predictions.csv"),
                               delimiter=",", skiprows=1, dtype=int, ndmin=2).T
        np.testing.assert_array_equal(pred, y_pred)


def test_cli_head_tree_matches_jax(tmp_path, monkeypatch):
    """``cli.train_fast --head CVBlock --synthetic 2`` in both packages from
    one config: the files of the tree, the CSV columns, the subjects, the
    test labels and ``best_subject.npz``'s keys and shapes (the numbers
    depend on ``jax.random``)."""
    path = tmp_path / "small.yaml"
    path.write_text("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n  num_heads: 4\n")
    argv = ["--config", str(path), "--synthetic", "2", "--synthetic_trials", "10", "--epochs",
            "1", "--batch_size", "8", "--precision", "f32", "--head", "CVBlock"]
    jdir, odir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr("imagined_speech_decoding_tpu.cli.enable_cache", lambda: None)
    jax_train_fast.main(argv + ["--output_dir", str(jdir)])
    res = train_fast.main(argv + ["--output_dir", str(odir)], device="cpu")
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                             for r, _, fs in os.walk(d) for f in fs
                             if not f.endswith(".png") and "checkpoints" not in r)
    assert files(str(odir)) == files(str(jdir))
    assert [r["Subject"] for r in res.summary] == ["01", "02"]
    for name in ("summary_per_subject.csv", "sub-02/fold-4_history.csv",
                 "sub-01/fold_metrics.csv", "global_test_predictions.csv"):
        a, b = _read(str(odir / name)), _read(str(jdir / name))
        assert list(a) == list(b), name
        for col in ("Subject", "True"):
            if col in b:
                assert a[col] == b[col], (name, col)
    with np.load(odir / "sub-01" / "best_subject.npz") as a, \
            np.load(jdir / "sub-01" / "best_subject.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "state.head.bn3.var" in a.files
        for k in b.files:
            assert a[k].shape == b[k].shape, k
