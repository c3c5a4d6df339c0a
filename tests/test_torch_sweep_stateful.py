"""The hyperparameter sweep of the batch-norm heads (``train.sweep.cv_sweep``
with a ``FASTConfig`` or a ``ModelDef``, ``cli.sweep`` with the head of
its ``--config``) against the JAX package on the CPU, and the running
statistics through its rows and segments.

- ``cv_sweep`` of HeadConv_Paper_Version and ``cli.sweep --config``
  (``head: CVBlock``) against JAX's on an RNG-free trajectory (head
  dropout off in both packages, dropout 0, each fold's training set in
  one batch, JAX's initial weights and state in both): per-fold best
  accuracies and histories at rtol 1e-4 / atol 1e-5, the CLI's
  ``sweep_results.csv`` and ``best.json`` too.
- With CVBlock's head dropout on: a segmented sweep equals the whole run
  bit for bit (parameters, best snapshots, running statistics, history),
  and two grid rows of one (lr, wd) train bit for bit alike, their
  running statistics too (the rows share their fold's draws)."""

import csv
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.cli import sweep as jax_cli_sweep
from imagined_speech_decoding_tpu.models import heads as jax_heads
from imagined_speech_decoding_tpu.models.api import make_fast_model as jax_fast_model
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu.train import sweep as jax_sweep
from imagined_speech_decoding_tpu_torch.cli import sweep as cli_sweep
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_trials
from imagined_speech_decoding_tpu_torch.models import heads
from imagined_speech_decoding_tpu_torch.models.api import make_fast_model
from imagined_speech_decoding_tpu_torch.train import cv, sweep

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
GRID = dict(lr_scales=[0.5, 4.0], wd_scales=[0.0, 10.0], n_folds=2, epochs=3, batch_size=16,
            seed=42)


def _no_head_dropout(mp):
    enc = jax_heads.HEAD_REGISTRY["CVBlock"]
    mp.setitem(jax_heads.HEAD_REGISTRY, "CVBlock",
               enc._replace(apply=functools.partial(enc.apply, dropout_rate=0.0)))
    mp.setattr(heads.CVBlockHead, "DROPOUT", 0.0)


def _jax_init(model, seed, n_models, **_):
    """``cv.stacked_init``'s stand-in: JAX's initial weights and state."""
    cfg = model if isinstance(model, FASTConfig) else model.build().cfg
    jmodel = jax_fast_model(jax_config.FASTConfig(**dataclasses.asdict(cfg)))
    return jax.tree.map(np.asarray,
                        jax_cv.stacked_init(jmodel, jax.random.PRNGKey(seed), n_models))


def _assert_reports(ours, ref):
    np.testing.assert_allclose(ours.fold_val_acc, np.asarray(ref.fold_val_acc), rtol=RTOL)
    assert ours.best_index == ref.best_index
    for k in ("loss", "acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(ours.history[k], np.asarray(ref.history[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_headconv_sweep_matches_jax(monkeypatch):
    """``cv_sweep`` of a ``ModelDef`` with HeadConv_Paper_Version (no
    dropout of its own) against JAX's ``cv_sweep``: 2 lr x 2 wd x 2 folds,
    3 epochs; its rows' running statistics moved from the initial state."""
    kw = dict(SMALL, head="HeadConv_Paper_Version")
    x, y = synthetic_trials(0, 20, 8, 200, 5)
    monkeypatch.setattr(cv, "stacked_init", _jax_init)
    ours = sweep.cv_sweep(make_fast_model(FASTConfig(**kw)), 5, x, y.astype(np.int64),
                          n_trials=20, device="cpu", **GRID)
    ref = jax_sweep.cv_sweep(jax_fast_model(jax_config.FASTConfig(**kw)), 5, jnp.asarray(x),
                             jnp.asarray(y.astype(np.int32)), n_trials=20, **GRID)
    _assert_reports(ours, ref)
    mean = ours.fit.model_state["head.norm1.mean"]
    assert mean.shape[0] == 8 and mean.abs().max() > 0


SMALL_YAML = """model:
  electrodes: [C1, C2, C3, C4, P1, P2, O1, O2]
  zone_dict: {Central: [C1, C2, C3, C4], Parietal: [P1, P2], Occipital: [O1, O2]}
  dim_cnn: 8
  dim_token: 16
  seq_len: 200
  window_len: 100
  slide_step: 50
  num_layers: 1
  num_heads: 4
  dropout: 0.0
  head: CVBlock
"""
ARGV = ["--synthetic", "20", "--lr_scales", "0.5,4", "--wd_scales", "0,10", "--n_folds", "2",
        "--epochs", "3", "--batch_size", "16", "--precision", "f32", "--segment_epochs", "1"]


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], float)


def test_cli_sweeps_the_configs_head_as_jax(tmp_path, monkeypatch):
    """``cli.sweep --config`` with ``head: CVBlock`` in both packages, in
    segments of one epoch: the port's stack is CVBlock's (its running
    statistics in the fit), and ``sweep_results.csv``, ``best.json`` and
    the histories equal JAX's at rtol 1e-4."""
    cfg_path = tmp_path / "cvblock.yaml"
    cfg_path.write_text(SMALL_YAML)
    argv = ARGV + ["--config", str(cfg_path)]
    _no_head_dropout(monkeypatch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cv, "stacked_init", _jax_init)
        ours = cli_sweep.main(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")
    ref = jax_cli_sweep.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert "head.bn1.mean" in ours.fit.model_state
    _assert_reports(ours, ref)
    head, got = _read_csv(tmp_path / "port" / "sweep_results.csv")
    ref_head, want = _read_csv(tmp_path / "jax" / "sweep_results.csv")
    assert head == ref_head and got.shape == want.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    a = json.loads((tmp_path / "port" / "best.json").read_text())
    b = json.loads((tmp_path / "jax" / "best.json").read_text())
    assert list(a) == list(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)


def _cvblock_sweep(**kw):
    x, y = synthetic_trials(1, 20, 8, 200, 5)
    return sweep.cv_sweep(FASTConfig(**dict(SMALL, head="CVBlock", dropout=0.1)), 5, x,
                          y.astype(np.int64), n_trials=20, n_folds=2, epochs=3, batch_size=8,
                          seed=7, device="cpu", **kw)


def _fits_equal(a, b, rows_a=slice(None), rows_b=slice(None)):
    for which in ("params", "best_params", "model_state", "best_model_state"):
        da, db = getattr(a, which), getattr(b, which)
        assert da.keys() == db.keys() and da, which
        for k in da:
            assert torch.equal(da[k][rows_a], db[k][rows_b]), (which, k)


def test_segmented_sweep_equals_the_whole_run_with_the_statistics():
    """CVBlock with its head dropout and the trunk's on, two steps an
    epoch: segments of one epoch (the running statistics ride in the
    carry) end where the whole run ends, bit for bit."""
    grid = dict(lr_scales=[1.0, 2.0], wd_scales=[1.0])
    whole = _cvblock_sweep(**grid)
    seg = _cvblock_sweep(segment_epochs=1, **grid)
    _fits_equal(whole.fit, seg.fit)
    for k in whole.history:
        np.testing.assert_array_equal(whole.history[k], seg.history[k], err_msg=k)
    assert whole.fit.model_state["head.bn1.mean"].abs().max() > 0


def test_duplicated_rows_train_alike_with_their_statistics():
    """Two grid rows of one (lr, wd), dropout on: the second config's two
    fold rows equal the first's, running statistics and history too."""
    dup = _cvblock_sweep(lr_scales=[1.0, 1.0], wd_scales=[1.0])
    _fits_equal(dup.fit, dup.fit, slice(0, 2), slice(2, 4))
    for k, v in dup.history.items():
        np.testing.assert_array_equal(v[0], v[1], err_msg=k)
    assert not torch.equal(dup.fit.params["head.conv1.w"][0], dup.fit.params["head.conv1.w"][1])
