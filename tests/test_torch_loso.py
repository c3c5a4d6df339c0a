"""The port's LOSO pretraining (``train.loso``) on the CPU, against the JAX
package: the stratified index stack index for index (sklearn's split,
restated), ``pretrain_loso`` on an RNG-free trajectory (dropout 0, each
model's training set in one batch, the JAX package's initial weights
transplanted), each package reading the other's checkpoints, the
skip-if-all-exist path training nothing, and ``stack_pretrained_for_cv``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu.train import loso as jax_loso
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
from imagined_speech_decoding_tpu_torch.train import cv, loso
from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout_params

torch.set_num_threads(1)

SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
CFG = FASTConfig(**SMALL)
SUBJECTS = ["01", "02", "03"]


@pytest.mark.parametrize("s,n,seed", [(3, 20, 42), (4, 37, 0), (15, 350, 42), (5, 13, 7),
                                      (2, 60, 123)])
def test_index_stack_equals_jax(s, n, seed):
    y = np.random.default_rng(seed).integers(0, 5, (s, n))
    ours = loso.build_loso_index_stack(y, seed=seed)
    ref = jax_loso.build_loso_index_stack(y, seed=seed)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for row, (tr, va) in enumerate(zip(*ours)):
        assert not np.isin(np.arange(row * n, (row + 1) * n), np.r_[tr, va]).any()
        assert np.intersect1d(tr, va).size == 0


def test_full_width_split_sizes():
    """15 subjects x 350 trials: 4,410 training and 490 validation trials a model."""
    y = np.random.default_rng(0).integers(0, 5, (15, 350))
    tr, va = loso.build_loso_index_stack(y)
    assert tr.shape == (15, 4410) and va.shape == (15, 490)


def test_stratified_split_refuses_a_singleton_class():
    with pytest.raises(ValueError, match="at least 2 members"):
        loso.stratified_split(np.asarray([0, 0, 1, 1, 2]), 2, 0)


def _jax_init(cfg, seed, n_models):
    model = make_fast_model(jax_config.FASTConfig(**dataclasses.asdict(cfg)))
    params, _ = jax_cv.stacked_init(model, jax.random.PRNGKey(seed), n_models)
    return jax.tree.map(np.asarray, params)


KW = dict(epochs=3, batch_size=64, learning_rate=1e-3, warmup_epochs=1, seed=42, verbose=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loso")
    X, Y = synthetic_corpus(0, 3, 20, 8, 200)
    mp = pytest.MonkeyPatch()
    mp.setattr(cv, "stacked_init", _jax_init)
    try:
        ours, res = loso.pretrain_loso(CFG, X, Y, SUBJECTS, 5, str(root / "port"),
                                       return_result=True, device="cpu", **KW)
    finally:
        mp.undo()
    model = make_fast_model(jax_config.FASTConfig(**SMALL))
    ref, ref_res = jax_loso.pretrain_loso(model, X, Y, SUBJECTS, 5, str(root / "jax"),
                                          return_result=True, **KW)
    return ours, res, ref, ref_res, root, (X, Y)


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def test_pretrain_matches_jax(runs):
    ours, res, ref, ref_res, _, _ = runs
    for k in ("loss", "val_loss", "val_acc"):
        np.testing.assert_allclose(res.history[k], np.asarray(ref_res.history[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(res.best_epoch, np.asarray(ref_res.best_epoch))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert jax.tree.structure(a) == jax.tree.structure(jax.tree.map(np.asarray, b))
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5)


def test_checkpoints_have_the_jax_keys(runs):
    *_, root, _ = runs
    for sid in SUBJECTS:
        with np.load(root / "port" / f"Pretrain_excludes_sub{sid}.npz") as a, \
                np.load(root / "jax" / f"Pretrain_excludes_sub{sid}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_each_package_reads_the_others_checkpoints_without_training(runs, monkeypatch):
    """On files of the other package both calls take the skip path and return
    those files' weights exactly; the port's never reaches its fit."""
    ours, _, ref, _, root, (X, Y) = runs

    def no_fit(*a, **k):
        raise AssertionError("the skip path trained")

    monkeypatch.setattr(loso, "fit_segmented", no_fit)
    read = loso.pretrain_loso(CFG, X, Y, SUBJECTS, 5, str(root / "jax"), device="cpu", **KW)
    for a, b in zip(read, ref):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)
    again = loso.pretrain_loso(CFG, X, Y, SUBJECTS, 5, str(root / "port"), device="cpu", **KW)
    for a, b in zip(again, ours):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)
    model = make_fast_model(jax_config.FASTConfig(**SMALL))
    jax_read = jax_loso.pretrain_loso(model, X, Y, SUBJECTS, 5, str(root / "port"), **KW)
    for a, b in zip(jax_read, ours):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_stack_pretrained_for_cv_matches_jax():
    trees = [init_jax_layout_params(CFG, s) for s in range(3)]
    ours = loso.stack_pretrained_for_cv(trees, 4)
    ref = jax_loso.stack_pretrained_for_cv(trees, 4)
    assert jax.tree.structure(ours) == jax.tree.structure(jax.tree.map(np.asarray, ref))
    for a, b in zip(_leaves(ours), _leaves(ref)):
        assert a.shape[0] == 12
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours["head"]["cnn1"]["w"][5], trees[1]["head"]["cnn1"]["w"])


def test_warm_start_begins_at_the_pretrained_rows(runs, tmp_path):
    """``train_per_subject_cv(warm_start=stack_pretrained_for_cv(...))``
    starts each (subject, fold) row at its subject's pretrained model: a
    0-learning-rate run ends where it began."""
    ours, _, _, _, _, (X, Y) = runs
    from imagined_speech_decoding_tpu_torch.config import TrainConfig

    tc = TrainConfig(max_epochs=1, batch_size=64, n_folds=2, precision="f32", learning_rate=0.0,
                     weight_decay=0.0)
    warm = loso.stack_pretrained_for_cv(ours, 2)
    res = cv.train_per_subject_cv(CFG, tc, X, Y, SUBJECTS, 5, warm_start=warm, device="cpu",
                                  verbose=False)
    from imagined_speech_decoding_tpu_torch.transplant import to_jax_params

    for a, b in zip(_leaves(to_jax_params(res.fit.params)), _leaves(warm)):
        np.testing.assert_array_equal(a, b)


def test_pretrain_needs_the_card_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    X, Y = synthetic_corpus(0, 2, 10, 8, 200)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        loso.pretrain_loso(CFG, X, Y, ["01", "02"], 5, str(tmp_path))
