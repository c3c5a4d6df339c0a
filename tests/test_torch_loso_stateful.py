"""LOSO pretraining of the batch-norm heads and of an augmented model
(``train.loso.pretrain_loso`` with a ``FASTConfig`` or a ``ModelDef``),
and ``cli.train_fast --loso-pretrain``'s warm start, against the JAX
package on the CPU.

- CVBlock and HeadConv_Paper_Version on an RNG-free trajectory (head
  dropout off in both packages, dropout 0, each model's training set in
  one batch, JAX's initial weights and state in both), 2 epochs: history,
  best epochs, the saved rows, and the final and best running statistics
  at rtol 1e-4 / atol 1e-5 (the attention's key bias, whose exact
  gradient is 0, within the summed learning rate: ROADMAP.md, Queue 3).
  Each ``Pretrain_excludes_sub*.npz`` holds the parameters only, as
  JAX's, and each package reads the other's files on its skip path.
- The CLI's warm start: the CV begins at the LOSO rows and at the
  initial running statistics of a fresh draw (JAX's ``stacked_init``
  state), not at LOSO's.
- The augmentation fault: ``--augment --loso-pretrain`` pretrains the
  augmented model. Its rows differ from the un-augmented ones at non-zero
  rates and equal them bit for bit at ``--noise_sigma 0 --ch_drop 0``.
- One augmented LOSO step against JAX's augmented LOSO on JAX's own
  permutations and augmentation draws (the test reproduces JAX's key
  splits and feeds the port those draws)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.data import arrays as jax_arrays
from imagined_speech_decoding_tpu.models import heads as jax_heads
from imagined_speech_decoding_tpu.models.api import make_augmented_model as jax_augmented
from imagined_speech_decoding_tpu.models.api import make_fast_model as jax_fast_model
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu.train import loso as jax_loso
from imagined_speech_decoding_tpu_torch import transplant
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
from imagined_speech_decoding_tpu_torch.models import heads
from imagined_speech_decoding_tpu_torch.models.api import make_augmented_model, make_fast_model
from imagined_speech_decoding_tpu_torch.ops import augment
from imagined_speech_decoding_tpu_torch.train import checkpoint, cv, engine, loso

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
SUBJECTS = ["01", "02", "03"]
SMALL = dict(  # zones of 3, 2, 4 and 1 channels, padded to 4
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
KW = dict(epochs=2, batch_size=32, learning_rate=1e-3, warmup_epochs=1, seed=42, verbose=False)
BN1 = {"CVBlock": "bn1", "HeadConv_Paper_Version": "norm1"}


def _no_head_dropout(mp):
    enc = jax_heads.HEAD_REGISTRY["CVBlock"]
    mp.setitem(jax_heads.HEAD_REGISTRY, "CVBlock",
               enc._replace(apply=functools.partial(enc.apply, dropout_rate=0.0)))
    mp.setattr(heads.CVBlockHead, "DROPOUT", 0.0)


def _jax_init(jcfg):
    """``cv.stacked_init``'s stand-in: JAX's initial weights and state."""
    def init(model, seed, n_models, **_):
        draw = jax_cv.stacked_init(jax_fast_model(jcfg), jax.random.PRNGKey(seed), n_models)
        return jax.tree.map(np.asarray, draw)
    return init


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_rows(ours, ref, lr_sum):
    """Parameter trees at rtol 1e-4 / atol 1e-5, but for the attention's
    key bias (``in_b[D:2D]``): its exact gradient is 0 (a softmax does not
    see a shift common to its logits), so AdamW moves it by rounding noise,
    up to the learning rate a step, differently in each package; it is
    held within the summed learning rate."""
    la, lb = _leaves(ours), _leaves(jax.tree.map(np.asarray, ref))
    assert la.keys() == lb.keys()
    d = SMALL["dim_token"]
    for k in lb:
        a, b = la[k], lb[k]
        if k.endswith("['in_b']"):
            assert np.abs(a[d:2 * d] - b[d:2 * d]).max() <= lr_sum, k
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module", params=list(BN1))
def runs(request, tmp_path_factory):
    """3 subjects x 10 trials: each LOSO row 15 training and 5 validation
    trials, one batch an epoch, 2 epochs, f32."""
    head = request.param
    root = tmp_path_factory.mktemp(f"loso_{head}")
    jcfg = jax_config.FASTConfig(**SMALL, head=head)
    cfg = FASTConfig(**SMALL, head=head)
    X, Y = synthetic_corpus(0, 3, 10, 10, 200)
    with pytest.MonkeyPatch.context() as mp:
        _no_head_dropout(mp)
        mp.setattr(cv, "stacked_init", _jax_init(jcfg))
        ours, res = loso.pretrain_loso(cfg, X, Y, SUBJECTS, 5, str(root / "port"),
                                       return_result=True, device="cpu", **KW)
        ref, ref_res = jax_loso.pretrain_loso(jax_fast_model(jcfg), X, Y, SUBJECTS, 5,
                                              str(root / "jax"), return_result=True, **KW)
    return head, cfg, jcfg, ours, res, ref, ref_res, root, (X, Y)


def test_pretrain_matches_jax(runs):
    head, _, _, ours, res, ref, ref_res, _, _ = runs
    for k in ("loss", "acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(res.history[k], np.asarray(ref_res.history[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(res.best_epoch, np.asarray(ref_res.best_epoch))
    for a, b in zip(ours, ref):
        _assert_rows(a, b, KW["learning_rate"] * KW["epochs"])


def test_running_statistics_match_jax(runs):
    """The LOSO stack's final and best running statistics, in the
    ``FitResult`` (the files do not hold them)."""
    head, _, _, _, res, _, ref_res, _, _ = runs
    for sd, ref_state in ((res.model_state, ref_res.model_state),
                          (res.best_model_state, ref_res.best_model_state)):
        got = _leaves(transplant.to_jax_state(sd))
        want = _leaves(jax.tree.map(np.asarray, ref_state))
        assert got.keys() == want.keys() and any(BN1[head] in k for k in got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert not np.allclose(res.model_state[f"head.{BN1[head]}.mean"].numpy(), 0.0)


def test_files_hold_params_only_and_read_across_packages(runs, monkeypatch):
    """Both packages write the same keys, none of the state's; each reads
    the other's files on its skip path and returns them exactly."""
    head, cfg, jcfg, ours, _, ref, _, root, (X, Y) = runs
    for sid in SUBJECTS:
        with np.load(root / "port" / f"Pretrain_excludes_sub{sid}.npz") as a, \
                np.load(root / "jax" / f"Pretrain_excludes_sub{sid}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            assert any(k.startswith(f"head.{BN1[head]}.") for k in a.files)
            assert not any(k.endswith((".mean", ".var")) for k in a.files)

    def no_fit(*a, **k):
        raise AssertionError("the skip path trained")

    monkeypatch.setattr(loso, "fit_segmented", no_fit)
    read = loso.pretrain_loso(cfg, X, Y, SUBJECTS, 5, str(root / "jax"), device="cpu", **KW)
    for a, b in zip(read, ref):
        la, lb = _leaves(a), _leaves(jax.tree.map(np.asarray, b))
        assert la.keys() == lb.keys()
        for k in lb:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    jax_read = jax_loso.pretrain_loso(jax_fast_model(jcfg), X, Y, SUBJECTS, 5,
                                      str(root / "port"), **KW)
    for a, b in zip(jax_read, ours):
        la, lb = _leaves(jax.tree.map(np.asarray, a)), _leaves(b)
        for k in lb:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


SMALL_YAML = ("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n  num_heads: 4\n"
              "  dropout: 0.0\n")
CLI = ["--synthetic", "3", "--synthetic_trials", "10", "--epochs", "1", "--batch_size", "8",
       "--precision", "f32", "--loso-pretrain", "--loso-epochs", "2"]


def _cli(tmp_path, name, extra, monkeypatch, capture=None):
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(SMALL_YAML)
    out = tmp_path / name
    if capture is not None:
        real = cv.train_per_subject_cv

        def spy(*a, **k):
            capture["warm_start"] = k["warm_start"]
            return real(*a, **k)

        monkeypatch.setattr(cv, "train_per_subject_cv", spy)
    train_fast.main(["--config", str(cfg_path)] + CLI + extra + ["--output_dir", str(out)],
                    device="cpu")
    rows = []
    for sid in SUBJECTS:
        with np.load(out / "loso_pretrain" / f"Pretrain_excludes_sub{sid}.npz") as f:
            rows.append({k: f[k] for k in f.files})
    with np.load(out / "loso_pretrain" / "checkpoints" / "segment_carry.npz") as f:
        final = {k: f[k] for k in f.files if k.startswith("carry.params.")}
    return rows + [final]


def test_cli_warm_start_takes_fresh_running_statistics(tmp_path, monkeypatch):
    """``--loso-pretrain --head CVBlock``: the CV's initial parameters are
    each subject's LOSO row repeated over its 5 folds; its initial state is
    the fresh draw's (JAX's ``stacked_init`` state: means 0, variances 1),
    not LOSO's moved statistics."""
    seen = {}
    rows = _cli(tmp_path, "out", ["--head", "CVBlock"], monkeypatch, capture=seen)[:-1]
    params0, state0 = seen["warm_start"]
    flat = checkpoint._flatten(params0)
    assert flat["head.bn1.scale"].shape[0] == 15 and flat.keys() == rows[0].keys()
    for si, row in enumerate(rows):
        for k, v in row.items():
            for fold in range(5):
                np.testing.assert_array_equal(flat[k][si * 5 + fold], v, err_msg=k)
    jcfg = jax_config.FASTConfig(**dataclasses.asdict(
        train_fast.resolve_config(train_fast.build_parser().parse_args(
            ["--config", str(tmp_path / "small.yaml"), "--head", "CVBlock"]),
            {"head": "CVBlock"}).model))
    _, want = jax_cv.stacked_init(jax_fast_model(jcfg), jax.random.PRNGKey(42), 15)
    got, ref = _leaves(state0), _leaves(jax.tree.map(np.asarray, want))
    assert got.keys() == ref.keys() and got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert not any(np.asarray(v).any() for k, v in got.items() if k.endswith("[0]"))


def test_cli_loso_pretrains_the_augmented_model(tmp_path, monkeypatch):
    """The fault this slice repaired: with ``--augment`` the LOSO stack was
    trained without augmentation. Now the rows and the stack's final
    parameters (its segment carry) at ``--noise_sigma 0.3 --ch_drop 0.2``
    differ from the un-augmented ones, and at rates 0 they equal them bit
    for bit (the model has no dropout, so the augmentation's draws are the
    only difference)."""
    plain = _cli(tmp_path, "plain", [], monkeypatch)
    aug = _cli(tmp_path, "aug", ["--augment", "--noise_sigma", "0.3", "--ch_drop", "0.2"],
               monkeypatch)
    zero = _cli(tmp_path, "zero", ["--augment", "--noise_sigma", "0", "--ch_drop", "0"],
                monkeypatch)
    for a, b, c in zip(plain, aug, zero):
        assert a.keys() == b.keys() == c.keys()
        assert any(not np.array_equal(a[k], b[k]) for k in a)
        for k in a:
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)


def test_augmented_loso_step_matches_jax_on_its_draws(tmp_path, monkeypatch):
    """One epoch of one step a row (3 subjects x 20 trials: 35 training
    trials a row in one batch) of the augmented LOSO stack against JAX's
    ``pretrain_loso`` of its augmented model: the port is handed JAX's
    permutation and augmentation draws of each row (``fold_in`` of the
    row's key at epoch 0, split into shuffle and step keys, the step key
    into augment and model halves). History and the saved rows at rtol
    1e-4 / atol 1e-5."""
    sigma, ch_drop = 0.2, 0.3
    kw = dict(epochs=1, batch_size=64, learning_rate=1e-3, warmup_epochs=0, seed=42,
              verbose=False)
    cfg = FASTConfig(**SMALL, head="Conv4Layers")
    jcfg = jax_config.FASTConfig(**SMALL, head="Conv4Layers")
    X, Y = synthetic_corpus(1, 3, 20, 10, 200)
    ref, ref_res = jax_loso.pretrain_loso(jax_augmented(jax_fast_model(jcfg), sigma, ch_drop),
                                          X, Y, SUBJECTS, 5, str(tmp_path / "jax"),
                                          return_result=True, **kw)
    tr, _ = loso.build_loso_index_stack(Y, seed=42)
    n_train = tr.shape[1]
    perms, noises, keeps = [], [], []
    for key in jax.random.split(jax.random.PRNGKey(43), 3):
        kshuf, kstep = jax.random.split(jax.random.fold_in(key, 0))
        perms.append(np.asarray(jax_arrays.shuffled_epoch_indices(kshuf, n_train, 64)[0][0,
                                                                                       :n_train]))
        k_aug = jax.random.split(jax.random.split(kstep, 1)[0])[0]
        k1, k2 = jax.random.split(k_aug)
        noises.append(np.array(jax.random.normal(k1, (n_train, 10, 200))))
        keeps.append(np.array(jax.random.bernoulli(k2, 1.0 - ch_drop, (n_train, 10))))
    monkeypatch.setattr(engine, "epoch_permutations",
                        lambda gen, m, n: torch.as_tensor(np.stack(perms), dtype=torch.long))
    monkeypatch.setattr(engine, "augment_batch", lambda xb, s, p, gen: augment.augment_with_draws(
        xb, torch.from_numpy(np.stack(noises)), torch.from_numpy(np.stack(keeps)), s))
    monkeypatch.setattr(cv, "stacked_init", _jax_init(jcfg))
    mdef = make_augmented_model(make_fast_model(cfg), sigma, ch_drop)
    ours, res = loso.pretrain_loso(mdef, X, Y, SUBJECTS, 5, str(tmp_path / "port"),
                                   return_result=True, device="cpu", **kw)
    for k in ("loss", "acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(res.history[k], np.asarray(ref_res.history[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for a, b in zip(ours, ref):
        _assert_rows(a, b, kw["learning_rate"])
    plain = loso.pretrain_loso(cfg, X, Y, SUBJECTS, 5, str(tmp_path / "plain"), device="cpu",
                               **kw)
    assert any(not np.array_equal(_leaves(a)[k], _leaves(b)[k])
               for a, b in zip(ours, plain) for k in _leaves(a))
