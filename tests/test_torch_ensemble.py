"""The port's seed ensemble (``train.ensemble``, ``engine.predict_proba``,
``cli/train_fast.py --ensemble``) on the CPU, against the JAX package:
``member_seed``; ``predict_proba`` on transplanted weights; member 0 of a
CLI ensemble equals a plain run bit for bit, and the root decision is the
argmax of the mean of the members' posteriors from their best
checkpoints; the soft vote and the root CSVs byte for byte against JAX's
on the same posteriors; ``n_members < 1`` raises."""

import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import engine as jax_engine
from imagined_speech_decoding_tpu.train import ensemble as jax_ensemble
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.config import FASTConfig, TrainConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import engine, ensemble
from imagined_speech_decoding_tpu_torch.train.artifacts import load_predictions_csv
from imagined_speech_decoding_tpu_torch.train.checkpoint import load_model_npz
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params, init_jax_layout_params

torch.set_num_threads(1)

SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.1,
)


@pytest.mark.parametrize("seed,member", [(42, 0), (42, 1), (0, 3), (7, 2)])
def test_member_seed_matches_jax(seed, member):
    assert ensemble.member_seed(seed, member) == jax_ensemble.member_seed(seed, member)
    assert ensemble.member_seed(seed, 0) == seed


@pytest.mark.parametrize("batch", [4, 64])
def test_predict_proba_matches_jax(batch):
    cfg = FASTConfig(**SMALL)
    params = init_jax_layout_params(cfg, 5)
    x = np.random.default_rng(0).normal(size=(10, 8, 200)).astype(np.float32)
    model = FAST(cfg)
    model.load_state_dict(from_jax_params(params))
    ours = engine.predict_proba(model, torch.from_numpy(x), batch)
    jmodel = make_fast_model(jax_config.FASTConfig(**SMALL))
    ref = jax_engine.predict_proba(jmodel.apply, params, {"head": {}}, jnp.asarray(x), batch)
    assert ours.shape == (10, 5) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours.sum(-1), 1.0, rtol=1e-6)
    bf16 = engine.predict_proba(model, torch.from_numpy(x).to(torch.bfloat16), batch)
    assert bf16.dtype == np.float32 and np.allclose(bf16.sum(-1), 1.0, rtol=1e-6)


def test_zero_members_raise():
    with pytest.raises(ValueError, match="n_members must be >= 1"):
        ensemble.train_seed_ensemble(FASTConfig(**SMALL), TrainConfig(), np.zeros((1, 2, 8, 200)),
                                     np.zeros((1, 2)), ["01"], 5, n_members=0, device="cpu")


# --- the soft vote against JAX's on the same posteriors -----------------------------

K, SUBS, N_TEST, MEMBERS = 2, ["01", "02", "03"], 7, 3


def _posteriors():
    rng = np.random.default_rng(11)
    p = rng.random((MEMBERS, len(SUBS), N_TEST, 5)).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _members(offset_by_member):
    """Stand-ins for the members' CV results: each member's best fold per
    subject, best val accuracies (f32), and 'parameters' that name the
    (member, stack row) they belong to."""
    rng = np.random.default_rng(3)
    out = []
    for e in range(MEMBERS):
        best_fold = {sid: int(rng.integers(0, K)) for sid in SUBS}
        acc = rng.random(len(SUBS) * K).astype(np.float32)
        out.append(SimpleNamespace(
            fit=SimpleNamespace(best_val_acc=acc,
                                best_params={"w": offset_by_member * e + np.arange(len(SUBS) * K)},
                                best_model_state={"s": np.arange(len(SUBS) * K)}),
            best_fold_per_subject=best_fold, member=e))
    return out


@pytest.fixture(scope="module")
def soft_votes(tmp_path_factory):
    root = tmp_path_factory.mktemp("soft_vote")
    post = _posteriors()
    rng = np.random.default_rng(5)
    test = {sid: (np.zeros((N_TEST, 8, 200), np.float32), rng.integers(0, 5, N_TEST).astype(np.uint8))
            for sid in SUBS}
    mp = pytest.MonkeyPatch()
    members = iter(_members(1000))
    mp.setattr(jax_ensemble, "train_per_subject_cv", lambda *a, **k: next(members))
    mp.setattr(jax_ensemble, "predict_proba",
               lambda apply, p, s, x, b: post[int(p["w"]) // 1000, int(p["w"]) % 1000 // K])
    try:
        ref = jax_ensemble.train_seed_ensemble(
            SimpleNamespace(apply=None), jax_config.TrainConfig(n_folds=K), None, None, SUBS, 5,
            test_per_subject=test, save_dir=str(root / "jax"), n_members=MEMBERS, verbose=False)
    finally:
        mp.undo()
    members = iter(_members(1000))
    mp.setattr(ensemble, "train_per_subject_cv", lambda *a, **k: next(members))
    mp.setattr(ensemble, "_best_fold_proba",
               lambda single, m, row, x, b: post[m.member, row // K])
    try:
        ours = ensemble.train_seed_ensemble(
            FASTConfig(**SMALL), TrainConfig(n_folds=K), None, None, SUBS, 5,
            test_per_subject=test, save_dir=str(root / "port"), n_members=MEMBERS,
            verbose=False, device="cpu")
    finally:
        mp.undo()
    return ours, ref, root, post


def test_soft_vote_posteriors_match_jax(soft_votes):
    ours, ref, _, post = soft_votes
    for si, sid in enumerate(SUBS):
        np.testing.assert_array_equal(ours.proba_per_subject[sid], ref.proba_per_subject[sid])
        np.testing.assert_array_equal(ours.proba_per_subject[sid], post[:, si].mean(0))


@pytest.mark.parametrize("rel", ["summary_per_subject.csv", "global_test_predictions.csv",
                                 os.path.join("sub-02", "test_predictions.csv")])
def test_root_csvs_equal_jax_byte_for_byte(soft_votes, rel):
    _, _, root, _ = soft_votes
    assert (root / "port" / rel).read_bytes() == (root / "jax" / rel).read_bytes()


def test_summary_rows_match_jax(soft_votes):
    ours, ref, _, _ = soft_votes
    assert tuple(ref.summary.columns) == ensemble.SUMMARY_COLUMNS
    for row, (_, ref_row) in zip(ours.summary, ref.summary.iterrows()):
        assert [row[c] for c in ensemble.SUMMARY_COLUMNS] == list(ref_row)


# --- the CLI: member 0 is the plain run ---------------------------------------------

SMALL_YAML = ("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n  num_heads: 4\n")
ARGV = ["--synthetic", "2", "--synthetic_trials", "15", "--epochs", "2", "--n_folds", "3",
        "--batch_size", "8"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ensemble_cli")
    cfg = root / "small.yaml"
    cfg.write_text(SMALL_YAML)
    argv = ARGV + ["--config", str(cfg)]
    ens = train_fast.main(argv + ["--ensemble", "2", "--output_dir", str(root / "ens")],
                          device="cpu")
    plain = train_fast.main(argv + ["--output_dir", str(root / "plain")], device="cpu")
    return ens, plain, root


@pytest.mark.parametrize("rel", ["summary_per_subject.csv", "global_test_predictions.csv",
                                 os.path.join("sub-02", "fold-1_history.csv"),
                                 os.path.join("sub-01", "best_subject.npz")])
def test_member_zero_equals_the_plain_run(cli_runs, rel):
    _, _, root = cli_runs
    assert (root / "ens" / "member-0" / rel).read_bytes() == (root / "plain" / rel).read_bytes()
    assert (root / "ens" / "member-1" / rel).exists()


def test_root_decision_is_the_mean_of_the_members_best_checkpoints(cli_runs):
    ens, _, root = cli_runs
    from imagined_speech_decoding_tpu_torch.cli.train_fast import load_data

    args = train_fast.build_parser().parse_args(ARGV)
    _, _, subjects, test = load_data(args)
    cfg = dataclasses.replace(FASTConfig.default(), dim_cnn=8, dim_token=16, num_layers=1,
                              num_heads=4)
    model = FAST(cfg)
    template = init_jax_layout_params(cfg, 0)
    for sid in subjects:
        x = torch.as_tensor(test[sid][0], dtype=torch.bfloat16)
        probs = []
        for e in range(2):
            params, _, _ = load_model_npz(
                str(root / "ens" / f"member-{e}" / f"sub-{sid}" / "best_subject.npz"), template,
                {"head": {}})
            model.load_state_dict(from_jax_params(params))
            probs.append(engine.predict_proba(model, x, 8))
        mean = np.mean(np.stack(probs), axis=0)
        np.testing.assert_array_equal(mean, ens.proba_per_subject[sid])
        pred, true = load_predictions_csv(str(root / "ens" / f"sub-{sid}" / "test_predictions.csv"))
        np.testing.assert_array_equal(pred, mean.argmax(-1))
        np.testing.assert_array_equal(true, test[sid][1])
    header = (root / "ens" / "summary_per_subject.csv").read_text().splitlines()[0]
    assert header == ",".join(ensemble.SUMMARY_COLUMNS)
