"""The PyTorch port's cross-validation driver, synthetic corpus, config
loading and training CLI (plain path on the CPU) against the JAX package
and sklearn."""

import csv
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.cli.train_fast import build_overrides as jax_build_overrides
from imagined_speech_decoding_tpu.cli.train_fast import build_parser as jax_build_parser
from imagined_speech_decoding_tpu.data.synthetic import synthetic_corpus as jax_synthetic_corpus
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu_torch import config
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import artifacts, cv
from imagined_speech_decoding_tpu_torch.train.checkpoint import load_model_npz
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params, init_jax_layout_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(  # tests/test_pallas_head.py:14-29
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
RTOL, ATOL = 1e-4, 1e-5


def read_csv(path):
    """Columns of a CSV file with a header row, as strings."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {h: [r[i] for r in rows[1:]] for i, h in enumerate(rows[0])}


@pytest.mark.parametrize("n,k,seed,shuffle", [
    (10, 5, 0, True), (350, 5, 42, True), (11, 3, 7, True), (7, 2, 1, True), (9, 4, 0, False),
])
def test_kfold_matches_sklearn(n, k, seed, shuffle):
    ours = cv.kfold_indices(n, k, seed, shuffle)
    ref = list(KFold(n_splits=k, shuffle=shuffle,
                     random_state=seed if shuffle else None).split(np.arange(n)))
    assert len(ours) == len(ref)
    for (tr, va), (rtr, rva) in zip(ours, ref):
        np.testing.assert_array_equal(tr, rtr)
        np.testing.assert_array_equal(va, rva)


def test_cv_index_stack_matches_jax():
    ours = cv.build_cv_index_stack(3, 20, 5, 42)
    ref = jax_cv.build_cv_index_stack(3, 20, 5, 42)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2] == ref[2]
    with pytest.raises(ValueError, match="not divisible"):
        cv.build_cv_index_stack(1, 11, 5, 0)


def test_synthetic_corpus_is_bit_equal_to_jax():
    ours = synthetic_corpus(3, 2, 12, 8, 160)
    ref = jax_synthetic_corpus(3, 2, 12, 8, 160)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


class TestTrainPerSubjectCV:
    """S = 2 subjects x 10 trials, 5 folds (8 train + 2 val trials each, so
    one full-batch step per epoch at batch 8), 2 epochs, dropout 0, the
    same stacked initial weights (JAX's ``stacked_init``) in both."""

    @pytest.fixture(scope="class")
    def runs(self, tmp_path_factory):
        jcfg = jax_config.FASTConfig(**SMALL)
        x, y = synthetic_corpus(0, 2, 10, 10, 200)
        subjects = ["01", "02"]
        test = {sid: (x[i, :4], y[i, :4]) for i, sid in enumerate(subjects)}
        model = make_fast_model(jcfg)
        params0, state0 = jax_cv.stacked_init(model, jax.random.PRNGKey(42), 10)
        jtc = jax_config.TrainConfig(max_epochs=2, batch_size=8, precision="f32",
                                     learning_rate=1e-3, warmup_epochs=1)
        jdir, odir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
        ref = jax_cv.train_per_subject_cv(
            model, jtc, x, y, subjects, 5, test_per_subject=test, save_dir=str(jdir),
            warm_start=(params0, state0), verbose=False,
        )
        tc = config.TrainConfig(**dataclasses.asdict(jtc))
        ours = cv.train_per_subject_cv(
            config.FASTConfig(**SMALL), tc, x, y, subjects, 5, test_per_subject=test,
            save_dir=str(odir), warm_start=jax.tree.map(np.asarray, params0), verbose=False,
            device="cpu",
        )
        return ref, ours, str(jdir), str(odir)

    def test_summary_and_best_folds_match_jax(self, runs):
        ref, ours, _, _ = runs
        assert ours.best_fold_per_subject == ref.best_fold_per_subject
        assert [r["Subject"] for r in ours.summary] == ref.summary["Subject"].tolist()
        for col in ("Best_Val_Acc", "Test_Acc", "Test_F1"):
            np.testing.assert_allclose([r[col] for r in ours.summary],
                                       ref.summary[col].to_numpy(), rtol=RTOL, err_msg=col)
        assert ours.meta == ref.meta

    def test_artifact_csvs_match_jax(self, runs):
        _, _, jdir, odir = runs
        for name in ("summary_per_subject.csv", "sub-01/fold_metrics.csv",
                     "sub-02/fold-3_history.csv", "sub-01/fold-0_history.csv"):
            ours, ref = read_csv(os.path.join(odir, name)), read_csv(os.path.join(jdir, name))
            assert list(ours) == list(ref), name
            for col in ref:
                if col == "Subject":
                    assert ours[col] == ref[col]
                    continue
                np.testing.assert_allclose(np.array(ours[col], float), np.array(ref[col], float),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{name}:{col}")

    def test_test_predictions_match_jax(self, runs):
        _, _, jdir, odir = runs
        for name in ("sub-01/test_predictions.csv", "sub-02/test_predictions.csv",
                     "global_test_predictions.csv"):
            with open(os.path.join(odir, name)) as a, open(os.path.join(jdir, name)) as b:
                assert a.read() == b.read(), name

    def test_best_checkpoint_loads_in_both_packages(self, runs):
        _, ours, jdir, odir = runs
        from imagined_speech_decoding_tpu.train import checkpoint as jax_ckpt

        template = init_jax_layout_params(config.FASTConfig(**SMALL), 0)
        path = os.path.join(odir, "sub-02", "best_subject.npz")
        params, state, had_state = load_model_npz(path, template, {"head": {}})
        assert had_state and state == {"head": {}}
        jparams, _, _ = jax_ckpt.load_model_npz(path, template, {"head": {}})
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b))
        ref_params, _, _ = load_model_npz(os.path.join(jdir, "sub-02", "best_subject.npz"),
                                          template, {"head": {}})
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(ref_params)):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
        FAST(config.FASTConfig(**SMALL)).load_state_dict(from_jax_params(params))


class TestConfig:
    def test_train_config_matches_jax(self):
        ours = [(f.name, f.default) for f in dataclasses.fields(config.TrainConfig)]
        theirs = [(f.name, f.default) for f in dataclasses.fields(jax_config.TrainConfig)]
        assert ours == theirs

    def test_defaults_equal_default_yaml(self):
        """What the CLI falls back to without PyYAML is what the file says."""
        path = os.path.join(ROOT, "configs", "default.yaml")
        ref = jax_config.load_config(path)
        ours = config.load_config(path)
        assert dataclasses.asdict(config.TrainConfig()) == dataclasses.asdict(ref.train)
        assert dataclasses.asdict(config.FASTConfig.default()) == dataclasses.asdict(ref.model)
        assert dataclasses.asdict(ours.train) == dataclasses.asdict(ref.train)
        assert dataclasses.asdict(ours.model) == dataclasses.asdict(ref.model)

    def test_overrides_match_jax(self, tmp_path):
        path = tmp_path / "c.yaml"
        path.write_text("model:\n  dim_cnn: 8\ntraining:\n  precision: 'bf16-mixed'\n"
                        "cv:\n  n_folds: 3\n  shuffle: false\n")
        over = {"max_epochs": 3, "batch_size": 16, "dropout": 0.2}
        ours, ref = config.load_config(str(path), over), jax_config.load_config(str(path), over)
        assert dataclasses.asdict(ours.train) == dataclasses.asdict(ref.train)
        assert dataclasses.asdict(ours.model) == dataclasses.asdict(ref.model)

    def test_precision(self):
        """bf16 (the default) and f32 train; another precision raises."""
        assert config.TrainConfig(precision="f32").compute_dtype is torch.float32
        assert config.TrainConfig().compute_dtype is torch.bfloat16
        with pytest.raises(ValueError, match="unknown precision"):
            config.TrainConfig(precision="f16").compute_dtype

    def test_without_pyyaml(self, monkeypatch, capsys):
        monkeypatch.setitem(sys.modules, "yaml", None)
        monkeypatch.chdir(ROOT)
        args = train_fast.build_parser().parse_args([])
        cfg = train_fast.resolve_config(args, {"max_epochs": 2})
        assert "built-in defaults" in capsys.readouterr().out
        assert cfg.train == config.TrainConfig(max_epochs=2)
        explicit = train_fast.build_parser().parse_args(
            ["--config", os.path.join(ROOT, "configs", "default.yaml")])
        with pytest.raises(ImportError):
            train_fast.resolve_config(explicit, {})


class TestCLI:
    def test_parser_matches_jax(self):
        def options(parser):
            return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type)
                    for a in parser._actions if a.dest != "help"}

        assert options(train_fast.build_parser()) == options(jax_build_parser())
        argv = ["--epochs", "3", "--batch_size", "8", "--seed", "1", "--n_folds", "2",
                "--precision", "f32", "--val_every", "1", "--learning_rate", "0.01",
                "--weight_decay", "0.1", "--head", "Conv4Layers"]
        assert train_fast.build_overrides(train_fast.build_parser().parse_args(argv)) == \
            jax_build_overrides(jax_build_parser().parse_args(argv))

    @pytest.mark.parametrize("argv", [
        ["--mesh", "data"],
        ["--synthetic", "1", "--mesh", "model"],
        ["--synthetic", "1", "--mesh", "2d"],
        ["--synthetic", "1", "--remat"],
        ["--synthetic", "1", "--head_chunk", "256"],
    ])
    def test_unported_options_raise(self, argv, tmp_path):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_fast.main(argv + ["--output_dir", str(tmp_path)])

    @pytest.mark.parametrize("argv", [
        [], ["--synthetic", "1", "--resume"], ["--synthetic", "1", "--checkpoint_every", "2"],
        ["--resume", "--checkpoint_every", "3", "--no-strict"],
        ["--synthetic", "1", "--loso-pretrain"], ["--synthetic", "1", "--ensemble", "2"],
        ["--synthetic", "1", "--hyperparams", "best.json"],
        ["--synthetic", "1", "--augment"], ["--synthetic", "1", "--head", "CVBlock"],
        ["--resume", "--head", "EEGNet_Encoder"],
        ["--synthetic", "1", "--profile", "p"],
        ["--synthetic", "1", "--loso-pretrain", "--head", "CVBlock"],
    ])
    def test_real_data_and_resume_are_ported(self, argv, tmp_path, monkeypatch):
        """Real data, ``--resume``, ``--checkpoint_every``, ``--loso-pretrain``
        (with a batch-norm head too), ``--ensemble``, ``--hyperparams``,
        ``--augment``, ``--profile`` and the batch-norm heads no longer raise
        ``NotImplementedError``: the CLI goes on to the device, which here
        is a missing card."""
        best = tmp_path / "best.json"
        best.write_text('{"learning_rate": 0.001, "weight_decay": 0.0}')
        argv = [str(best) if a == "best.json" else a for a in argv]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            train_fast.main(argv + ["--output_dir", str(tmp_path)])

    def test_bf16_is_ported(self, tmp_path, monkeypatch):
        """``--precision bf16`` (and the default, which is bf16) no longer
        raise ``NotImplementedError``: the CLI goes on to the device, which
        here is a missing card."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for precision in (["--precision", "bf16"], []):
            with pytest.raises(RuntimeError, match="is_available"):
                train_fast.main(["--synthetic", "1", *precision, "--config", "none.yaml",
                                 "--output_dir", str(tmp_path)])

    def test_no_cpu_fallback_without_a_card(self, tmp_path, monkeypatch):
        """The CLI and the CV driver train on CUDA unless told otherwise:
        with no card both raise instead of training on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            train_fast.main(["--synthetic", "1", "--synthetic_trials", "10", "--epochs", "1",
                             "--precision", "f32", "--output_dir", str(tmp_path)])
        x = np.zeros((1, 10, 10, 200), np.float32)
        y = np.zeros((1, 10), np.int64)
        with pytest.raises(RuntimeError, match="is_available"):
            cv.train_per_subject_cv(config.FASTConfig(**SMALL),
                                    config.TrainConfig(max_epochs=1, precision="f32"),
                                    x, y, ["01"], 5, verbose=False)

    def test_synthetic_run_writes_the_result_tree(self, tmp_path):
        """The CLI end to end on a 64-channel synthetic corpus with a narrow
        model from ``--config`` (FAST's widths cut for the CPU)."""
        cfg_path = tmp_path / "small.yaml"
        cfg_path.write_text("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n"
                            "  num_heads: 4\n")
        out = tmp_path / "out"
        res = train_fast.main(["--config", str(cfg_path), "--synthetic", "2",
                               "--synthetic_trials", "10", "--epochs", "2", "--batch_size", "8",
                               "--precision", "f32", "--label_noise", "0.2",
                               "--output_dir", str(out)], device="cpu")
        for sid in ("01", "02"):
            sub = out / f"sub-{sid}"
            names = [f"fold-{k}_history.csv" for k in range(5)]
            names += ["fold_metrics.csv", "best_subject.npz", "test_predictions.csv"]
            for name in names:
                assert (sub / name).is_file(), name
        assert (out / "summary_per_subject.csv").is_file()
        pred, true = artifacts.load_predictions_csv(str(out / "global_test_predictions.csv"))
        assert pred.shape == true.shape == (6,)
        assert all(np.isfinite(v).all() for v in res.fit.history.values())
        assert res.timings["data_s"] > 0 and len(res.timings["train_s"]) == 2
