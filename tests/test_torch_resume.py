"""Segment checkpoints and resume in the port (``engine.fit_segmented``,
``train.cv``, ``cli/train_fast.py --resume``), on the CPU.

A run that crashes in its second segment (raised from the progress
callback) and is resumed from its checkpoint in a new model and
optimizer ends bit for bit (``torch.equal``) as the uninterrupted run,
in f32 and bf16, dropout on: parameters, best snapshot, best accuracies
and epochs, history. ``resume=False`` starts fresh; ``checkpoint_every``
thins the writes and the last segment always writes; a failed write
raises at the next boundary and stops the run; segment lengths equal the
JAX package's ``_segment_length``. Then ``train_per_subject_cv`` crashed
and resumed, and the CLI on a raw tree at the documented schema."""

import os

import numpy as np
import pytest
import torch

from bcic_fixture import SUBJECTS, write_tree
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.config import FASTConfig, TrainConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import checkpoint, cv, engine
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params, init_jax_layout_params

torch.set_num_threads(1)

SMALL = dict(  # tests/test_pallas_head.py:14-29, with dropout on
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.1,
)
M, N_TRIALS, N_TRAIN = 3, 24, 16


class Crash(Exception):
    pass


def _data(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N_TRIALS, 10, 200)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.integers(0, 5, N_TRIALS))
    perms = np.stack([rng.permutation(N_TRIALS) for _ in range(M)])
    return x, y, perms[:, :N_TRAIN], perms[:, N_TRAIN:]


def _run(dtype, total=6, seg=2, crash_at=None, **kw):
    """A fresh model and fit, as a new process would make them."""
    x, y, tidx, vidx = _data(dtype)
    model = FAST(FASTConfig(**SMALL), n_models=M)
    model.load_state_dict(from_jax_params(init_jax_layout_params(FASTConfig(**SMALL), 1, M)))
    fit = engine.make_fit(model, 5, epochs=seg, batch_size=8, n_train=N_TRAIN,
                          n_val=N_TRIALS - N_TRAIN, learning_rate=1e-3, warmup_epochs=1,
                          total_epochs=total)
    epochs_run = []

    def progress(epoch, val_acc):
        epochs_run.append(epoch)
        if epoch == crash_at:
            raise Crash(epoch)

    res = engine.fit_segmented(fit, tidx, vidx, x, y, seed=2, progress=progress, **kw)
    return res, epochs_run


def _assert_same(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.best_params[k], b.best_params[k]), k
    np.testing.assert_array_equal(a.best_val_acc, b.best_val_acc)
    np.testing.assert_array_equal(a.best_epoch, b.best_epoch)
    assert a.history.keys() == b.history.keys()
    for k in a.history:
        assert a.history[k].shape == b.history[k].shape, k
        np.testing.assert_array_equal(a.history[k], b.history[k], err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_crash_and_resume_equals_the_uninterrupted_run(tmp_path, dtype):
    ref, _ = _run(dtype)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        _run(dtype, crash_at=3, checkpoint_dir=ckpt)  # in the second segment
    path = os.path.join(ckpt, "segment_carry.npz")
    with np.load(path) as f:
        assert int(f["meta.next_segment"]) == 1 and int(f["carry.epoch"]) == 2
    resumed, epochs_run = _run(dtype, checkpoint_dir=ckpt, resume=True)
    assert epochs_run == [3, 4, 5, 6]
    _assert_same(resumed, ref)
    assert np.isfinite(ref.history["loss"]).all() and ref.history["loss"].shape == (M, 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_carry_written_is_a_private_copy(dtype):
    """What the background writer gets does not move with the training
    after it: on the CPU ``.cpu()`` would hand it the live parameters and
    AdamW's ``step`` counters (a resumed run then took later counters,
    found on the card at M = 75, where the write outlasted a step)."""
    x, y, tidx, vidx = _data(dtype)
    model = FAST(FASTConfig(**SMALL), n_models=M)
    fit = engine.make_fit(model, 5, epochs=1, batch_size=8, n_train=N_TRAIN,
                          n_val=N_TRIALS - N_TRAIN, total_epochs=2)
    carry = fit.run(fit.init_carry(tidx, vidx, x, seed=0), x, y, until=1)
    tree = carry.arrays()
    frozen = checkpoint._flatten(tree)
    frozen = {k: v.copy() for k, v in frozen.items()}
    fit.run(carry, x, y, until=2)
    for k, v in checkpoint._flatten(tree).items():
        np.testing.assert_array_equal(v, frozen[k], err_msg=k)
    assert all(float(v) == 2 for v in tree["opt"]["step"].values())  # 2 steps an epoch
    assert int(tree["epoch"]) == 1 and carry.epoch == 2


def test_resume_false_starts_fresh(tmp_path):
    ref, _ = _run(torch.float32)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        _run(torch.float32, crash_at=5, checkpoint_dir=ckpt)
    fresh, epochs_run = _run(torch.float32, checkpoint_dir=ckpt, resume=False)
    assert epochs_run == [1, 2, 3, 4, 5, 6]
    _assert_same(fresh, ref)


def test_checkpoint_every_thins_the_writes(tmp_path, monkeypatch):
    """Cadence 2: one write over 2 segments; over 3 segments the second and
    the last; a run crashed in its third segment resumes from the second
    boundary and equals the uninterrupted run."""
    writes = []
    save = checkpoint.save_segment_checkpoint
    monkeypatch.setattr(checkpoint, "save_segment_checkpoint",
                        lambda path, *a: writes.append(a[-1]) or save(path, *a))
    _run(torch.float32, total=4, checkpoint_dir=str(tmp_path / "two"), checkpoint_every=2)
    assert writes == [2]
    writes.clear()
    ref, _ = _run(torch.float32, checkpoint_dir=str(tmp_path / "three"), checkpoint_every=2)
    assert writes == [2, 3]
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        _run(torch.float32, crash_at=5, checkpoint_dir=ckpt, checkpoint_every=2)
    resumed, epochs_run = _run(torch.float32, checkpoint_dir=ckpt, checkpoint_every=2)
    assert epochs_run == [5, 6]
    _assert_same(resumed, ref)


def test_final_segment_always_written(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    res, _ = _run(torch.float32, total=4, checkpoint_dir=ckpt, checkpoint_every=99)
    with np.load(os.path.join(ckpt, "segment_carry.npz")) as f:
        assert int(f["meta.next_segment"]) == 2 and int(f["carry.epoch"]) == 4
    assert len(res.timings["checkpoint_write_s"]) == 1 and res.timings["checkpoint_bytes"] > 0


def test_writer_failure_propagates_and_stops_the_run(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise OSError("no space left on device (simulated)")

    monkeypatch.setattr(checkpoint, "save_segment_checkpoint", boom)
    epochs = []
    with pytest.raises(RuntimeError, match="segment-checkpoint write to .* failed") as info:
        x, y, tidx, vidx = _data(torch.float32)
        model = FAST(FASTConfig(**SMALL), n_models=M)
        fit = engine.make_fit(model, 5, epochs=2, batch_size=8, n_train=N_TRAIN,
                              n_val=N_TRIALS - N_TRAIN, total_epochs=6)
        engine.fit_segmented(fit, tidx, vidx, x, y, seed=0, checkpoint_dir=str(tmp_path),
                             progress=lambda e, _: epochs.append(e))
    assert isinstance(info.value.__cause__, OSError)
    assert max(epochs) <= 4  # the third segment never ran


@pytest.mark.parametrize("total", [1, 2, 7, 10, 24, 50, 60, 97, 200])
@pytest.mark.parametrize("preferred", [1, 4, 25])
def test_segment_length_matches_jax(total, preferred):
    assert cv._segment_length(total, preferred) == jax_cv._segment_length(total, preferred)


def _cv_run(tmp_path, name, crash_at=None):
    x = np.random.default_rng(3).normal(size=(2, 10, 10, 200)).astype(np.float32)
    y = np.random.default_rng(4).integers(0, 5, (2, 10))
    test = {sid: (x[i, :4], y[i, :4]) for i, sid in enumerate(("01", "02"))}
    calls = []
    evaluate = engine.evaluate

    def crashing_evaluate(*args):
        calls.append(1)
        if len(calls) == crash_at:
            raise Crash()
        return evaluate(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "evaluate", crashing_evaluate)
        out = tmp_path / "out"
        return cv.train_per_subject_cv(
            FASTConfig(**SMALL), TrainConfig(max_epochs=6, batch_size=8, precision="f32",
                                             learning_rate=1e-3, warmup_epochs=1),
            x, y, ["01", "02"], 5, test_per_subject=test, save_dir=str(out / name),
            epochs_per_segment=2, device="cpu", verbose=False,
            checkpoint_dir=str(out / "ckpt" / name))


def test_cv_crash_and_resume_writes_the_same_tree(tmp_path):
    ref = _cv_run(tmp_path, "ref")
    with pytest.raises(Crash):
        _cv_run(tmp_path, "run", crash_at=4)  # the 4th validation: segment 2 of 3
    with np.load(tmp_path / "out" / "ckpt" / "run" / "segment_carry.npz") as f:
        assert int(f["meta.next_segment"]) == 1
    resumed = _cv_run(tmp_path, "run")
    assert resumed.summary == ref.summary
    for k in ref.fit.history:
        np.testing.assert_array_equal(resumed.fit.history[k], ref.fit.history[k])
    out = tmp_path / "out"
    for rel in ("summary_per_subject.csv", "global_test_predictions.csv",
                "sub-02/fold-3_history.csv", "sub-01/fold_metrics.csv"):
        assert (out / "run" / rel).read_text() == (out / "ref" / rel).read_text(), rel
    with np.load(out / "run" / "sub-01" / "best_subject.npz") as a, \
            np.load(out / "ref" / "sub-01" / "best_subject.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_trains_on_a_raw_tree_and_resumes(tmp_path):
    """``cli.train_fast`` on a raw tree at the documented schema (all 15
    subjects; 8 electrodes, so ``--no-strict``, and a narrow model from
    ``--config``): the result tree and the segment checkpoint are
    written; ``--resume`` of the finished run trains no epoch and writes
    the same summary; ``--checkpoint_every`` is taken."""
    base = str(tmp_path / "BCIC2020Track3")
    write_tree(base, SUBJECTS, (4, 4, 50), n_channels=8, seed=11)
    cfg = tmp_path / "small.yaml"
    cfg.write_text("model:\n  electrodes: [E0, E1, E2, E3, E4, E5, E6, E7]\n"
                   "  zone_dict: {A: [E0, E1, E2], B: [E3, E4], C: [E5, E6, E7]}\n"
                   "  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n  num_heads: 4\n")
    out = tmp_path / "out"
    argv = ["--config", str(cfg), "--data_folder", base, "--no-strict", "--epochs", "2",
            "--batch_size", "8", "--n_folds", "2", "--precision", "f32",
            "--checkpoint_every", "3", "--output_dir", str(out)]
    res = train_fast.main(argv, device="cpu")
    assert (out / "checkpoints" / "segment_carry.npz").is_file()
    assert [r["Subject"] for r in res.summary] == list(SUBJECTS)
    for sid in SUBJECTS:
        for name in ("fold-1_history.csv", "best_subject.npz", "test_predictions.csv"):
            assert (out / f"sub-{sid}" / name).is_file()
    summary = (out / "summary_per_subject.csv").read_text()
    again = train_fast.main(argv + ["--resume"], device="cpu")
    assert again.timings["train_s"] == []  # nothing left to train
    assert (out / "summary_per_subject.csv").read_text() == summary
    for k in res.fit.history:
        np.testing.assert_array_equal(again.fit.history[k], res.fit.history[k])
