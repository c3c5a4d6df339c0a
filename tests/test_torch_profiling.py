"""The port's profiling module (``profiling.py``) on the CPU: ``trace``
writes a Chrome trace (``<logdir>/trace.json``) holding an ``annotate``
range and the ops run inside it, and closes on an exception;
``StepTimer`` and ``sync_scalar`` against the JAX package's; and
``cli.train_fast --profile`` writes the trace of its fit."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu import profiling as jax_profiling
from imagined_speech_decoding_tpu_torch import profiling
from imagined_speech_decoding_tpu_torch.cli import train_fast

torch.set_num_threads(1)


def _events(logdir):
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as d:
        assert d == logdir
        with profiling.annotate("test-step"):
            y = torch.ones(16, 16) @ torch.ones(16, 16)
            assert profiling.sync_scalar(y) == 16.0
    events = _events(logdir)
    names = [e.get("name", "") for e in events]
    step = [e for e in events if e.get("name") == "test-step"]
    assert step and step[0]["ph"] == "X" and step[0]["dur"] > 0
    mm = [e for e in events if e.get("name") in ("aten::mm", "aten::matmul")]
    assert mm and any(step[0]["ts"] <= e["ts"] <= step[0]["ts"] + step[0]["dur"] for e in mm), names


def test_trace_closes_on_an_exception(tmp_path):
    """The profiler stops and the trace is written when the body raises, so
    a later trace can start."""
    with pytest.raises(ValueError, match="boom"):
        with profiling.trace(str(tmp_path / "t1")):
            raise ValueError("boom")
    assert os.path.isfile(tmp_path / "t1" / profiling.TRACE_FILE)
    with profiling.trace(str(tmp_path / "t2")):
        torch.zeros(3).sum()
    assert os.path.isfile(tmp_path / "t2" / profiling.TRACE_FILE)


def test_no_device_warning_without_a_card(tmp_path, capsys):
    """Without a card ``trace`` records the host only and says nothing
    about lost device records."""
    with profiling.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert "no device activity" not in capsys.readouterr().err


def _laps(timer_cls, warmup, n, sync=None):
    t = timer_cls(warmup=warmup)
    out = [t.lap(sync) for _ in range(n)]
    return t, [o is None for o in out]


@pytest.mark.parametrize("warmup,n", [(2, 3), (0, 2), (1, 5), (3, 3), (2, 0)])
def test_step_timer_matches_jax(warmup, n):
    """Which laps are discarded (warmup 0 behaves like 1), how many are
    kept, and the mean / rate consistency, as JAX's ``StepTimer``."""
    ours, ours_none = _laps(profiling.StepTimer, warmup, n)
    ref, ref_none = _laps(jax_profiling.StepTimer, warmup, n)
    assert ours_none == ref_none and len(ours.laps) == len(ref.laps)
    if ours.laps:
        assert ours.steps_per_sec == pytest.approx(1.0 / ours.mean_lap)
    else:
        assert np.isnan(ours.mean_lap) and np.isnan(ours.steps_per_sec)
        assert np.isnan(ref.mean_lap) and np.isnan(ref.steps_per_sec)


def test_step_timer_calls_sync_before_the_timestamp():
    calls = []
    t = profiling.StepTimer(warmup=1)
    t.lap(sync=lambda: calls.append(1) or 0.0)
    t.lap(sync=lambda: calls.append(2) or 0.0)
    assert calls == [1, 2] and len(t.laps) == 1


@pytest.mark.parametrize("value", [np.arange(12.0).reshape(3, 4) + 1.0, np.float32(2.5),
                                   np.arange(6.0).reshape(1, 2, 3) - 4.0])
def test_sync_scalar_matches_jax(value):
    assert profiling.sync_scalar(torch.as_tensor(value)) == \
        jax_profiling.sync_scalar(jnp.asarray(value))


def test_cli_profile_writes_the_fits_trace(tmp_path, capsys):
    """``cli.train_fast --profile LOGDIR`` on the CPU: the trace holds the
    CLI's annotated fit and the training step's ops, and the run says
    where it is."""
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n"
                        "  num_heads: 4\n")
    logdir = tmp_path / "prof"
    train_fast.main(["--config", str(cfg_path), "--synthetic", "1", "--synthetic_trials", "10",
                     "--epochs", "1", "--batch_size", "8", "--precision", "f32", "--profile",
                     str(logdir), "--output_dir", str(tmp_path / "out")], device="cpu")
    assert f"{logdir / profiling.TRACE_FILE}" in capsys.readouterr().out
    events = _events(str(logdir))
    fit = [e for e in events if e.get("name") == "cli.train_fast: fit"]
    assert len(fit) == 1
    names = {e.get("name") for e in events}
    assert "Optimizer.step#AdamW.step" in names or any("AdamW" in str(n) for n in names)
