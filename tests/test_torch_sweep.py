"""The port's sweep (``engine.make_fit(sweep=True)``, ``engine.RowAdamW``,
``train.sweep``, ``cli.sweep``) on the CPU, against the JAX package.

``hyper_grid`` and its warmup tables equal JAX's; one ``RowAdamW`` step a
row equals ``optax.adamw`` at the row's learning rate and weight decay; a
sweep row trains as a plain fit rebuilt at its hyperparameters; two grid
rows with the same (lr, wd) train bit for bit alike (dropout on: the rows
share their fold's draws); a segmented sweep equals the whole run, and a
sweep that crashes and resumes equals the uninterrupted one, bit for bit.
Then the sweep CLI against JAX's ``cli.sweep`` on the same flags, on an
RNG-free trajectory (dropout 0, each fold's training set in one batch,
the JAX package's initial weights transplanted)."""

import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.cli import sweep as jax_cli_sweep
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import cv as jax_cv
from imagined_speech_decoding_tpu.train import schedule as jax_schedule
from imagined_speech_decoding_tpu.train import sweep as jax_sweep
from imagined_speech_decoding_tpu_torch.cli import sweep as cli_sweep
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_trials
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import cv, engine, schedule, sweep
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params, init_jax_layout_params

torch.set_num_threads(1)

SMALL = dict(  # tests/conftest.py's small_config, dropout on
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.1,
)
CFG = FASTConfig(**SMALL)


def _corpus(n=30):
    x, y = synthetic_trials(0, n, 8, 200, 5)
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))


@pytest.mark.parametrize("warmups", [None, [0, 2]])
def test_hyper_grid_matches_jax(warmups):
    lr, wd = [0.25, 1.0, 4.0], [0.0, 1.0]
    tables = None
    if warmups:
        tables = np.stack([5e-4 * schedule.cosine_scheduler(1.0, 0.1, 4, 3, warmup_epochs=w)
                           for w in warmups])
        np.testing.assert_array_equal(
            tables, np.stack([5e-4 * jax_schedule.cosine_scheduler(1.0, 0.1, 4, 3, warmup_epochs=w)
                              for w in warmups]))
    ours, meta = sweep.hyper_grid(lr, wd, warmups, lr_tables=tables)
    ref, ref_meta = jax_sweep.hyper_grid(lr, wd, warmups, lr_tables=tables)
    assert meta == ref_meta
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_hyper_grid_warmup_needs_tables():
    with pytest.raises(ValueError, match="one lr_table row per warmup"):
        sweep.hyper_grid([1.0], [1.0], [0, 2])


def test_row_adamw_step_matches_optax_per_row():
    """Three steps of one stacked tensor: row m follows ``optax.adamw`` at
    lr ``lr_t[m]`` and weight decay ``wd[m]`` (f32, rtol 1e-6)."""
    rng = np.random.default_rng(0)
    m = 4
    p0 = rng.normal(size=(m, 3, 5)).astype(np.float32)
    grads = [rng.normal(size=(m, 3, 5)).astype(np.float32) for _ in range(3)]
    lrs = np.asarray([[1e-3, 2e-3, 5e-4, 1e-3], [3e-3, 1e-3, 1e-3, 4e-3],
                      [2e-3, 5e-4, 2e-3, 1e-3]], np.float32)
    wd = np.asarray([0.0, 0.01, 0.1, 0.01], np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = engine.RowAdamW([p], torch.zeros(m), torch.from_numpy(wd))
    for g, lr in zip(grads, lrs):
        p.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = torch.from_numpy(lr)
        opt.step()
    assert float(opt.state[p]["step"]) == 3.0 and opt.state[p]["step"].dtype == torch.float32
    for row in range(m):
        tx = optax.adamw(lambda count, row=row: jnp.asarray(lrs[:, row])[count], b1=0.9,
                         b2=0.999, eps=1e-8, weight_decay=float(wd[row]))
        q = jnp.asarray(p0[row])
        state = tx.init(q)
        for g in grads:
            upd, state = tx.update(jnp.asarray(g[row]), state, q)
            q = optax.apply_updates(q, upd)
        np.testing.assert_allclose(p.detach()[row].numpy(), np.asarray(q), rtol=1e-6, atol=1e-9)


def _fit(lr=5e-4, wd=0.01, sweep_mode=False, rows=1, epochs=4):
    model = FAST(CFG, n_models=rows)
    model.load_state_dict(from_jax_params(
        sweep.tile_rows(init_jax_layout_params(CFG, 3, 1), rows)))
    fit = engine.make_fit(model, 5, epochs=epochs, batch_size=10, n_train=24, n_val=6,
                          learning_rate=lr, weight_decay=wd, warmup_epochs=2, sweep=sweep_mode,
                          row_repeats=rows)
    return fit


def test_sweep_rows_match_rebuilt_plain_fits():
    """Rows at (c, w) = (1, 1), (2.3, 0.4), (0.25, 10) of one sweep fit
    against plain fits at lr 5e-4 c, wd 0.01 w, on the same draws (the
    sweep's rows repeat the first row's): history at rtol 1e-5, atol 1e-6
    (JAX ``tests/test_sweep.py:166-196``)."""
    x, y = _corpus()
    scales = [(1.0, 1.0), (2.3, 0.4), (0.25, 10.0)]
    tidx, vidx = np.tile(np.arange(24), (3, 1)), np.tile(np.arange(24, 30), (3, 1))
    hyper = {"lr_scale": np.asarray([c for c, _ in scales], np.float32),
             "wd_scale": np.asarray([w for _, w in scales], np.float32)}
    res = _fit(sweep_mode=True, rows=3)(tidx, vidx, x, y, seed=7, hyper=hyper)
    for i, (c, w) in enumerate(scales):
        ref = _fit(lr=5e-4 * c, wd=0.01 * w)(tidx[:1], vidx[:1], x, y, seed=7)
        for k in engine.HISTORY_KEYS:
            np.testing.assert_allclose(res.history[k][i], ref.history[k][0], rtol=1e-5, atol=1e-6,
                                       err_msg=f"row {i} {k}")
    assert not np.allclose(res.history["loss"][0], res.history["loss"][1])


def test_lr_table_replaces_the_schedule():
    """A row's own table (warmup 0) trains as a plain fit rebuilt with that warmup."""
    x, y = _corpus()
    tidx, vidx = np.arange(24)[None], np.arange(24, 30)[None]
    table = 5e-4 * schedule.cosine_scheduler(1.0, 0.1, 4, 3, warmup_epochs=0)
    hyper = {"lr_scale": [1.0], "wd_scale": [1.0], "lr_table": table[None]}
    res = _fit(sweep_mode=True)(tidx, vidx, x, y, seed=7, hyper=hyper)
    model = FAST(CFG, n_models=1)
    model.load_state_dict(from_jax_params(init_jax_layout_params(CFG, 3, 1)))
    ref = engine.make_fit(model, 5, epochs=4, batch_size=10, n_train=24, n_val=6,
                          warmup_epochs=0)(tidx, vidx, x, y, seed=7)
    for k in engine.HISTORY_KEYS:
        np.testing.assert_allclose(res.history[k], ref.history[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_sweep_fit_needs_hyper_and_plain_fit_refuses_it():
    x, y = _corpus()
    tidx, vidx = np.arange(24)[None], np.arange(24, 30)[None]
    with pytest.raises(ValueError, match="needs hyper"):
        _fit(sweep_mode=True)(tidx, vidx, x, y, seed=0)
    with pytest.raises(ValueError, match="sweep-mode"):
        _fit()(tidx, vidx, x, y, seed=0, hyper={"lr_scale": [1.0], "wd_scale": [1.0]})
    with pytest.raises(ValueError, match="2 rows for 1 models"):
        _fit(sweep_mode=True)(tidx, vidx, x, y, seed=0,
                              hyper={"lr_scale": [1.0, 2.0], "wd_scale": [1.0, 1.0]})


SWEEP_KW = dict(n_trials=30, lr_scales=[1.0, 1.0, 2.0], wd_scales=[1.0], n_folds=3, epochs=4,
                batch_size=10, warmup_epochs=1, seed=42, device="cpu")


@pytest.fixture(scope="module")
def whole_sweep():
    x, y = _corpus()
    return sweep.cv_sweep(CFG, 5, x, y, **SWEEP_KW)


def test_duplicated_rows_train_bit_identically(whole_sweep):
    """Configs 0 and 1 have the same (lr, wd): their 3 folds' rows are
    equal bit for bit (dropout 0.1 on); config 2's differ."""
    res, f = whole_sweep.fit, 3
    for k, v in res.params.items():
        assert torch.equal(v[:f], v[f : 2 * f]), k
        assert torch.equal(res.best_params[k][:f], res.best_params[k][f : 2 * f]), k
    for k in engine.HISTORY_KEYS:
        np.testing.assert_array_equal(whole_sweep.history[k][0], whole_sweep.history[k][1])
    assert not np.array_equal(whole_sweep.history["loss"][0], whole_sweep.history["loss"][2])
    # the folds of one config differ from each other
    assert not np.array_equal(whole_sweep.history["loss"][0, 0], whole_sweep.history["loss"][0, 1])


def test_report_geometry(whole_sweep):
    r = whole_sweep
    assert r.fold_val_acc.shape == (3, 3) and r.history["val_acc"].shape == (3, 3, 4)
    assert r.best_index == int(np.argmax(r.mean_val_acc))
    np.testing.assert_allclose(r.lr, [5e-4, 5e-4, 1e-3])
    rows = r.rows()
    assert list(rows[0]) == ["learning_rate", "weight_decay", "mean_val_acc", "std_val_acc",
                             "fold0_val_acc", "fold1_val_acc", "fold2_val_acc"]
    assert r.best["mean_val_acc"] == float(r.mean_val_acc[r.best_index])


def _assert_same(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.best_params[k], b.best_params[k]), k
    np.testing.assert_array_equal(a.best_val_acc, b.best_val_acc)
    np.testing.assert_array_equal(a.best_epoch, b.best_epoch)
    for k in a.history:
        np.testing.assert_array_equal(a.history[k], b.history[k], err_msg=k)


def test_segmented_sweep_equals_whole_run(whole_sweep):
    x, y = _corpus()
    seg = sweep.cv_sweep(CFG, 5, x, y, segment_epochs=3, **SWEEP_KW)
    _assert_same(seg.fit, whole_sweep.fit)


class Crash(Exception):
    pass


def test_crashed_sweep_resumes_bit_for_bit(tmp_path):
    """A sweep-mode fit crashed in its second segment and resumed from its
    checkpoint in a new model and ``RowAdamW`` ends as the uninterrupted run."""
    x, y = _corpus()
    tidx, vidx = np.tile(np.arange(24), (2, 1)), np.tile(np.arange(24, 30), (2, 1))
    hyper = {"lr_scale": [1.0, 3.0], "wd_scale": [1.0, 0.0]}

    def run(crash_at=None, **kw):
        model = FAST(CFG, n_models=2)
        model.load_state_dict(from_jax_params(init_jax_layout_params(CFG, 1, 2)))
        fit = engine.make_fit(model, 5, epochs=2, batch_size=10, n_train=24, n_val=6,
                              warmup_epochs=1, total_epochs=6, sweep=True)

        def progress(epoch, _):
            if epoch == crash_at:
                raise Crash(epoch)

        return engine.fit_segmented(fit, tidx, vidx, x, y, seed=2, progress=progress,
                                    hyper=hyper, **kw)

    whole = run()
    with pytest.raises(Crash):
        run(crash_at=3, checkpoint_dir=str(tmp_path))
    resumed = run(checkpoint_dir=str(tmp_path))
    _assert_same(resumed, whole)


# --- the CLI against JAX's ---------------------------------------------------------

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
"""
ARGV = ["--synthetic", "20", "--lr_scales", "0.5,4", "--wd_scales", "0,10", "--warmup_grid",
        "0,2", "--n_folds", "2", "--epochs", "3", "--batch_size", "16", "--precision", "f32"]


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], float)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs on a 20-trial subject, 2 folds of 10 (one batch of 16 a
    fold's epoch), 2 lr x 2 wd x 2 warmups; the port from the JAX
    package's initial weights."""
    root = tmp_path_factory.mktemp("sweep_cli")
    cfg_path = root / "small.yaml"
    cfg_path.write_text(SMALL_YAML)
    argv = ARGV + ["--config", str(cfg_path)]

    def jax_init(cfg, seed, n_models):
        model = make_fast_model(jax_config.FASTConfig(**dataclasses.asdict(cfg)))
        return jax.tree.map(np.asarray, jax_cv.stacked_init(model, jax.random.PRNGKey(seed),
                                                            n_models))

    mp = pytest.MonkeyPatch()
    mp.setattr(cv, "stacked_init", jax_init)
    try:
        ours = cli_sweep.main(argv + ["--output_dir", str(root / "port")], device="cpu")
    finally:
        mp.undo()
    ref = jax_cli_sweep.main(argv + ["--output_dir", str(root / "jax")])
    return ours, ref, root


def test_cli_results_csv_matches_jax(cli_runs):
    _, _, root = cli_runs
    head, ours = read_csv(root / "port" / "sweep_results.csv")
    ref_head, ref = read_csv(root / "jax" / "sweep_results.csv")
    assert head == ref_head
    assert ours.shape == ref.shape == (8, 7)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=0)


def test_cli_best_json_matches_jax(cli_runs):
    _, _, root = cli_runs
    ours = json.loads((root / "port" / "best.json").read_text())
    ref = json.loads((root / "jax" / "best.json").read_text())
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    assert (root / "port" / "best.json").read_text().startswith('{\n  "learning_rate": ')


def test_cli_histories_match_jax(cli_runs):
    ours, ref, _ = cli_runs
    for k in ("loss", "val_loss", "val_acc"):
        np.testing.assert_allclose(ours.history[k], ref.history[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_cli_needs_the_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli_sweep.main(["--synthetic", "10"])
