"""Early stopping in the port's engine (``engine.make_fit(early_stop_threshold,
early_stop_patience)``) against JAX's ``make_fit`` on the CPU, and the
stopped flag across segments and ``--resume``.

Against JAX: three stacked models on an RNG-free trajectory (dropout 0,
each model's training set in one batch, JAX's initial weights
transplanted), a threshold that stops the models at different epochs,
patience 1 and 2, and patience with a validation pass every other
epoch: the history, ``best_epoch``, ``best_val_acc`` and the final and
best parameters at rtol 1e-4 / atol 1e-5. In the port alone: a stopped
row's parameters, AdamW moments and best snapshot stay bit for bit where
its stop left them, a segmented run equals the whole run bit for bit,
and a run interrupted after its first segment and resumed from the
segment carry (which holds ``stopped``) equals it too."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import engine as jax_engine
from imagined_speech_decoding_tpu_torch import transplant
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import engine

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
M, N_TRAIN, N_VAL, EPOCHS = 3, 16, 10, 6


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 8, 200)).astype(np.float32)
    y = rng.integers(0, 5, 40).astype(np.int64)
    x[np.arange(40), y % 8] += 2.0  # a learnable signal, so val_acc moves
    perms = np.stack([rng.permutation(40) for _ in range(M)])
    return x, y, perms[:, :N_TRAIN], perms[:, N_TRAIN:N_TRAIN + N_VAL]


def _params0():
    model = make_fast_model(jax_config.FASTConfig(**SMALL))
    keys = jax.random.split(jax.random.PRNGKey(0), M)
    return model, jax.vmap(model.init)(keys)


KW = dict(batch_size=N_TRAIN, n_train=N_TRAIN, n_val=N_VAL, learning_rate=1e-2,
          warmup_epochs=1)


def _jax_fit(epochs=EPOCHS, val_every=1, **es):
    x, y, tidx, vidx = _data()
    model, (params0, state0) = _params0()
    fit = jax_engine.make_fit(model.apply, 5, epochs=epochs, val_every=val_every, **KW, **es)
    keys = jax.random.split(jax.random.PRNGKey(1), M)
    res = jax.jit(lambda *a: jax_engine.fit_many(fit, *a))(
        keys, params0, state0, jnp.asarray(tidx), jnp.asarray(vidx), jnp.asarray(x),
        jnp.asarray(y.astype(np.int32)))
    return jax.tree.map(np.asarray, res)


def _port_fit(epochs=EPOCHS, val_every=1, total=None, **es):
    x, y, tidx, vidx = _data()
    _, (params0, _) = _params0()
    model = FAST(FASTConfig(**SMALL), n_models=M)
    model.load_state_dict(transplant.from_jax_params(jax.tree.map(np.asarray, params0)))
    fit = engine.make_fit(model, 5, epochs=epochs, val_every=val_every, total_epochs=total,
                          **KW, **es)
    return fit, (tidx, vidx, torch.from_numpy(x), torch.from_numpy(y))


def _assert_matches_jax(ours, ref, lr_sum):
    """History, best epochs and accuracies, final and best parameters. The
    attention's key bias (``in_b[D:2D]``) has an exact gradient of 0 (a
    softmax does not see a shift common to its logits), so AdamW moves it
    by rounding noise, up to the learning rate a step, differently in each
    package (ROADMAP.md, Queue 3): it is held within the summed learning
    rate, and every other element at rtol 1e-4 / atol 1e-5."""
    for k in engine.HISTORY_KEYS:
        np.testing.assert_allclose(ours.history[k], ref.history[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(ours.best_epoch, ref.best_epoch)
    np.testing.assert_allclose(ours.best_val_acc, ref.best_val_acc, rtol=RTOL)
    d = SMALL["dim_token"]
    for mine, theirs in ((ours.params, ref.params), (ours.best_params, ref.best_params)):
        got = transplant.to_jax_params(mine)
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree.leaves(theirs)):
            name = jax.tree_util.keystr(path)
            if name.endswith("['in_b']"):
                assert np.abs(a[..., d:2 * d] - b[..., d:2 * d]).max() <= lr_sum, name
                a, b = np.delete(a, np.s_[d:2 * d], -1), np.delete(b, np.s_[d:2 * d], -1)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_the_trajectory_moves_without_early_stopping():
    """The run the cases below cut short, in both packages: the models'
    best epochs differ and come after their first, so the thresholds and
    patiences below stop them at different epochs."""
    ref = _jax_fit()
    fit, data = _port_fit()
    _assert_matches_jax(fit(*data, seed=0), ref, float(np.sum(fit.lr_table)))
    assert len(set(ref.best_epoch.tolist())) > 1 and ref.best_epoch.max() > 1, ref.best_epoch


@pytest.mark.parametrize("es", [dict(early_stop_threshold=0.0), dict(early_stop_threshold=0.4),
                                dict(early_stop_patience=1), dict(early_stop_patience=2),
                                dict(early_stop_threshold=0.55, early_stop_patience=3)],
                         ids=["threshold0", "threshold0.4", "patience1", "patience2", "both"])
def test_early_stopping_matches_jax(es):
    ref = _jax_fit(**es)
    fit, data = _port_fit(**es)
    ours = fit(*data, seed=0)
    _assert_matches_jax(ours, ref, float(np.sum(fit.lr_table)))


def test_patience_moves_on_validation_epochs_only():
    """``val_every=2``: the flag is set after validation passes only, as in
    JAX (a NaN validation row is no evidence)."""
    ref = _jax_fit(val_every=2, early_stop_patience=2)
    fit, data = _port_fit(val_every=2, early_stop_patience=2)
    ours = fit(*data, seed=0)
    assert np.isnan(ours.history["val_acc"][:, 0::2]).all()
    _assert_matches_jax(ours, ref, float(np.sum(fit.lr_table)))


def test_a_stopped_row_stays_where_it_stopped():
    """Threshold 0: every row stops after its first validation pass. The
    next two epochs run (finite train and validation rows in the history)
    and leave parameters, AdamW moments and the best snapshot bit for bit
    at epoch 1's end; the shared step count goes on."""
    fit, (tidx, vidx, x, y) = _port_fit(early_stop_threshold=0.0, epochs=3)
    carry = fit.run(fit.init_carry(tidx, vidx, x, seed=0), x, y, until=1)
    assert carry.stopped.all()
    opt = carry.opt
    snap = {k: (p.detach().clone(), opt.state[p]["exp_avg"].clone(),
                opt.state[p]["exp_avg_sq"].clone(), carry.best[k].clone())
            for k, p in carry.params.items()}
    fit.run(carry, x, y, until=3)
    for k, p in carry.params.items():
        want = snap[k]
        got = (p.detach(), opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"], carry.best[k])
        for a, b in zip(got, want):
            assert torch.equal(a, b), k
    res = fit.result(carry)
    assert all(np.isfinite(v).all() for v in res.history.values())
    assert res.history["loss"].shape == (M, 3) and (res.best_epoch == 0).all()
    assert float(opt.state[next(iter(carry.params.values()))]["step"]) == 3


class Interrupted(Exception):
    pass


def _segmented(checkpoint_dir=None, resume=True, stop_after=None):
    fit, (tidx, vidx, x, y) = _port_fit(epochs=2, total=EPOCHS, early_stop_patience=1)

    def progress(epoch, _):
        if epoch == stop_after:
            raise Interrupted(epoch)

    return engine.fit_segmented(fit, tidx, vidx, x, y, seed=0, progress=progress,
                                checkpoint_dir=checkpoint_dir, resume=resume)


def test_segments_and_resume_keep_the_stopped_rows(tmp_path):
    """Patience 1 in segments of 2 epochs: the segmented run equals the
    whole run bit for bit; a run interrupted in its second segment resumes
    from the first segment's carry, whose ``stopped`` flags rows already
    stopped, and ends bit for bit as the uninterrupted run."""
    fit, data = _port_fit(early_stop_patience=1)
    whole = fit(*data, seed=0)
    seg = _segmented()
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Interrupted):
        _segmented(ckpt, stop_after=3)
    with np.load(os.path.join(ckpt, "segment_carry.npz")) as f:
        assert int(f["carry.epoch"]) == 2 and f["carry.stopped"].dtype == bool
        stopped_at_2 = f["carry.stopped"].copy()
    resumed = _segmented(ckpt)
    assert stopped_at_2.any()
    for res in (seg, resumed):
        for k in whole.params:
            assert torch.equal(res.params[k], whole.params[k]), k
            assert torch.equal(res.best_params[k], whole.best_params[k]), k
        np.testing.assert_array_equal(res.best_epoch, whole.best_epoch)
        for k in whole.history:
            np.testing.assert_array_equal(res.history[k], whole.history[k], err_msg=k)
