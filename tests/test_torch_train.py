"""The PyTorch port's training engine (plain path on the CPU) against the
JAX package: schedule, metrics, batching, one AdamW step, a stacked
3-epoch ``make_fit`` trajectory, the ragged tail and ``val_every``; and
the stacked FAST (model axis, dropout) against per-model FAST."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.data import arrays as jax_arrays
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train import engine as jax_engine
from imagined_speech_decoding_tpu.train import metrics as jax_metrics
from imagined_speech_decoding_tpu.train import schedule as jax_schedule
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.data import arrays
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import engine, metrics, schedule
from imagined_speech_decoding_tpu_torch.transplant import (
    from_jax_params,
    init_jax_layout_params,
    to_jax_params,
)

torch.set_num_threads(1)

SMALL = dict(  # tests/test_pallas_head.py:14-29
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
RTOL, ATOL = 1e-4, 1e-5  # f32 sums in another order (tests/test_torch_parity.py)


class TestScheduleMetricsBatching:
    @pytest.mark.parametrize("epochs,spe,warmup", [(200, 5, 10), (3, 1, 1), (4, 3, 10), (6, 2, 0)])
    def test_schedule_matches_jax(self, epochs, spe, warmup):
        ours = schedule.warmup_cosine_lr(5e-4, epochs, spe, warmup, 0.1)
        ref = jax_schedule.warmup_cosine_lr(5e-4, epochs, spe, warmup, 0.1)
        np.testing.assert_array_equal(
            schedule.cosine_scheduler(1.0, 0.1, epochs, spe, warmup),
            jax_schedule.cosine_scheduler(1.0, 0.1, epochs, spe, warmup),
        )
        for step in list(range(epochs * spe)) + [epochs * spe, epochs * spe + 7]:
            np.testing.assert_allclose(schedule.lr_at(ours, step), float(ref(step)), rtol=1e-6)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_metrics_match_jax(self, weighted):
        rng = np.random.default_rng(0)
        logits = rng.normal(size=(3, 7, 5)).astype(np.float32)
        labels = rng.integers(0, 5, size=(3, 7))
        labels[:, 0] = 4  # class 4 appears; class predictions may miss some classes
        w = (rng.random((3, 7)) > 0.3).astype(np.float32) if weighted else None
        ce = metrics.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if w is None else torch.from_numpy(w))
        cm = metrics.confusion_matrix(torch.from_numpy(logits), torch.from_numpy(labels), 5,
                                      None if w is None else torch.from_numpy(w))
        f1 = metrics.f1_from_confusion(cm)
        for i in range(3):
            wi = None if w is None else jnp.asarray(w[i])
            ref_ce = jax_metrics.cross_entropy(jnp.asarray(logits[i]), jnp.asarray(labels[i]), wi)
            ref_cm = jax_metrics.confusion_matrix(jnp.asarray(logits[i]), jnp.asarray(labels[i]),
                                                  5, wi)
            np.testing.assert_allclose(float(ce[i]), float(ref_ce), rtol=1e-6)
            np.testing.assert_array_equal(cm[i].numpy(), np.asarray(ref_cm))
            np.testing.assert_allclose(float(f1[i]), float(jax_metrics.f1_from_confusion(ref_cm)),
                                       rtol=1e-6)

    def test_f1_zero_division_and_predictions_input(self):
        preds = torch.tensor([0, 0, 1, 1])
        labels = torch.tensor([0, 2, 1, 1])
        cm = metrics.confusion_matrix(preds, labels, 3)
        ref = jax_metrics.confusion_matrix(jnp.asarray(preds.numpy()), jnp.asarray(labels.numpy()), 3)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(ref))
        np.testing.assert_allclose(float(metrics.f1_from_confusion(cm)),
                                   float(jax_metrics.f1_from_confusion(ref)), rtol=1e-6)
        # all-zero weights: the loss divides by max(sum w, 1)
        zero = metrics.cross_entropy(torch.zeros(4, 3), labels, torch.zeros(4))
        assert float(zero) == 0.0

    @pytest.mark.parametrize("n,b", [(70, 35), (71, 36), (280, 64), (5, 8)])
    def test_batching_matches_jax(self, n, b):
        assert arrays.num_batches(n, b) == jax_arrays.num_batches(n, b)
        for ours, ref in zip(arrays.sequential_batch_indices(n, b),
                             jax_arrays.sequential_batch_indices(n, b)):
            np.testing.assert_array_equal(ours, ref)
            assert ours.dtype == ref.dtype

    def test_eval_batch_rule(self):
        assert engine.eval_batch_size_for(70, 64) == 35
        assert engine.eval_batch_size_for(71, 64) == 36
        assert engine.eval_batch_size_for(2, 8) == 2
        assert engine.eval_batch_size_for(0, 8) == 8

    def test_permutations_are_seeded_cpu_draws(self):
        a = arrays.epoch_permutations(torch.Generator().manual_seed(3), 4, 12)
        b = arrays.epoch_permutations(torch.Generator().manual_seed(3), 4, 12)
        assert a.shape == (4, 12) and torch.equal(a, b)
        for row in a:
            assert sorted(row.tolist()) == list(range(12))
        assert not torch.equal(a[0], a[1])


def test_adamw_step_matches_optax():
    """torch's decoupled decay equals optax ``adamw``'s ``-lr * (adam + wd * p)``:
    three steps at different learning rates on the same gradients."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 6)).astype(np.float32)
    grads = [rng.normal(size=(4, 6)).astype(np.float32) for _ in range(3)]
    lrs = [0.0, 3e-3, 1e-3]
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = engine.make_optimizer([p], weight_decay=0.01)
    tx = optax.adamw(lambda count: jnp.asarray(lrs)[count], b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.01)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for lr, g in zip(lrs, grads):
        opt.param_groups[0]["lr"] = lr
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 10, 200)).astype(np.float32)
    y = rng.integers(0, 5, size=n).astype(np.int32)
    return x, y


def _stacked_jax_init(cfg, m, seed):
    model = make_fast_model(cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    params, state = jax.vmap(model.init)(keys)
    return model, params, state


class TestFitTrajectory:
    """3 epochs of a 2-model stack, ``n_train == batch_size`` so one step
    per epoch holds every training trial and the batch order (which the
    two packages draw from different generators) cannot matter."""

    EPOCHS, LR = 3, 1e-3
    NOISE_SHARE = 1e-3

    @pytest.fixture(scope="class")
    def runs(self):
        jcfg = JaxFASTConfig(**SMALL)
        x, y = _corpus(12)
        tidx = np.array([np.arange(8), np.arange(4, 12)])
        vidx = np.array([np.arange(8, 12), np.arange(0, 4)])
        model, p0, s0 = _stacked_jax_init(jcfg, 2, 0)
        fit = jax_engine.make_fit(model.apply, 5, epochs=self.EPOCHS, batch_size=8, n_train=8,
                                  n_val=4, learning_rate=self.LR, warmup_epochs=1)
        ref = jax.jit(lambda *a: jax_engine.fit_many(fit, *a))(
            jax.random.split(jax.random.PRNGKey(1), 2), p0, s0, jnp.asarray(tidx),
            jnp.asarray(vidx), jnp.asarray(x), jnp.asarray(y))
        ref = jax.tree.map(np.asarray, ref)

        ours_model = FAST(FASTConfig(**SMALL), n_models=2)
        ours_model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, p0)))
        ours_fit = engine.make_fit(ours_model, 5, epochs=self.EPOCHS, batch_size=8, n_train=8,
                                   n_val=4, learning_rate=self.LR, warmup_epochs=1)
        ours = ours_fit(tidx, vidx, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
                        seed=0)
        return ref, ours, ours_fit

    def test_history_matches_jax(self, runs):
        ref, ours, _ = runs
        for k in engine.HISTORY_KEYS:
            assert ours.history[k].shape == (2, self.EPOCHS)
            np.testing.assert_allclose(ours.history[k], ref.history[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)

    def test_best_snapshot_matches_jax(self, runs):
        ref, ours, _ = runs
        np.testing.assert_allclose(ours.best_val_acc, ref.best_val_acc, rtol=RTOL)
        np.testing.assert_array_equal(ours.best_epoch, ref.best_epoch)

    @pytest.mark.parametrize("which", ["params", "best_params"])
    def test_params_match_jax(self, runs, which):
        ref, ours, fit = runs
        ours_tree = to_jax_params(getattr(ours, which))
        ref_tree = getattr(ref, which)
        flat_ours = jax.tree_util.tree_flatten_with_path(ours_tree)[0]
        flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
        # Adam moves an element by ~lr whatever its gradient's size, so an
        # element whose gradient is at the rounding-noise level moves
        # differently in the two packages: the key part of the attention
        # in-projection bias (its exact gradient is 0, softmax being
        # shift-invariant along the keys) and, on some CPUs, a few others.
        # Every element must stay within the summed learning rate, and all
        # but NOISE_SHARE of the others within RTOL, ATOL.
        d = SMALL["dim_token"]
        budget = float(np.sum(fit.lr_table)) + 1e-6
        far = total = 0
        for path, leaf in flat_ours:
            name = jax.tree_util.keystr(path)
            r = flat_ref[path]
            assert leaf.shape == r.shape, name
            np.testing.assert_allclose(leaf, r, rtol=0, atol=budget, err_msg=name)
            if name.endswith("['attn']['in_b']"):
                leaf, r = np.delete(leaf, np.s_[d : 2 * d], -1), np.delete(r, np.s_[d : 2 * d], -1)
            far += int((np.abs(leaf - r) > ATOL + RTOL * np.abs(r)).sum())
            total += r.size
        assert far <= self.NOISE_SHARE * total, (far, total)


def test_ragged_tail_matches_hand_loop():
    """12 trials at batch 8 run as an 8-trial then a 4-trial step, over the
    epoch's permutation, exactly as a hand loop of ``train_step``."""
    cfg = FASTConfig(**SMALL)
    x, y = _corpus(16, 1)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    tidx = np.array([np.arange(12), np.arange(4, 16)])
    vidx = np.array([np.arange(12, 16), np.arange(0, 4)])
    p0 = from_jax_params(init_jax_layout_params(cfg, 0, 2))

    model = FAST(cfg, n_models=2)
    model.load_state_dict(p0)
    fit = engine.make_fit(model, 5, epochs=1, batch_size=8, n_train=12, n_val=4,
                          learning_rate=1e-3, warmup_epochs=0)
    res = fit(tidx, vidx, xt, yt, seed=5)
    assert fit.steps_per_epoch == 2

    hand = FAST(cfg, n_models=2)
    hand.load_state_dict(p0)
    hand.train()
    opt = engine.make_optimizer(hand.parameters())
    perm = arrays.epoch_permutations(torch.Generator().manual_seed(5), 2, 12)
    gidx = torch.gather(torch.from_numpy(tidx), 1, perm)
    loss_sum, total = torch.zeros(2), 0
    for step, (lo, hi) in enumerate([(0, 8), (8, 12)]):
        b = gidx[:, lo:hi]
        ls, _ = engine.train_step(hand, opt, xt[b], yt[b], schedule.lr_at(fit.lr_table, step), 5)
        loss_sum += ls
        total += hi - lo
    for k, p in hand.named_parameters():
        torch.testing.assert_close(res.params[k], p.detach(), rtol=0, atol=0, msg=k)
    np.testing.assert_allclose(res.history["loss"][:, 0], (loss_sum / total).numpy(), rtol=1e-6)


def test_val_every_records_nan_rows():
    cfg = FASTConfig(**SMALL)
    x, y = _corpus(10, 2)
    model = FAST(cfg, n_models=1)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, 1, 1)))
    fit = engine.make_fit(model, 5, epochs=4, batch_size=8, n_train=8, n_val=2,
                          learning_rate=1e-3, warmup_epochs=1, val_every=2)
    res = fit(np.arange(8)[None], np.arange(8, 10)[None], torch.from_numpy(x),
              torch.from_numpy(y.astype(np.int64)), seed=0)
    for k in ("val_loss", "val_acc", "val_f1"):
        assert np.isnan(res.history[k][0, [0, 2]]).all(), k
        assert np.isfinite(res.history[k][0, [1, 3]]).all(), k
    assert np.isfinite(res.history["loss"]).all()
    assert res.best_epoch[0] in (1, 3)
    with pytest.raises(ValueError, match="val_every"):
        engine.make_fit(model, 5, epochs=3, batch_size=8, n_train=8, n_val=2, val_every=2)


def test_epochs_past_the_budget_are_frozen():
    """``total_epochs=3`` in a 4-epoch fit (``val_every=2``): the LR table
    spans 3 epochs, the 4th leaves no update and is never the best, and the
    history has 3 epochs, as a 3-epoch fit with the same table."""
    cfg = FASTConfig(**SMALL)
    x, y = _corpus(10, 2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    p0 = from_jax_params(init_jax_layout_params(cfg, 1, 1))
    runs = {}
    for epochs, val_every, total in ((4, 2, 3), (3, 1, None)):
        model = FAST(cfg, n_models=1)
        model.load_state_dict(p0)
        fit = engine.make_fit(model, 5, epochs=epochs, batch_size=8, n_train=8, n_val=2,
                              learning_rate=1e-3, warmup_epochs=1, val_every=val_every,
                              total_epochs=total)
        runs[epochs] = fit, fit(np.arange(8)[None], np.arange(8, 10)[None], xt, yt, seed=0)
    (fit, res), (fit3, res3) = runs[4], runs[3]
    np.testing.assert_array_equal(fit.lr_table, fit3.lr_table)
    for k, p in res3.params.items():
        torch.testing.assert_close(res.params[k], p, rtol=0, atol=0, msg=k)
    assert all(v.shape == (1, 3) for v in res.history.values())
    np.testing.assert_array_equal(res.history["loss"], res3.history["loss"])
    assert np.isfinite(res.history["val_acc"][0, 1]) and np.isnan(res.history["val_acc"][0, [0, 2]]).all()
    assert res.best_epoch[0] == 1


class TestStackedModel:
    def test_stacked_logits_equal_per_model(self):
        cfg = FASTConfig(**SMALL)
        tree = init_jax_layout_params(cfg, 4, 3)
        stacked = FAST(cfg, n_models=3).eval()
        stacked.load_state_dict(from_jax_params(tree))
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2, 10, 200)).astype(np.float32))
        with torch.no_grad():
            out = stacked(x)
            for i in range(3):
                single = FAST(cfg).eval()
                single.load_state_dict(from_jax_params(jax.tree.map(lambda v: v[i], tree)))
                torch.testing.assert_close(out[i], single(x[i]), rtol=1e-5, atol=1e-6)

    def test_stacked_transplant_round_trip_is_bit_exact(self):
        tree = init_jax_layout_params(FASTConfig(**SMALL), 2, 3)
        back = to_jax_params(from_jax_params(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    def test_stacked_jax_tree_loads_with_vmap_shapes(self):
        jcfg = JaxFASTConfig(**SMALL)
        _, params, _ = _stacked_jax_init(jcfg, 2, 0)
        model = FAST(FASTConfig(**SMALL), n_models=2)
        model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))  # strict
        ours = init_jax_layout_params(FASTConfig(**SMALL), 0, 2)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(params)):
            assert a.shape == b.shape and a.dtype == b.dtype

    def test_dropout_needs_training_mode_and_a_generator(self):
        cfg = FASTConfig(**{**SMALL, "dropout": 0.5})
        model = FAST(cfg, n_models=2)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, 0, 2)))
        x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 10, 200)).astype(np.float32))
        with torch.no_grad():
            model.eval()
            ref = model(x, generator=torch.Generator().manual_seed(0))
            assert torch.equal(model(x), ref)  # eval needs no generator
            model.train()
            with pytest.raises(ValueError, match="needs a torch.Generator"):
                model(x)
            a = model(x, generator=torch.Generator().manual_seed(0))
            b = model(x, generator=torch.Generator().manual_seed(0))
            c = model(x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and not torch.equal(a, ref) and not torch.equal(a, c)

    def test_dropout_keeps_the_expected_share(self):
        from imagined_speech_decoding_tpu_torch.models.modules import dropout

        x = torch.ones(200_000)
        y = dropout(x, 0.1, torch.Generator().manual_seed(0), True)
        kept = y != 0
        assert abs(float(kept.float().mean()) - 0.9) < 0.005
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
        assert torch.equal(dropout(x, 0.1, torch.Generator(), False), x)
