"""The port's train-time augmentation (``ops/augment.py``,
``models.api.make_augmented_model``, the engine's augmented train step)
against the JAX package on the CPU: the chain on JAX's own draws from
one key (the test reproduces JAX's key splits), one augmented training
step against JAX's augmented model, the generator's draws, evaluation
untouched, and the CLI's ``--augment``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.models.api import make_augmented_model as jax_augmented
from imagined_speech_decoding_tpu.models.api import make_fast_model as jax_fast_model
from imagined_speech_decoding_tpu.ops import augment as jax_augment
from imagined_speech_decoding_tpu.train.metrics import cross_entropy as jax_cross_entropy
from imagined_speech_decoding_tpu_torch import config, transplant
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.models.api import make_augmented_model, make_fast_model
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.models.modules import SharedRowsGenerator
from imagined_speech_decoding_tpu_torch.ops import augment
from imagined_speech_decoding_tpu_torch.train import engine

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
SMALL = dict(
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)


def _jax_draws(key, shape, ch_drop):
    """JAX ``augment_batch``'s draws from ``key``: its split, then the
    noise from the first half and the channel keeps from the second."""
    k1, k2 = jax.random.split(key)
    noise = jax.random.normal(k1, shape, jnp.float32)
    keep = jax.random.bernoulli(k2, 1.0 - ch_drop, shape[:-1])
    return np.array(noise), np.array(keep)  # writable copies


@pytest.mark.parametrize("sigma,ch_drop", [(0.1, 0.1), (0.5, 0.4)])
def test_chain_on_jax_draws_matches_jax(sigma, ch_drop):
    x = np.random.default_rng(0).normal(size=(3, 6, 10, 40)).astype(np.float32) * 4.0
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax_augment.augment_batch(key, jnp.asarray(x), sigma, ch_drop))
    noise, keep = _jax_draws(key, x.shape, ch_drop)
    ours = augment.augment_with_draws(torch.from_numpy(x), torch.from_numpy(noise),
                                      torch.from_numpy(keep), sigma)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    dropped = ~keep
    assert dropped.any() and (ours.numpy()[dropped] == 0).all()  # whole channels, no rescale
    survivors = keep[..., None] & np.ones(x.shape, bool)
    np.testing.assert_allclose(ours.numpy()[survivors],
                               (torch.from_numpy(x) + sigma * torch.from_numpy(x).std(
                                   dim=(-2, -1), keepdim=True, correction=0)
                                * torch.from_numpy(noise)).numpy()[survivors], rtol=1e-6)


def test_generator_draws():
    """``augment_batch`` draws from its generator: a seed gives the same
    batch, another seed another; a ``SharedRowsGenerator`` repeats its
    first rows' draws along the model axis; no generator raises."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 3, 6, 20)).astype(np.float32))
    a = augment.augment_batch(x, 0.1, 0.2, torch.Generator().manual_seed(3))
    b = augment.augment_batch(x, 0.1, 0.2, torch.Generator().manual_seed(3))
    c = augment.augment_batch(x, 0.1, 0.2, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = SharedRowsGenerator().manual_seed(3)
    gen.row_repeats = 2
    twice = x[:2].repeat(2, 1, 1, 1)  # rows 2, 3 repeat rows 0, 1
    shared = augment.augment_batch(twice, 0.1, 0.2, gen)
    assert torch.equal(shared[:2], shared[2:]) and not torch.equal(shared, twice)
    with pytest.raises(ValueError, match="Generator"):
        augment.augment_batch(x, 0.1, 0.2, None)


def test_augmented_step_matches_jax_on_its_draws(monkeypatch):
    """One ``engine.train_step`` with augmentation against JAX's augmented
    model (``make_augmented_model``: the step key split into augment and
    model halves) under ``jax.value_and_grad`` and ``optax.adamw``, the
    port fed JAX's draws of the augment half: the parameters after it."""
    sigma, ch_drop, lr = 0.2, 0.3, 1e-3
    jcfg = jax_config.FASTConfig(**SMALL)
    jmodel = jax_augmented(jax_fast_model(jcfg), sigma, ch_drop)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 10, 200)).astype(np.float32)
    y = rng.integers(0, 5, 6)
    key = jax.random.PRNGKey(9)

    def loss(p):
        logits, _ = jmodel.apply(p, state, jnp.asarray(x), train=True, rng=key)
        return jax_cross_entropy(logits, jnp.asarray(y), jnp.ones(6))

    g = jax.grad(loss)(params)
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    upd, _ = tx.update(g, tx.init(params), params)
    ref = optax.apply_updates(params, upd)

    noise, keep = _jax_draws(jax.random.split(key)[0], x.shape, ch_drop)
    monkeypatch.setattr(engine, "augment_batch", lambda xb, s, p, gen: augment.augment_with_draws(
        xb, torch.from_numpy(noise)[None], torch.from_numpy(keep)[None], s))
    model = FAST(config.FASTConfig(**SMALL), n_models=1)
    model.load_state_dict(transplant.from_jax_params(
        jax.tree.map(lambda a: np.asarray(a)[None], params)))
    opt = engine.make_optimizer(model.parameters(), 0.01)
    engine.train_step(model, opt, torch.from_numpy(x)[None], torch.from_numpy(y)[None], lr, 5,
                      torch.Generator(), augment=(sigma, ch_drop))
    ours = transplant.to_jax_params(model.state_dict())
    grads = transplant.to_jax_params({k: p.grad for k, p in model.named_parameters()})
    for a, b, gr in zip(jax.tree.leaves(ours), jax.tree.leaves(ref), jax.tree.leaves(g)):
        sure = np.abs(np.asarray(gr)) > 1e-6  # a first AdamW step is lr * sign(g)
        np.testing.assert_allclose(a[0][sure], np.asarray(b)[sure], rtol=RTOL, atol=ATOL)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(g)):
        np.testing.assert_allclose(a[0], np.asarray(b), rtol=RTOL, atol=ATOL)


def _fit(augment_arg, x, dtype):
    cfg = config.FASTConfig(**SMALL)
    model = FAST(cfg, n_models=2)
    model.load_state_dict(transplant.from_jax_params(transplant.init_jax_layout_params(cfg, 1, 2)))
    fit = engine.make_fit(model, 5, epochs=2, batch_size=6, n_train=12, n_val=4,
                          learning_rate=1e-3, warmup_epochs=1, augment=augment_arg,
                          compute_dtype=dtype)
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.integers(0, 5, 16))
    perms = np.stack([rng.permutation(16) for _ in range(2)])
    return model, fit(perms[:, :12], perms[:, 12:], x, y, seed=5)


def test_zero_augmentation_is_the_plain_fit():
    """At ``noise_sigma = ch_drop = 0`` the augmented fit is the plain fit
    bit for bit (the noise is multiplied by 0, every channel kept): the
    augmentation sits in the train step only, before the cast."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(16, 10, 200)).astype(np.float32))
    _, plain = _fit(None, x, torch.float32)
    _, aug = _fit((0.0, 0.0), x, torch.float32)
    for k in plain.params:
        assert torch.equal(plain.params[k], aug.params[k]), k
    for k in plain.history:
        np.testing.assert_array_equal(plain.history[k], aug.history[k])


def test_evaluation_is_untouched():
    """An augmented model's evaluation on an f32 corpus cast to bf16 per
    batch equals the un-augmented evaluation on the bf16 corpus, bit for
    bit, and augmentation changes the training trajectory."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(16, 10, 200)).astype(np.float32))
    model, aug = _fit((0.1, 0.1), x, torch.bfloat16)
    _, plain = _fit(None, x.to(torch.bfloat16), torch.bfloat16)
    assert not np.array_equal(aug.history["loss"], plain.history["loss"])
    y = torch.from_numpy(np.random.default_rng(6).integers(0, 5, 16))
    idx = torch.arange(16).repeat(2, 1)
    got = engine.evaluate(model, x, y, idx, 8, 5, torch.bfloat16)
    want = engine.evaluate(model, x.to(torch.bfloat16), y, idx, 8, 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("head", ["Conv4Layers", "CVBlock"])
def test_cli_augment_runs(tmp_path, head, capsys):
    """``cli.train_fast --augment`` trains (bf16, the default precision) and
    writes the result tree; the ModelDef carries the rates."""
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n"
                        "  num_heads: 4\n")
    out = tmp_path / "out"
    res = train_fast.main(["--config", str(cfg_path), "--synthetic", "1", "--synthetic_trials",
                           "10", "--epochs", "1", "--batch_size", "8", "--augment",
                           "--noise_sigma", "0.2", "--ch_drop", "0.05", "--head", head,
                           "--output_dir", str(out)], device="cpu")
    assert "augment: noise_sigma=0.2 ch_drop=0.05" in capsys.readouterr().out
    assert (out / "sub-01" / "best_subject.npz").is_file()
    assert all(np.isfinite(v).all() for v in res.fit.history.values())
    mdef = make_augmented_model(make_fast_model(config.FASTConfig()), 0.2, 0.05)
    assert mdef.augment == (0.2, 0.05) and make_fast_model(config.FASTConfig()).augment is None
