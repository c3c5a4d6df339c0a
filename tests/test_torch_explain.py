"""The PyTorch port's attributions (plain path on the CPU) against the JAX
package's ``integrated_gradients``, ``expected_gradients`` and
``attribution_for_predictions``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.explain.attribution import (
    attribution_for_predictions as jax_attribution_for_predictions,
)
from imagined_speech_decoding_tpu.explain.attribution import (
    expected_gradients as jax_expected_gradients,
)
from imagined_speech_decoding_tpu.explain.attribution import (
    integrated_gradients as jax_integrated_gradients,
)
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.explain.attribution import (
    attribution_for_predictions,
    expected_gradients,
    expected_gradients_from_draws,
    integrated_gradients,
)
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params

torch.set_num_threads(1)

SMALL = dict(  # tests/test_pallas_head.py:14-29
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.1,
)


def test_integrated_gradients_match_jax():
    jmodel = make_fast_model(JaxFASTConfig(**SMALL))
    params, state = jmodel.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 10, 200)).astype(np.float32)
    base = rng.normal(size=(10, 200)).astype(np.float32) * 0.1
    target = np.array([0, 3, 4])
    ref = jax_integrated_gradients(jmodel.apply, params, state, jnp.asarray(x),
                                   jnp.asarray(target), jnp.asarray(base), n_steps=8)
    model = FAST(FASTConfig(**SMALL)).train()
    model.load_state_dict(from_jax_params(params))
    ours = integrated_gradients(model, torch.from_numpy(x), torch.from_numpy(target),
                                torch.from_numpy(base), n_steps=8)
    ref = np.asarray(ref)
    assert np.abs(ours.numpy() - ref).max() / np.abs(ref).max() < 1e-4
    # model state restored: still in training mode, weights still trainable
    assert model.training and all(p.requires_grad for p in model.parameters())
    # completeness: the attributions sum to f(x) - f(baseline), up to the path quadrature
    with torch.no_grad():
        model.eval()
        f = model(torch.from_numpy(x)).gather(1, torch.from_numpy(target)[:, None])[:, 0]
        f0 = model(torch.from_numpy(base).expand(3, 10, 200)).gather(
            1, torch.from_numpy(target)[:, None])[:, 0]
    np.testing.assert_allclose(ours.sum(dim=(1, 2)).numpy(), (f - f0).numpy(), rtol=0.1,
                               atol=0.05)


def _models_and_data(n_trials=3, n_bg=6):
    jmodel = make_fast_model(JaxFASTConfig(**SMALL))
    params, state = jmodel.init(jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    model = FAST(FASTConfig(**SMALL)).train()
    model.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n_trials, 10, 200)).astype(np.float32)
    bg = rng.normal(size=(n_bg, 10, 200)).astype(np.float32)
    return jmodel, params, state, model, x, bg


def _jax_draws(key, n_samples, n_trials, n_bg):
    """The draws of JAX's ``expected_gradients`` (its ``:70-73``)."""
    kb, ka = jax.random.split(key)
    return (np.asarray(jax.random.randint(kb, (n_samples, n_trials), 0, n_bg)),
            np.asarray(jax.random.uniform(ka, (n_samples, n_trials))))


def test_expected_gradients_match_jax():
    jmodel, params, state, model, x, bg = _models_and_data()
    target = np.array([1, 4, 0])
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_expected_gradients(jmodel.apply, params, state, jnp.asarray(x),
                                            jnp.asarray(bg), jnp.asarray(target), key,
                                            n_samples=6))
    bg_idx, alphas = _jax_draws(key, 6, 3, 6)
    ours = expected_gradients_from_draws(model, torch.from_numpy(x), torch.from_numpy(bg),
                                         torch.from_numpy(target), torch.from_numpy(bg_idx),
                                         torch.from_numpy(alphas))
    assert np.abs(ours.numpy() - ref).max() / np.abs(ref).max() < 1e-4
    assert model.training and all(p.requires_grad for p in model.parameters())


def test_expected_gradients_draws_from_the_generator():
    """The public entry draws (bg_idx, alphas) from its generator, in that
    order, and is the draws' entry on them."""
    _, _, _, model, x, bg = _models_and_data()
    x, bg, target = torch.from_numpy(x), torch.from_numpy(bg), torch.tensor([2, 2, 3])
    ours = expected_gradients(model, x, bg, target, torch.Generator().manual_seed(9), n_samples=4)
    gen = torch.Generator().manual_seed(9)
    bg_idx = torch.randint(0, 6, (4, 3), generator=gen)
    alphas = torch.rand((4, 3), generator=gen)
    assert torch.equal(ours, expected_gradients_from_draws(model, x, bg, target, bg_idx, alphas))
    assert not torch.equal(ours, expected_gradients(model, x, bg, target,
                                                    torch.Generator().manual_seed(10), 4))


def test_attribution_for_predictions_matches_jax():
    """The predictions equal JAX's; the attributions are expected gradients
    for them."""
    jmodel, params, state, model, x, bg = _models_and_data(n_trials=8)
    _, jpreds = jax_attribution_for_predictions(jmodel.apply, params, state, jnp.asarray(x),
                                                jnp.asarray(bg), jax.random.PRNGKey(0),
                                                n_samples=2)
    xt, bgt = torch.from_numpy(x), torch.from_numpy(bg)
    attr, preds = attribution_for_predictions(model, xt, bgt, torch.Generator().manual_seed(3),
                                              n_samples=3)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    ref = expected_gradients(model, xt, bgt, preds, torch.Generator().manual_seed(3), 3)
    assert attr.shape == (8, 10, 200) and torch.equal(attr, ref)
