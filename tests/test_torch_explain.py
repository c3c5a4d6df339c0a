"""The PyTorch port's integrated gradients (plain path on the CPU) against
the JAX package's ``integrated_gradients``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.explain.attribution import (
    integrated_gradients as jax_integrated_gradients,
)
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.explain.attribution import integrated_gradients
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
