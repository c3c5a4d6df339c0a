"""PyTorch port's Conv4Layers head (plain path on the CPU) against the JAX
package: the fused-weight prep, the full-sequence XLA head and the
Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.data.constants import zone_layout
from imagined_speech_decoding_tpu.models.fast import fast_init
from imagined_speech_decoding_tpu.models.heads import (
    conv4layers_fused_all_zones_fullseq,
    conv4layers_prepare_fused_weights,
)
from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    fused_conv4_head,
    fused_conv4_head_plain,
)
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas_head.py

ELECTRODES = tuple(f"E{i}" for i in range(10))
ZONES = {"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"), "D": ("E9",)}
SMALL = dict(
    electrodes=ELECTRODES, zone_dict=ZONES, dim_cnn=8, dim_token=16, seq_len=200,
    window_len=100, slide_step=50, head="Conv4Layers", n_classes=5, num_layers=1,
    num_heads=4, dropout=0.0,
)
FULL = dict(dropout=0.0)  # FASTConfig.default() widths


def _setup(kw, batch, seed):
    """JAX params + config, the port model carrying the same weights, inputs."""
    if kw is FULL:
        from imagined_speech_decoding_tpu.data.constants import Electrodes, Zones

        kw = dict(electrodes=Electrodes, zone_dict=Zones, **FULL)
    jcfg = JaxFASTConfig(**kw)
    params, state = fast_init(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    model = FAST(FASTConfig(**kw))
    model.load_state_dict(from_jax_params(params))
    x = np.random.default_rng(seed).normal(size=(batch, jcfg.n_channels, jcfg.seq_len))
    return jcfg, params, state, model, x.astype(np.float32)


@pytest.fixture(scope="module")
def small():
    return _setup(SMALL, 4, 0)


@pytest.fixture(scope="module")
def full():
    return _setup(FULL, 2, 1)


def _ops(model):
    with torch.no_grad():
        return tuple(t[0] for t in model.head.fused_weights())  # one model: no model axis


class TestPreparedWeights:
    @pytest.mark.parametrize("geometry", ["small", "full"])
    def test_match_jax(self, request, geometry):
        jcfg, params, _, model, _ = request.getfixturevalue(geometry)
        layout = zone_layout(jcfg.electrodes, jcfg.zone_dict)
        ref = conv4layers_prepare_fused_weights(
            params["head"], layout.indices, layout.mask, jcfg.n_channels
        )
        for name, ours, theirs in zip(("w12", "b12", "w3", "w4"), _ops(model), ref):
            np.testing.assert_allclose(
                ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL, err_msg=name
            )


class TestHeadForward:
    @pytest.mark.parametrize("geometry", ["small", "full"])
    def test_matches_jax_fullseq(self, request, geometry):
        jcfg, params, _, model, x = request.getfixturevalue(geometry)
        layout = zone_layout(jcfg.electrodes, jcfg.zone_dict)
        ref = conv4layers_fused_all_zones_fullseq(
            params["head"], jnp.asarray(x), layout.indices, layout.mask,
            jcfg.window_len, jcfg.slide_step, train=False,
        )
        with torch.no_grad():
            ours = model.forward_head(torch.from_numpy(x))
        assert ours.shape == (x.shape[0], jcfg.n_tokens, layout.n_zones, jcfg.dim_cnn)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_plain_matches_pallas_interpret(self, small):
        jcfg, _, _, model, x = small
        ops = _ops(model)
        with pltpu.force_tpu_interpret_mode():
            ref = pallas_head(
                jnp.asarray(x), *(jnp.asarray(t.numpy()) for t in ops),
                jcfg.window_len, jcfg.slide_step,
            )
        ours = fused_conv4_head_plain(torch.from_numpy(x), *ops, jcfg.window_len, jcfg.slide_step)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_plain_other_step_matches_jax_fullseq(self, small):
        """Overlapping windows at a step other than the config's."""
        jcfg, params, _, model, x = small
        layout = zone_layout(jcfg.electrodes, jcfg.zone_dict)
        ref = conv4layers_fused_all_zones_fullseq(
            params["head"], jnp.asarray(x), layout.indices, layout.mask,
            jcfg.window_len, 25, train=False,
        )
        ours = fused_conv4_head_plain(torch.from_numpy(x), *_ops(model), jcfg.window_len, 25)
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(ref).reshape(ours.shape), rtol=RTOL, atol=ATOL
        )

    def test_cpu_route_is_plain_and_uncounted(self, small):
        jcfg, _, _, model, x = small
        ops = _ops(model)
        xt = torch.from_numpy(x)
        before = fused_conv4_head.launches
        ours = fused_conv4_head(xt, *ops, jcfg.window_len, jcfg.slide_step)
        assert fused_conv4_head.launches == before
        plain = fused_conv4_head_plain(xt, *ops, jcfg.window_len, jcfg.slide_step)
        assert torch.equal(ours, plain)

    def test_non_cpu_tensor_never_falls_back(self, small):
        jcfg, _, _, model, x = small
        ops = [t.to("meta") for t in _ops(model)]
        with pytest.raises(ValueError, match="CUDA tensor"):
            fused_conv4_head(torch.zeros(x.shape, device="meta"), *ops,
                             jcfg.window_len, jcfg.slide_step)

    def test_inconsistent_operands_raise(self, small):
        jcfg, _, _, model, x = small
        w12, b12, w3, w4 = _ops(model)
        with pytest.raises(ValueError, match="inconsistent"):
            fused_conv4_head(torch.from_numpy(x)[:, :7], w12, b12, w3, w4,
                             jcfg.window_len, jcfg.slide_step)
