"""PyTorch port's FAST (plain path on the CPU) against the JAX package:
config and constants field for field, the parameter transplant, and
logits with transplanted weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
import imagined_speech_decoding_tpu.data.constants as jax_constants
from imagined_speech_decoding_tpu.models.fast import fast_apply, fast_init
from imagined_speech_decoding_tpu_torch import config, transplant
from imagined_speech_decoding_tpu_torch.data import constants
from imagined_speech_decoding_tpu_torch.models.fast import FAST

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py

SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2", "F1", "F2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2"), "Frontal": ("F1", "F2")},
    dim_cnn=16, dim_token=16, seq_len=250, window_len=100, slide_step=50,
    num_layers=2, num_heads=4, dropout=0.0,
)


def _jax_params(cfg_kw, seed):
    jcfg = jax_config.FASTConfig(**cfg_kw) if cfg_kw else jax_config.FASTConfig.default()
    params, state = fast_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jax.tree.map(np.asarray, params), state


class TestConfigAndConstants:
    def test_fast_config_fields_match_jax(self):
        ours = [(f.name, f.default) for f in dataclasses.fields(config.FASTConfig)]
        theirs = [(f.name, f.default) for f in dataclasses.fields(jax_config.FASTConfig)]
        assert ours == theirs
        assert dataclasses.asdict(config.FASTConfig.default()) == dataclasses.asdict(
            jax_config.FASTConfig.default()
        )
        ours_d, theirs_d = config.FASTConfig.default(), jax_config.FASTConfig.default()
        for prop in ("n_tokens", "n_zones", "n_channels"):
            assert getattr(ours_d, prop) == getattr(theirs_d, prop)

    def test_constants_match_jax(self):
        assert constants.Electrodes == jax_constants.Electrodes
        assert constants.Zones == jax_constants.Zones
        assert constants.SFREQ == jax_constants.SFREQ

    @pytest.mark.parametrize("atlas", ["default", "small"])
    def test_zone_layout_matches_jax(self, atlas):
        args = () if atlas == "default" else (SMALL["electrodes"], SMALL["zone_dict"])
        ours, theirs = constants.zone_layout(*args), jax_constants.zone_layout(*args)
        assert ours.names == theirs.names
        for field in ("indices", "mask", "counts"):
            np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
            assert getattr(ours, field).dtype == getattr(theirs, field).dtype


class TestTransplant:
    def test_round_trip_is_bit_exact(self):
        _, params, _ = _jax_params(SMALL, 3)
        back = transplant.to_jax_params(transplant.from_jax_params(params))
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_state_dict_keys_cover_the_module(self):
        _, params, _ = _jax_params(SMALL, 3)
        model = FAST(config.FASTConfig(**SMALL))
        model.load_state_dict(transplant.from_jax_params(params))  # strict

    def test_numpy_init_has_the_jax_layout(self):
        """``init_jax_layout_params`` (what the chip smoke serves) has
        exactly ``fast_init``'s tree, shapes and dtypes."""
        _, params, _ = _jax_params(None, 0)
        ours = transplant.init_jax_layout_params(config.FASTConfig.default(), 0)
        assert jax.tree.structure(ours) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(params)):
            assert a.shape == b.shape and a.dtype == b.dtype


class TestLogits:
    @pytest.mark.parametrize("geometry", ["small", "full"])
    def test_match_jax_fast_apply(self, geometry):
        kw = SMALL if geometry == "small" else None
        jcfg, params, state = _jax_params(kw, 5)
        cfg = config.FASTConfig(**kw) if kw else config.FASTConfig.default()
        model = FAST(cfg).eval()
        model.load_state_dict(transplant.from_jax_params(params))
        x = np.random.default_rng(5).normal(size=(2, cfg.n_channels, cfg.seq_len))
        x = x.astype(np.float32)
        ref, _ = fast_apply(params, state, jnp.asarray(x), jcfg, train=False)
        with torch.no_grad():
            ours = model(torch.from_numpy(x))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_training_modes_not_ported_yet(self):
        model = FAST(config.FASTConfig(**SMALL))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model(torch.zeros(1, 10, 250), forward_mode="train_head")

    @pytest.mark.parametrize("head", ["CVBlock", "EEGNet_Encoder", "HeadConv_Paper_Version"])
    def test_other_heads_not_ported_yet(self, head):
        """Once refused, the other heads are ported: FAST builds with each,
        takes JAX's weights and running statistics, and its eval logits
        equal ``fast_apply``'s (tests/test_torch_heads.py holds the rest);
        an unknown head raises JAX's ``KeyError``."""
        kw = dict(SMALL, head=head)
        jcfg, params, state = _jax_params(kw, 4)
        model = FAST(config.FASTConfig(**kw)).eval()
        model.load_state_dict(transplant.from_jax_params(params, jax.tree.map(np.asarray, state)))
        x = np.random.default_rng(6).normal(size=(3, jcfg.n_channels, jcfg.seq_len))
        x = x.astype(np.float32)
        ref, _ = fast_apply(params, state, jnp.asarray(x), jcfg, train=False)
        with torch.no_grad():
            ours = model(torch.from_numpy(x))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        with pytest.raises(KeyError, match="unknown head"):
            FAST(config.FASTConfig(**dict(SMALL, head="NoSuchHead")))
