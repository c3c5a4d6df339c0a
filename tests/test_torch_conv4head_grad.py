"""Gradients of the PyTorch port's Conv4Layers head (plain path on the CPU,
the plain version of kernels B2w and B2x) against ``jax.grad`` through the
JAX package's XLA head and through its Pallas head in interpret mode, and
stacked (model-axis) gradients against per-model ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.data.constants import Electrodes, Zones, zone_layout
from imagined_speech_decoding_tpu.models.fast import fast_init
from imagined_speech_decoding_tpu.models.heads import conv4layers_fused_all_zones_fullseq
from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    _adapted,
    _bwd_x_zone_splits,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    fused_conv4_head_plain,
)
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params

torch.set_num_threads(1)

REL = 1e-4  # max|port - ref| / max|ref| per tensor (tests/test_pallas_head.py:69-73)

SMALL = dict(  # tests/test_pallas_head.py:14-29
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)
FULL = dict(electrodes=Electrodes, zone_dict=Zones, dropout=0.0)
HEAD_LEAVES = (("cnn1", "w", "cnn1_weight"), ("cnn1", "b", "cnn1_bias"),
               ("cnn2", "w", "cnn2_weight"), ("cnn3", "w", "cnn3_weight"),
               ("cnn4", "w", "cnn4_weight"))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _jax_params(kw, seed, n_models=None):
    cfg = JaxFASTConfig(**kw)
    if n_models is None:
        params, _ = fast_init(jax.random.PRNGKey(seed), cfg)
    else:
        keys = jax.random.split(jax.random.PRNGKey(seed), n_models)
        params = jax.vmap(lambda k: fast_init(k, cfg)[0])(keys)
    return cfg, jax.tree.map(np.asarray, params)


def _port_head_grads(model, x, cot):
    """Gradients of ``<cot, forward_head(x)>`` w.r.t. the head's parameters and x."""
    model.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (model.forward_head(xt) * torch.from_numpy(cot)).sum().backward()
    grads = {jax_name: getattr(model.head, name).grad.numpy()
             for jax_name, _, name in [(f"{a}.{b}", b, n) for a, b, n in HEAD_LEAVES]}
    return grads, xt.grad.numpy()


def _jax_head_grads(cfg, head_params, x, cot):
    layout = zone_layout(cfg.electrodes, cfg.zone_dict)

    def loss(p, xx):
        feat = conv4layers_fused_all_zones_fullseq(
            p, xx, layout.indices, layout.mask, cfg.window_len, cfg.slide_step, train=True
        )
        return jnp.sum(feat * cot)

    gp, gx = jax.grad(loss, argnums=(0, 1))(head_params, jnp.asarray(x))
    return {f"{a}.{b}": np.asarray(gp[a][b]) for a, b, _ in HEAD_LEAVES}, np.asarray(gx)


@pytest.mark.parametrize("geometry,batch", [("small", 3), ("full", 2)])
def test_head_grads_match_jax_xla_head(geometry, batch):
    kw = SMALL if geometry == "small" else FULL
    jcfg, params = _jax_params(kw, 0)
    model = FAST(FASTConfig(**kw))
    model.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(batch, jcfg.n_channels, jcfg.seq_len)).astype(np.float32)
    cot = rng.normal(size=(batch, jcfg.n_tokens, jcfg.n_zones, jcfg.dim_cnn)).astype(np.float32)
    ours, ours_x = _port_head_grads(model, x, cot)
    ref, ref_x = _jax_head_grads(jcfg, params["head"], x, cot)
    for name in ref:
        assert ours[name].shape == ref[name].shape, name
        assert rel_err(ours[name], ref[name]) < REL, (name, rel_err(ours[name], ref[name]))
    assert rel_err(ours_x, ref_x) < REL


def test_stacked_full_width_grads_match_jax_per_model():
    """M = 2 models, B = 2 trials each, at full width: the stacked head's
    gradients against ``jax.grad`` of each model's XLA head."""
    m, b = 2, 2
    jcfg, params = _jax_params(FULL, 3, n_models=m)
    model = FAST(FASTConfig(**FULL), n_models=m)
    model.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(m, b, 64, jcfg.seq_len)).astype(np.float32)
    cot = rng.normal(size=(m, b, jcfg.n_tokens, jcfg.n_zones, jcfg.dim_cnn)).astype(np.float32)
    ours, ours_x = _port_head_grads(model, x, cot)
    for i in range(m):
        head_i = jax.tree.map(lambda v: v[i], params["head"])
        ref, ref_x = _jax_head_grads(jcfg, head_i, x[i], cot[i])
        for name in ref:
            assert rel_err(ours[name][i], ref[name]) < REL, (i, name)
        assert rel_err(ours_x[i], ref_x) < REL


def test_plain_bwd_matches_pallas_interpret():
    """``conv4head_bwd_plain`` (what B2w and B2x are held against on the
    card) against the Pallas head's custom VJP (``_bwd_w_kernel`` and
    ``_bwd_x_kernel``) in interpret mode, on the same fused operands."""
    jcfg, params = _jax_params(SMALL, 2)
    model = FAST(FASTConfig(**SMALL))
    model.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        ops = model.head.fused_weights()  # model axis of 1
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 10, 150)).astype(np.float32)
    n = (150 - jcfg.window_len) // jcfg.slide_step + 1
    g = rng.normal(size=(8, n, 4 * jcfg.dim_cnn)).astype(np.float32)
    ops_j = [jnp.asarray(t[0].numpy()) for t in ops]

    def loss(xx, *w):
        return jnp.sum(pallas_head(xx, *w, jcfg.window_len, jcfg.slide_step) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *ops_j)
    ours = conv4head_bwd_plain(torch.from_numpy(g)[None], torch.from_numpy(x)[None], *ops,
                               jcfg.window_len, jcfg.slide_step)
    for name, a, b in zip(("dx", "dw12", "db12", "dw3", "dw4"), ours, ref):
        assert tuple(a.shape) == (1,) + b.shape, name
        assert rel_err(a[0].numpy(), b) < REL, (name, rel_err(a[0].numpy(), b))


def test_stacked_grads_equal_per_model():
    """A stack of M models differentiates as M separate models."""
    m = 3
    jcfg, params = _jax_params(SMALL, 6, n_models=m)
    stacked = FAST(FASTConfig(**SMALL), n_models=m)
    stacked.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(m, 2, 10, jcfg.seq_len)).astype(np.float32)
    cot = rng.normal(size=(m, 2, jcfg.n_tokens, 4, jcfg.dim_cnn)).astype(np.float32)
    ours, ours_x = _port_head_grads(stacked, x, cot)
    for i in range(m):
        single = FAST(FASTConfig(**SMALL))
        single.load_state_dict(from_jax_params(jax.tree.map(lambda v: v[i], params)))
        ref, ref_x = _port_head_grads(single, x[i], cot[i])
        for name in ref:
            np.testing.assert_allclose(ours[name][i], ref[name], rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        np.testing.assert_allclose(ours_x[i], ref_x, rtol=1e-5, atol=1e-7)


def test_kernel_wrappers_route_cpu_tensors_to_plain():
    """On CPU tensors the B2w / B2x wrappers are the plain backward and
    count no launch."""
    jcfg, params = _jax_params(SMALL, 8)
    model = FAST(FASTConfig(**SMALL))
    model.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        ops = model.head.fused_weights()  # model axis of 1
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 10, 200)).astype(np.float32))[None]
    g = torch.from_numpy(rng.normal(size=(2, jcfg.n_tokens, 32)).astype(np.float32))[None]
    before = (conv4head_bwd_w.launches, conv4head_bwd_x.launches)
    plain = conv4head_bwd_plain(g, x, *ops, jcfg.window_len, jcfg.slide_step)
    for a, b in zip(conv4head_bwd_w(g, x, *ops, jcfg.window_len, jcfg.slide_step), plain[1:]):
        assert torch.equal(a, b)
    assert torch.equal(conv4head_bwd_x(g, x, *ops, jcfg.window_len, jcfg.slide_step), plain[0])
    assert (conv4head_bwd_w.launches, conv4head_bwd_x.launches) == before
    out = fused_conv4_head_plain(x, *ops, jcfg.window_len, jcfg.slide_step)
    assert out.shape == g.shape


@pytest.mark.parametrize("c", [10, 12, 63])
def test_b2w_refuses_channels_not_a_multiple_of_8(c):
    """The B2w kernel refuses C % 8 != 0 (a reduction step of 8 rows must
    not straddle two taps), so the wrapper never hands it one: ``_adapted``
    zero-pads x and w12 to the next multiple of 8 channels and cuts dw12
    back. Meta tensors take the kernel's route without a card: the wrapper
    stops at its CUDA check, with no launch; the padding is shown through a
    stand-in for the launch."""
    m, b, t, z, o, k, window, step = 1, 2, 200, 4, 32, 5, 100, 50
    n = (t - window) // step + 1
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty((m, b, c, t), **meta)
    w12, b12 = torch.empty((m, z * o, k * c), **meta), torch.empty((m, z * o, 1), **meta)
    w3 = w4 = torch.empty((m, z, o, k * o), **meta)
    g = torch.empty((m, b, n, z * o), **meta)
    before = conv4head_bwd_w.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv4head_bwd_w(g, x, w12, b12, w3, w4, window, step)
    assert conv4head_bwd_w.launches == before
    seen = []

    def launch(g_, x_, w12_, b12_, w3_, w4_, window_, step_):
        seen.append(x_.shape[2])
        assert w12_.shape[-1] == k * x_.shape[2]
        return tuple(torch.empty_like(w_) for w_ in (w12_, b12_, w3_, w4_))

    grads, adapted = _adapted("bwd_w", launch, g, x, w12, b12, w3, w4, window, step)
    assert adapted and seen == [c + (-c) % 8]
    assert [t.shape for t in grads] == [w12.shape, b12.shape, w3.shape, w4.shape]


@pytest.mark.parametrize("m,b,want", [
    (1, 16, 8), (2, 8, 8), (1, 1, 8),  # 80 / 80 / 5 blocks of 8 zones leave SMs idle: split
    (1, 64, 2),  # 320 blocks are 3 waves of 8 zones; 640 of 4 zones are 5 waves
    (1, 100, 1), (75, 64, 1),  # whole waves already: no partial pass
])
def test_b2x_zone_splits_fill_the_card(m, b, want):
    """B2x's zone ranges on a 132-SM H100 at full width (5 windows, 8
    zones, C = 64, W = 250), as measured best on the card (PERF.md)."""
    assert _bwd_x_zone_splits(m, b, 5, 8, 64, 250, 132) == want


def test_b2x_raises_off_the_cpu_without_a_card():
    """Off the CPU, B2x launches or raises: it never falls back to the
    plain version. Meta tensors take the kernel's route without a card."""
    m, b, c, t, z, o, k, window, step = 1, 2, 10, 200, 4, 32, 5, 100, 50
    n = (t - window) // step + 1
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty((m, b, c, t), **meta)
    w12, b12 = torch.empty((m, z * o, k * c), **meta), torch.empty((m, z * o, 1), **meta)
    w3 = w4 = torch.empty((m, z, o, k * o), **meta)
    g = torch.empty((m, b, n, z * o), **meta)
    before = conv4head_bwd_x.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv4head_bwd_x(g, x, w12, b12, w3, w4, window, step)
    assert conv4head_bwd_x.launches == before
