"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; every test skips without a card. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import dataclasses

import numpy as np
import pytest
import scipy.signal as sps
import torch

from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.explain.attribution import attribution_for_predictions
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    _launch_bwd_x,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    conv4head_bwd_x_plain,
    fused_conv4_head,
    fused_conv4_head_plain,
)
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    default_padlen,
    prepare_filter,
    sosfilt_time_major,
    sosfilt_time_major_plain,
    sosfiltfilt_chain,
    sosfiltfilt_chain_plain,
)
from imagined_speech_decoding_tpu_torch.ops.filters import butter_sos, notch_ba, sosfiltfilt
from imagined_speech_decoding_tpu_torch.serving import make_online_decoder
from imagined_speech_decoding_tpu_torch.transplant import (
    from_jax_params,
    init_jax_layout_params,
)

pytestmark = pytest.mark.cuda

ELECTRODES = tuple(f"E{i}" for i in range(10))
ZONES = {"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"), "D": ("E9",)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# butter_sos(order=N) band-pass has N sections; the kernel takes S = 1 to 8.
@pytest.mark.parametrize("rows,t_len,order", [
    (1, 50, 4), (111, 300, 4), (4096, 64, 1),  # one tile
    (33, 2048, 8), (5, 2500, 2),  # several tiles; R not a multiple of 32
    (9000, 300, 4),  # one lane a row (more than 8,192 rows)
] + [(45, 400, order) for order in (2, 3, 5, 6, 7)])  # every S from 1 to 8
def test_iir_kernel_matches_plain(dev, rows, t_len, order):
    rng = np.random.default_rng(rows)
    sos = butter_sos(250.0, 4.0, 40.0, order)
    xt = torch.tensor(rng.normal(size=(t_len, rows)).astype(np.float32), device=dev)
    zi = torch.tensor(rng.normal(size=(2 * sos.shape[0], rows)).astype(np.float32), device=dev)
    before = sosfilt_time_major.launches
    y, zf = sosfilt_time_major(sos, xt, zi)
    torch.cuda.synchronize()
    assert sosfilt_time_major.launches == before + 1
    y_ref, zf_ref = sosfilt_time_major_plain(sos, xt, zi)
    tol = 1e-4 * float(y_ref.abs().max())
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=tol)
    torch.testing.assert_close(zf, zf_ref, rtol=1e-4, atol=tol)


def _iir_close(got, ref):
    # rtol 1e-4, atol 1e-4 * max|ref|: the JAX package's Pallas IIR tolerance
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


NOTCH = sps.tf2sos(*notch_ba(250.0, 60.0))


@pytest.mark.parametrize("orders,rows,t_len,padlens", [
    ((None, 4), 64, 800, None),  # the decode chain at B = 1
    ((None, 4), 37, 400, None),  # R not a multiple of 32
    ((4,), 1, default_padlen(butter_sos(250.0, 4.0, 40.0, 4)) + 1, None),  # T = padlen + 1
    ((8,), 5, 2048, None),  # several tiles per pass
    ((None,), 3, 10, None),  # the notch at T = padlen + 1
    ((2, 4), 33, 400, (0, 0)),  # no extension
    ((3, 5), 9, 400, (0, 120)),
    ((6, 7), 70, 2048, (2047, 30)),  # the longest row: 6142 samples extended
    ((None, 4), 2048, 800, None),  # the most rows at 32 lanes a row
    ((None, 4), 2049, 800, None),  # the fewest at 16
] + [((order,), 45, 400, None) for order in range(1, 9)])  # every S from 1 to 8
def test_chain_kernel_matches_plain(dev, orders, rows, t_len, padlens):
    chain = [prepare_filter(NOTCH if o is None else butter_sos(250.0, 4.0, 40.0, o))
             for o in orders]
    x = torch.tensor(np.random.default_rng(rows + t_len).normal(size=(rows, t_len))
                     .astype(np.float32), device=dev)
    before = sosfiltfilt_chain.launches
    y = sosfiltfilt_chain(chain, x, padlens)
    torch.cuda.synchronize()
    assert sosfiltfilt_chain.launches == before + 1
    _iir_close(y, sosfiltfilt_chain_plain(chain, x, padlens))


def test_iir_kernels_are_deterministic(dev):
    rng = np.random.default_rng(3)
    chain = [prepare_filter(NOTCH), prepare_filter(butter_sos(250.0, 4.0, 40.0, 4))]
    x = torch.tensor(rng.normal(size=(8, 64, 800)).astype(np.float32), device=dev)
    assert torch.equal(sosfiltfilt_chain(chain, x), sosfiltfilt_chain(chain, x))
    sos = butter_sos(250.0, 4.0, 40.0, 4)
    xt = torch.tensor(rng.normal(size=(854, 512)).astype(np.float32), device=dev)
    zi = torch.tensor(rng.normal(size=(8, 512)).astype(np.float32), device=dev)
    for a, b in zip(sosfilt_time_major(sos, xt, zi), sosfilt_time_major(sos, xt, zi)):
        assert torch.equal(a, b)


def test_decode_makes_one_filter_launch(dev):
    """A decode runs its notch and band-pass as one chain launch and never
    the causal entry."""
    cfg = FASTConfig(electrodes=ELECTRODES, zone_dict=ZONES, dim_cnn=32, dim_token=16,
                     num_layers=1, num_heads=4)
    params = init_jax_layout_params(cfg, 2)
    x = np.random.default_rng(4).normal(size=(2, 10, 800)).astype(np.float32)
    decode = make_online_decoder(FAST(cfg, device=dev), params)
    before = (sosfiltfilt_chain.launches, sosfilt_time_major.launches)
    for _ in range(3):
        post = decode(x)
    assert (sosfiltfilt_chain.launches, sosfilt_time_major.launches) == (before[0] + 3, before[1])
    ref = make_online_decoder(FAST(cfg), params)(x)
    np.testing.assert_allclose(post, ref, rtol=1e-4, atol=1e-5)


def test_sosfiltfilt_on_card_matches_scipy(dev):
    x = np.random.default_rng(0).normal(size=(3, 5, 400)).astype(np.float32)
    sos = butter_sos(250.0, 4.0, 40.0, 4)
    ours = sosfiltfilt(sos, torch.tensor(x, device=dev)).cpu().numpy()
    ref = sps.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize(
    "batch,seq_len,window_len,step", [(1, 200, 100, 50), (3, 200, 100, 50), (2, 230, 120, 37)]
)
def test_head_kernel_matches_plain(dev, batch, seq_len, window_len, step):
    """Small C and Z at the kernel's one width, O = dim_cnn = 32."""
    cfg = FASTConfig(
        electrodes=ELECTRODES, zone_dict=ZONES, dim_cnn=32, dim_token=16,
        seq_len=seq_len, window_len=window_len, slide_step=step, num_layers=1, num_heads=4,
    )
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, 1)))
    x = torch.tensor(
        np.random.default_rng(2).normal(size=(batch, 10, seq_len)).astype(np.float32),
        device=dev,
    )
    with torch.no_grad():
        ops = [t[0] for t in model.head.fused_weights()]  # one model: no model axis
        before = fused_conv4_head.launches
        out = fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step)
        torch.cuda.synchronize()
        assert fused_conv4_head.launches == before + 1
        ref = fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


def _full_width_operands(dev, m, b, seed, **geometry):
    cfg = dataclasses.replace(FASTConfig.default(), **geometry)
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, seed, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(m, b, 64, cfg.seq_len)).astype(np.float32), device=dev)
    g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, 256)).astype(np.float32), device=dev)
    return cfg, model, ops, x, g


def _assert_grad_close(got, ref, name):
    # sums over B*N*t1 terms: rtol 1e-4, atol 1e-4 * max|ref| (chip_smoke.py)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("m,b", [(2, 8), (1, 64)])
def test_backward_kernels_match_plain(dev, m, b):
    """B2w and B2x at full width, at chip_smoke.py's shapes."""
    cfg, _, ops, x, g = _full_width_operands(dev, m, b, m + b)
    geo = (cfg.window_len, cfg.slide_step)
    before = (conv4head_bwd_w.launches, conv4head_bwd_x.launches)
    dw = conv4head_bwd_w(g, x, *ops, *geo)
    dx = conv4head_bwd_x(g, x, *ops, *geo)
    torch.cuda.synchronize()
    assert (conv4head_bwd_w.launches, conv4head_bwd_x.launches) == (before[0] + 1, before[1] + 1)
    ref = conv4head_bwd_plain(g, x, *ops, *geo)
    for name, got, r in zip(("dx", "dw12", "db12", "dw3", "dw4"), (dx, *dw), ref):
        assert got.shape == r.shape
        _assert_grad_close(got, r, name)


@pytest.mark.parametrize("m,b,geometry", [
    (1, 4, dict(seq_len=230, window_len=120, slide_step=37)),  # t1 = 116, not a multiple of 8
    (2, 5, {}),  # B = 5: the trial ranges (S = 4 on 132 SMs) are of unequal length
    (3, 8, {}),  # M = 3
])
def test_b2w_edges_match_plain(dev, m, b, geometry):
    """B2w at full width (C = 64) at its edges: padded time tiles, ragged
    trial ranges, several models."""
    cfg, _, ops, x, g = _full_width_operands(dev, m, b, 7 * m + b, **geometry)
    geo = (cfg.window_len, cfg.slide_step)
    before = conv4head_bwd_w.launches
    dw = conv4head_bwd_w(g, x, *ops, *geo)
    torch.cuda.synchronize()
    assert conv4head_bwd_w.launches == before + 1
    ref = conv4head_bwd_plain(g, x, *ops, *geo)[1:]
    for name, got, r in zip(("dw12", "db12", "dw3", "dw4"), dw, ref):
        assert got.shape == r.shape
        _assert_grad_close(got, r, name)


@pytest.mark.parametrize("m,b,geometry", [
    (1, 4, dict(seq_len=230, window_len=120, slide_step=37)),  # t1 = 116, not a multiple of 8
    (3, 5, {}),  # M = 3, B = 5: the trial ranges (S = 3 on 132 SMs) are of unequal length
    (1, 1, {}),  # serving's smallest request: one trial, 40 blocks
])
def test_b2f_edges_match_plain(dev, m, b, geometry):
    """B2f at full width (C = 64) at its edges."""
    cfg, _, ops, x, _ = _full_width_operands(dev, m, b, 11 * m + b, **geometry)
    geo = (cfg.window_len, cfg.slide_step)
    before = fused_conv4_head.launches
    out = fused_conv4_head(x, *ops, *geo)
    torch.cuda.synchronize()
    assert fused_conv4_head.launches == before + 1
    torch.testing.assert_close(out, fused_conv4_head_plain(x, *ops, *geo), rtol=1e-4, atol=1e-5)


def test_head_kernel_is_deterministic(dev):
    cfg, _, ops, x, _ = _full_width_operands(dev, 2, 8, 0)
    geo = (cfg.window_len, cfg.slide_step)
    assert torch.equal(fused_conv4_head(x, *ops, *geo), fused_conv4_head(x, *ops, *geo))


@pytest.mark.parametrize("m,b,geometry", [
    (1, 4, dict(seq_len=230, window_len=120, slide_step=37)),  # t1 = 116, not a multiple of 8
    (1, 1, {}),  # one trial: 5 windows, the zones split over blocks
    (1, 100, {}),  # global_explain's 100 trials
    (3, 5, {}),  # M = 3
])
def test_b2x_edges_match_plain(dev, m, b, geometry):
    """B2x at full width (C = 64) at its edges, against the plain dx alone."""
    cfg, _, ops, x, g = _full_width_operands(dev, m, b, 13 * m + b, **geometry)
    geo = (cfg.window_len, cfg.slide_step)
    before = conv4head_bwd_x.launches
    dx = conv4head_bwd_x(g, x, *ops, *geo)
    torch.cuda.synchronize()
    assert conv4head_bwd_x.launches == before + 1
    ref = conv4head_bwd_x_plain(g, x, *ops, *geo)
    assert dx.shape == ref.shape
    _assert_grad_close(dx, ref, "dx")


@pytest.mark.parametrize("sz", [1, 2, 3, 8])
def test_b2x_splits_match_plain(dev, sz):
    """Every split of the zones into SZ ranges (partials summed by a second
    pass when SZ > 1) gives the plain dx; the wrapper picks one."""
    cfg, _, ops, x, g = _full_width_operands(dev, 2, 5, 17)
    geo = (cfg.window_len, cfg.slide_step)
    dx = _launch_bwd_x(g, x, *ops, *geo, sz)
    _assert_grad_close(dx, conv4head_bwd_x_plain(g, x, *ops, *geo), "dx")


def test_b2x_small_channels_match_plain(dev):
    """C = 10 channels (not a multiple of 8) and 4 zones, at O = 32."""
    cfg = FASTConfig(electrodes=ELECTRODES, zone_dict=ZONES, dim_cnn=32, dim_token=16,
                     num_layers=1, num_heads=4)
    model = FAST(cfg, n_models=2, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, 5, 2)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(2, 3, 10, 800)).astype(np.float32), device=dev)
    g = torch.tensor(rng.normal(size=(2, 3, cfg.n_tokens, 4 * 32)).astype(np.float32),
                     device=dev)
    geo = (cfg.window_len, cfg.slide_step)
    _assert_grad_close(conv4head_bwd_x(g, x, *ops, *geo),
                       conv4head_bwd_x_plain(g, x, *ops, *geo), "dx")


def test_backward_kernel_is_deterministic(dev):
    cfg, _, ops, x, g = _full_width_operands(dev, 2, 8, 0)
    geo = (cfg.window_len, cfg.slide_step)
    for a, b in zip(conv4head_bwd_w(g, x, *ops, *geo), conv4head_bwd_w(g, x, *ops, *geo)):
        assert torch.equal(a, b)
    assert torch.equal(conv4head_bwd_x(g, x, *ops, *geo), conv4head_bwd_x(g, x, *ops, *geo))
    assert torch.equal(_launch_bwd_x(g, x, *ops, *geo, 8), _launch_bwd_x(g, x, *ops, *geo, 8))


def test_autograd_function_through_the_model(dev):
    """``loss.backward()`` of a stacked FAST on the card launches B2f and
    B2w (not B2x: the input needs no gradient) and matches the CPU model."""
    cfg, model, _, x, _ = _full_width_operands(dev, 2, 8, 3)
    cpu = FAST(cfg, n_models=2)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    before = (fused_conv4_head.launches, conv4head_bwd_w.launches, conv4head_bwd_x.launches)
    for mdl in (model, cpu):
        mdl.eval()
        mdl(x.to(next(mdl.parameters()).device)).square().sum().backward()
    torch.cuda.synchronize()
    assert (fused_conv4_head.launches, conv4head_bwd_w.launches, conv4head_bwd_x.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        _assert_grad_close(p.grad.cpu(), q.grad, name)


def test_input_gradient_launches_b2x(dev):
    cfg, model, _, x, _ = _full_width_operands(dev, 1, 4, 4)
    model.requires_grad_(False)
    xg = x[0].clone().requires_grad_(True)
    single = FAST(cfg, device=dev)
    single.load_state_dict({k: v[0] for k, v in model.state_dict().items()})
    single.requires_grad_(False)
    before = (conv4head_bwd_w.launches, conv4head_bwd_x.launches)
    single.eval()(xg).sum().backward()
    torch.cuda.synchronize()
    assert (conv4head_bwd_w.launches, conv4head_bwd_x.launches) == (before[0], before[1] + 1)
    xc = x[0].cpu().requires_grad_(True)
    cpu = FAST(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in single.state_dict().items()})
    cpu.eval()(xc).sum().backward()
    _assert_grad_close(xg.grad.cpu(), xc.grad, "dx")


def test_attribution_for_predictions_runs_b2x(dev):
    """Expected gradients on the card launch B2x once a sample and never
    B2w, and match the CPU path on the same draws."""
    cfg = FASTConfig(electrodes=ELECTRODES, zone_dict=ZONES, dim_cnn=32, dim_token=16,
                     num_layers=1, num_heads=4)
    params = init_jax_layout_params(cfg, 8)
    models = {d: FAST(cfg, device=d) for d in (dev, torch.device("cpu"))}
    for mdl in models.values():
        mdl.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 10, 800)).astype(np.float32)
    bg = rng.normal(size=(12, 10, 800)).astype(np.float32)
    before = (conv4head_bwd_w.launches, conv4head_bwd_x.launches)
    attr, preds = attribution_for_predictions(
        models[dev], torch.tensor(x, device=dev), torch.tensor(bg, device=dev),
        torch.Generator().manual_seed(0), n_samples=4)
    torch.cuda.synchronize()
    assert (conv4head_bwd_w.launches, conv4head_bwd_x.launches) == (before[0], before[1] + 4)
    ref, ref_preds = attribution_for_predictions(
        models[torch.device("cpu")], torch.from_numpy(x), torch.from_numpy(bg),
        torch.Generator().manual_seed(0), n_samples=4)
    assert torch.equal(preds.cpu(), ref_preds)
    _assert_grad_close(attr.cpu(), ref, "expected gradients")


def test_head_kernel_rejects_cpu_operands_on_cuda_input(dev):
    cfg = FASTConfig.default()
    model = FAST(cfg)
    ops = model.head.fused_weights()
    x = torch.zeros((1, 1, 64, 800), device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step)
