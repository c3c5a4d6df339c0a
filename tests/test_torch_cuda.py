"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; every test skips without a card. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import scipy.signal as sps
import torch

from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.explain.attribution import attribution_for_predictions
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda import _lib
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    FWD_BF16_PHASES,
    _launch_bwd_w,
    _launch_bwd_x,
    _launch_fwd,
    bwd_w_bf16_plan,
    bwd_w_bf16_smem_bytes,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    conv4head_bwd_x_plain,
    fused_conv4_head,
    fused_conv4_head_plain,
    fwd_bf16_plan,
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
from wgmma_emulation import fwd_selftest_cases, selftest_cases

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


# bf16 kernels (B2f-bf16, B2w-bf16) against their plain bf16 versions. Both
# round h1, h2 (and in B2w dh3, dh2, bf16(dh1)) to bf16 at the Pallas
# kernel's points; their f32 sums run in different orders, so an element
# whose sum lies near a rounding boundary rounds one bf16 ulp (2^-8
# relative) apart, and the outputs move by a fraction of that. Tolerance,
# per tensor: |err| <= REL * max|ref|, under the bf16-vs-f32 gap of the
# same outputs (3e-3 of max|ref| for the features, 1.6e-3 to 3.9e-3 for
# the weight gradients: tests/test_torch_bf16.py).
BF16_FWD_REL, BF16_BWD_REL = 3e-4, 1e-3
BF16_MODELS = (0, 37, 74)  # models of a 75-model launch held against the plain version


def _bf16_close(got, ref, rel, name):
    torch.testing.assert_close(got, ref, rtol=0, atol=rel * float(ref.abs().max()),
                               msg=lambda m: f"{name}: {m}")


def _check_bf16_kernels(ops, x, g, geo, models):
    """B2f-bf16 and B2w-bf16 once each (one launch each, no f32 head
    launch), held model by model against the plain bf16 versions."""
    before = (fused_conv4_head.launches, conv4head_bwd_w.launches,
              fused_conv4_head.launches_bf16, conv4head_bwd_w.launches_bf16)
    with torch.no_grad():
        out = fused_conv4_head(x, *ops, *geo)
    dw = conv4head_bwd_w(g, x, *ops, *geo)
    torch.cuda.synchronize()
    assert (fused_conv4_head.launches, conv4head_bwd_w.launches,
            fused_conv4_head.launches_bf16, conv4head_bwd_w.launches_bf16) == (
        before[0], before[1], before[2] + 1, before[3] + 1)
    assert out.dtype == torch.float32 and all(t.dtype == torch.float32 for t in dw)
    for i in models:
        one = [t[i : i + 1] for t in (g, x, *ops)]
        _bf16_close(out[i : i + 1], fused_conv4_head_plain(*one[1:], *geo), BF16_FWD_REL,
                    f"B2f-bf16 model {i}")
        ref = conv4head_bwd_plain(*one, *geo)[1:]
        for name, got, r in zip(("dw12", "db12", "dw3", "dw4"), dw, ref):
            assert got[i : i + 1].shape == r.shape
            _bf16_close(got[i : i + 1], r, BF16_BWD_REL, f"B2w-bf16 model {i} {name}")


@pytest.mark.parametrize("m,b", [(2, 8), (1, 64), (75, 24), (75, 35), (1, 1)])
def test_bf16_kernels_match_plain(dev, m, b):
    """At full width: chip_smoke.py's shapes, the training run's M = 75 with
    its ragged tail (24) and validation batch (35), and one trial."""
    cfg, _, ops, x, g = _full_width_operands(dev, m, b, 19 * m + b)
    models = BF16_MODELS if m == 75 else range(m)
    _check_bf16_kernels(ops, x.to(torch.bfloat16), g, (cfg.window_len, cfg.slide_step), models)


def test_bf16_kernels_edges_match_plain(dev):
    """t1 = 116 (not a multiple of 16, window steps of odd parity) with B = 5."""
    cfg, _, ops, x, g = _full_width_operands(dev, 2, 5, 23, seq_len=230, window_len=120,
                                             slide_step=37)
    _check_bf16_kernels(ops, x.to(torch.bfloat16), g, (cfg.window_len, cfg.slide_step), (0, 1))


@pytest.mark.parametrize("window_len,slide_step,seq_len", [(300, 150, 450), (470, 100, 770)])
def test_bf16_forward_long_windows_match_plain(dev, window_len, slide_step, seq_len):
    """Windows past t1 = 256 (five and eight time tiles) take B2f-bf16's
    generic instantiation in rounds of four tiles a window: one launch a
    group of windows, held against the plain bf16 forward at BF16_FWD_REL
    at full width, M = 2, B = 5; reruns bit-identical."""
    cfg, _, ops, x, _ = _full_width_operands(dev, 2, 5, window_len, seq_len=seq_len,
                                             window_len=window_len, slide_step=slide_step)
    xb, geo = x.to(torch.bfloat16), (window_len, slide_step)
    with torch.no_grad():
        before = fused_conv4_head.launches_bf16
        got = fused_conv4_head(xb, *ops, *geo)
        assert fused_conv4_head.launches_bf16 > before
        assert torch.equal(fused_conv4_head(xb, *ops, *geo), got)
    ref = fused_conv4_head_plain(xb.cpu(), *(t.cpu() for t in ops), *geo)
    _bf16_close(got.cpu(), ref, BF16_FWD_REL, f"out W={window_len}")


def test_bf16_kernels_take_odd_channel_counts(dev):
    """C = 10 (not a multiple of 8 or 16) with 4 zones: B2f-bf16 and
    B2w-bf16 take it (zero-padded channels); f32 B2w refuses it, so its
    wrapper launches it on x and w12 zero-padded to 16 channels, and the
    weight gradients match the plain backward (rtol 1e-4)."""
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
    _check_bf16_kernels(ops, x.to(torch.bfloat16), g, geo, (0, 1))
    before = (conv4head_bwd_w.launches, conv4head_bwd_w.adapted)
    dw = conv4head_bwd_w(g, x, *ops, *geo)  # f32 B2w at C = 10: on 16 zero-padded channels
    assert (conv4head_bwd_w.launches, conv4head_bwd_w.adapted) == (before[0] + 1, before[1] + 1)
    for name, got, r in zip(("dw12", "db12", "dw3", "dw4"), dw, conv4head_bwd_plain(g, x, *ops,
                                                                                    *geo)[1:]):
        _assert_grad_close(got, r, name)


def test_bf16_input_gradient_raises(dev):
    """B2x has no bf16 instantiation: a bf16 dx on the card raises, never
    upcasts."""
    cfg, _, ops, x, g = _full_width_operands(dev, 1, 2, 29)
    geo = (cfg.window_len, cfg.slide_step)
    xb = x.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv4head_bwd_x(g, xb, *ops, *geo)
    xg = xb.clone().requires_grad_(True)
    out = fused_conv4_head(xg, *(t.detach() for t in ops), *geo)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()


def test_bf16_kernels_are_deterministic_and_leave_f32_alone(dev):
    """Reruns are bit-identical, and an f32 launch gives the same bits with
    or without bf16 launches between (separate kernels, separate counts)."""
    cfg, _, ops, x, g = _full_width_operands(dev, 2, 8, 31)
    geo = (cfg.window_len, cfg.slide_step)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        f32_out = fused_conv4_head(x, *ops, *geo)
        assert torch.equal(fused_conv4_head(xb, *ops, *geo), fused_conv4_head(xb, *ops, *geo))
        assert torch.equal(fused_conv4_head(x, *ops, *geo), f32_out)
    f32_dw = conv4head_bwd_w(g, x, *ops, *geo)
    for a, b in zip(conv4head_bwd_w(g, xb, *ops, *geo), conv4head_bwd_w(g, xb, *ops, *geo)):
        assert torch.equal(a, b)
    for a, b in zip(conv4head_bwd_w(g, x, *ops, *geo), f32_dw):
        assert torch.equal(a, b)


def test_bf16_training_step_matches_cpu(dev):
    """One bf16 training step of a stacked full-width FAST: the card (B2f-bf16,
    B2w-bf16, cuBLAS bf16 trunk with f32 reductions) against the CPU (plain
    bf16 head, the same trunk), from the same weights and batch. The loss
    within 1e-3 relative; the gradients, all parameters together, within
    3e-3 in relative L2 (bf16 roundings that flip one ulp apart on the two
    devices, as in the head), under the bf16-vs-f32 gap of the same step
    (9.1e-3 on the CPU), which is asserted to exceed it."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, model, _, x, _ = _full_width_operands(dev, 2, 8, 37)
    cfg = dataclasses.replace(cfg, dropout=0.0)
    y = torch.tensor(np.random.default_rng(37).integers(0, 5, (2, 8)), device=dev)
    runs = {}
    for name, d, dtype in (("card", dev, torch.bfloat16), ("cpu", torch.device("cpu"),
                                                            torch.bfloat16),
                           ("cpu f32", torch.device("cpu"), torch.float32)):
        mdl = FAST(cfg, n_models=2, device=d)
        mdl.load_state_dict({k: v.to(d) for k, v in model.state_dict().items()})
        before = (fused_conv4_head.launches_bf16, conv4head_bwd_w.launches_bf16,
                  fused_conv4_head.launches, conv4head_bwd_w.launches, conv4head_bwd_x.launches)
        logits = mdl.train()(x.to(d, dtype))
        loss = torch.nn.functional.cross_entropy(logits.float().flatten(0, 1), y.to(d).flatten())
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert (fused_conv4_head.launches_bf16, conv4head_bwd_w.launches_bf16,
                    fused_conv4_head.launches, conv4head_bwd_w.launches,
                    conv4head_bwd_x.launches) == (before[0] + 1, before[1] + 1, *before[2:])
        grads = torch.cat([p.grad.detach().cpu().flatten() for p in mdl.parameters()])
        runs[name] = (float(loss.detach()), grads)
    (l_card, g_card), (l_cpu, g_cpu), (_, g_f32) = runs["card"], runs["cpu"], runs["cpu f32"]
    assert abs(l_card - l_cpu) <= 1e-3 * abs(l_cpu)
    err = float((g_card - g_cpu).norm() / g_cpu.norm())
    gap = float((g_f32 - g_cpu).norm() / g_cpu.norm())
    assert err <= 3e-3 < gap, (err, gap)


def test_bf16_weight_grads_hold_over_a_long_trial_loop(dev):
    """M = 1, B = 256 with one trial range (S = 1): each block runs 256
    trials, its weight gradients held in registers across all of them."""
    cfg, _, ops, x, g = _full_width_operands(dev, 1, 256, 41)
    xb, geo = x.to(torch.bfloat16), (cfg.window_len, cfg.slide_step)
    before = conv4head_bwd_w.launches_bf16
    dw = _launch_bwd_w(g, xb, *ops, *geo, s=1)
    torch.cuda.synchronize()
    assert conv4head_bwd_w.launches_bf16 == before + 1
    ref = conv4head_bwd_plain(g, xb, *ops, *geo)[1:]
    for name, got, r in zip(("dw12", "db12", "dw3", "dw4"), dw, ref):
        _bf16_close(got, r, BF16_BWD_REL, f"B2w-bf16 S=1 B=256 {name}")


def test_bf16_weight_grads_are_deterministic_over_20_runs(dev):
    """Twenty launches give the same bits: no atomics, and every shared-memory
    write that a wgmma reads is fenced (a missing fence shows as a rare
    mismatch)."""
    cfg, _, ops, x, g = _full_width_operands(dev, 2, 8, 43)
    xb, geo = x.to(torch.bfloat16), (cfg.window_len, cfg.slide_step)
    first = conv4head_bwd_w(g, xb, *ops, *geo)
    for _ in range(19):
        for a, b in zip(conv4head_bwd_w(g, xb, *ops, *geo), first):
            assert torch.equal(a, b)


@pytest.mark.parametrize("c,w", [(64, 250), (10, 250), (64, 120), (72, 250), (130, 60)])
def test_bwd_w_bf16_plan_mirror_matches_kernel(dev, c, w):
    """The Python mirror of B2w-bf16's shared-memory plan gives the kernel's
    total, and -1 where it is not built for C (72, 130: more weight-gradient
    tiles than its registers hold)."""
    assert bwd_w_bf16_smem_bytes(c, w) == _lib.library().isd_conv4head_bwd_w_bf16_smem_bytes(
        c, w, 32, 5)
    assert bwd_w_bf16_smem_bytes(c, w) in (-1, bwd_w_bf16_plan(c, w)["total"])


def _wgmma_selftest(dev, img, steps, a_mn_major, b_mn_major, swap=(False, False)):
    """One wgmma tile on the card from the image (csrc/wgmma_selftest.cu);
    ``swap`` exchanges an operand's two core-matrix steps (the other
    reading of the descriptor's leading and stride offsets)."""
    bits = img[0].to(torch.bfloat16).view(torch.int16).to(dev)
    n = len(steps)
    a_starts = (ctypes.c_int * n)(*(a[0] for a, _ in steps))
    b_starts = (ctypes.c_int * n)(*(b[0] for _, b in steps))
    (_, a_k, a_mn), (_, b_k, b_mn) = steps[0]
    if swap[0]:
        a_k, a_mn = a_mn, a_k
    if swap[1]:
        b_k, b_mn = b_mn, b_k
    d = torch.empty((64, 32), dtype=torch.float32, device=dev)
    code = _lib.library().isd_wgmma_selftest(
        bits.data_ptr(), 2 * bits.numel(), ctypes.cast(a_starts, ctypes.c_void_p),
        ctypes.cast(b_starts, ctypes.c_void_p), n, a_k, a_mn, b_k, b_mn, int(a_mn_major),
        int(b_mn_major), d.data_ptr(), _lib.stream_of(d))
    _lib.check(code, "isd_wgmma_selftest")
    torch.cuda.synchronize()
    return d.double().cpu()


@pytest.mark.parametrize("case", range(5))
def test_wgmma_descriptor_forms_match_plain(dev, case):
    """Each descriptor form that B2w-bf16 issues (tests/wgmma_emulation.py),
    one tile on the card through the Python mirror's starts and steps,
    against the plain product of the same bf16 values (f32 sums of exact
    products: 1e-5 of max|ref|). On a mismatch the message gives the error
    of each other reading of the two offsets, to tell a wrong convention
    from a wrong address."""
    img, cases = selftest_cases(bwd_w_bf16_plan(64, 250))
    name, steps, a_mn_major, b_mn_major, expected = cases[case]
    tol = 1e-5 * float(expected.abs().max())
    got = _wgmma_selftest(dev, img, steps, a_mn_major, b_mn_major)
    err = float((got - expected).abs().max())
    if err > tol:
        others = {swap: float((_wgmma_selftest(dev, img, steps, a_mn_major, b_mn_major, swap)
                               - expected).abs().max())
                  for swap in ((True, False), (False, True), (True, True))}
        raise AssertionError(f"{name}: max|err| {err:.3g} > {tol:.3g}; with swapped offsets "
                             f"(A, B): {others}")


def test_bf16_forward_edges_match_plain(dev):
    """B2f-bf16 where a column lies in up to four windows and h1 takes two
    sub-blocks (windows of 120 at step 37, T = 400: N = 8), and where the
    persistent blocks' runs cross (model, zone) boundaries (M = 3, B = 64:
    1,536 items on the SMs), against the plain bf16 forward."""
    for m, b, geometry in ((1, 3, dict(seq_len=400, window_len=120, slide_step=37)), (3, 64, {})):
        cfg, _, ops, x, _ = _full_width_operands(dev, m, b, 47 + m, **geometry)
        geo = (cfg.window_len, cfg.slide_step)
        xb = x.to(torch.bfloat16)
        before = fused_conv4_head.launches_bf16
        with torch.no_grad():
            out = fused_conv4_head(xb, *ops, *geo)
        torch.cuda.synchronize()
        assert fused_conv4_head.launches_bf16 == before + 1
        _bf16_close(out, fused_conv4_head_plain(xb, *ops, *geo), BF16_FWD_REL, f"M={m} B={b}")


def test_bf16_forward_is_deterministic_over_20_runs(dev):
    """Twenty B2f-bf16 launches give the same bits, and its debug
    instantiation (phase counters) the same bits again, with every
    counter moved."""
    cfg, _, ops, x, _ = _full_width_operands(dev, 2, 8, 53)
    xb, geo = x.to(torch.bfloat16), (cfg.window_len, cfg.slide_step)
    with torch.no_grad():
        first = fused_conv4_head(xb, *ops, *geo)
        for _ in range(19):
            assert torch.equal(fused_conv4_head(xb, *ops, *geo), first)
        clk = torch.zeros(len(FWD_BF16_PHASES) + 2, dtype=torch.int64, device=dev)
        before = fused_conv4_head.launches_bf16
        assert torch.equal(_launch_fwd(xb, *ops, *geo, clk=clk), first)
    assert fused_conv4_head.launches_bf16 == before
    assert all(v > 0 for v in clk.tolist())


@pytest.mark.parametrize("c,w,step,n", [(64, 250, 125, 5), (10, 250, 125, 5), (64, 120, 37, 8),
                                        (72, 250, 125, 3), (64, 300, 150, 1)])
def test_fwd_bf16_plan_mirror_matches_kernel(dev, c, w, step, n):
    """The Python mirror of B2f-bf16's shared-memory plan gives the
    kernel's total (windows of 300: five time tiles)."""
    assert fwd_bf16_plan(c, w, step, n)["total"] == (
        _lib.library().isd_conv4head_fwd_bf16_smem_bytes(c, w, step, n, 32, 5))


@pytest.mark.parametrize("case", range(3))
def test_fwd_bf16_descriptor_forms_match_plain(dev, case):
    """B2f-bf16's conv tiles (the x sub-block by w12, the last window's
    stacked h1 rows by w3, h2's second buffer by w4), one tile each on the
    card through the Python mirror's descriptors, against the plain
    product of the same bf16 values (1e-5 of max|ref|)."""
    img, cases = fwd_selftest_cases(fwd_bf16_plan(64, 250, 125, 5))
    name, steps, a_mn_major, b_mn_major, expected = cases[case]
    got = _wgmma_selftest(dev, img, steps, a_mn_major, b_mn_major)
    assert float((got - expected).abs().max()) <= 1e-5 * float(expected.abs().max()), name


def _head_operands(m, b, c, t, z, o, seed, k=5):
    """``(x f32, w12, b12, w3, w4)`` on the CPU, from numpy."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return torch.tensor((scale * rng.normal(size=shape)).astype(np.float32))

    return (normal((m, b, c, t), 1.0), normal((m, z * o, k * c), (k * c) ** -0.5),
            normal((m, z * o, 1), 0.1), normal((m, z, o, k * o), (k * o) ** -0.5),
            normal((m, z, o, k * o), (k * o) ** -0.5))


def _route_counts():
    return (fused_conv4_head.launches, fused_conv4_head.launches_bf16, fused_conv4_head.adapted,
            conv4head_bwd_w.launches, conv4head_bwd_w.launches_bf16, conv4head_bwd_w.adapted)


@pytest.mark.parametrize("o,c,t,w,step,dtype,routes", [
    (8, 10, 200, 100, 50, torch.float32, (1, 0, 1, 1, 0, 1)),  # dim_cnn 8 (cli/zero_shot.py)
    (16, 10, 200, 100, 50, torch.float32, (1, 0, 1, 1, 0, 1)),  # dim_cnn 16
    (8, 10, 200, 100, 50, torch.bfloat16, (0, 1, 1, 0, 1, 1)),
    (16, 10, 200, 100, 50, torch.bfloat16, (0, 1, 1, 0, 1, 1)),
    (32, 60, 200, 100, 50, torch.float32, (1, 0, 0, 1, 0, 1)),  # B2w on 64 padded channels
    (32, 10, 202, 100, 50, torch.bfloat16, (0, 1, 0, 0, 1, 0)),  # T even: as they are
    (32, 10, 201, 100, 50, torch.bfloat16, (0, 1, 1, 0, 1, 1)),  # an odd T: an even copy
    (32, 64, 1001, 250, 125, torch.bfloat16, (0, 2, 1, 0, 1, 1)),  # N = 7: two B2f-bf16 groups
    (32, 72, 800, 250, 125, torch.bfloat16, (0, 2, 1, 0, 0, 0)),  # C = 72: B2w-bf16 raises
])
def test_adapted_geometries_train_on_the_card(dev, o, c, t, w, step, dtype, routes):
    """Head geometries the kernels are not built for launch them on
    zero-padded or split operands: the features and the weight gradients
    of <g, head> match the CPU (f32: rtol 1e-4, atol 1e-5 / 1e-4 x
    max|ref|; bf16: 3e-4 and 1e-3 x max|ref|), and the launch and
    ``adapted`` counters say what ran. At C = 72 in bf16 the forward runs
    and B2w-bf16 (C <= 64) raises."""
    x, *weights = _head_operands(2, 3, c, t, 2, o, o + c + t)
    n = (t - w) // step + 1
    g = torch.tensor(np.random.default_rng(t).normal(size=(2, 3, n, 2 * o)).astype(np.float32))
    trains = not (dtype == torch.bfloat16 and c > 64)
    results = {}
    for device in (dev, torch.device("cpu")):
        wd = [p.to(device).requires_grad_(True) for p in weights]
        before = _route_counts()
        out = fused_conv4_head(x.to(device, dtype), *wd, w, step)
        if trains or device.type == "cpu":
            (out * g.to(device)).sum().backward()
        else:
            with pytest.raises(ValueError, match="B2w-bf16 is not built"):
                (out * g.to(device)).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(_route_counts(), before)) == routes
        results[device.type] = [out.detach().cpu()] + [p.grad.cpu() for p in wd if trains]
    names = ("out", "dw12", "db12", "dw3", "dw4")
    for name, got, ref in zip(names, results["cuda"], results["cpu"]):
        if dtype == torch.bfloat16:
            _bf16_close(got, ref, BF16_FWD_REL if name == "out" else BF16_BWD_REL, name)
        elif name == "out":
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
        else:
            _assert_grad_close(got, ref, name)


@pytest.mark.parametrize("o", [8, 16])
def test_adapted_input_gradient_on_the_card(dev, o):
    """B2x at dim_cnn 8 and 16 (zones zero-padded to 32 channels): dx
    matches B2x's plain version on the CPU at the B2x tolerance, one launch,
    one adapted call."""
    x, *weights = _head_operands(2, 3, 10, 200, 2, o, 41 + o)
    g = torch.tensor(np.random.default_rng(o).normal(size=(2, 3, 3, 2 * o)).astype(np.float32))
    before = (conv4head_bwd_x.launches, conv4head_bwd_x.adapted)
    got = conv4head_bwd_x(g.to(dev), x.to(dev), *(p.to(dev) for p in weights), 100, 50)
    torch.cuda.synchronize()
    assert (conv4head_bwd_x.launches, conv4head_bwd_x.adapted) == (before[0] + 1, before[1] + 1)
    _assert_grad_close(got.cpu(), conv4head_bwd_x_plain(g, x, *weights, 100, 50), "dx")


def test_cli_trains_dim_cnn_8_on_the_card(dev, tmp_path):
    """tests/test_torch_bf16.py's CLI command (a config with dim_cnn: 8,
    bf16 by default) on the card, the CLI's default device: it trains
    through B2f-bf16 and B2w-bf16 on zones zero-padded to 32 channels
    (every head call adapted), no f32 head kernel, and its history is
    finite."""
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n"
                        "  num_heads: 4\n")
    before = _route_counts()
    res = train_fast.main(["--config", str(cfg_path), "--synthetic", "1", "--synthetic_trials",
                           "10", "--epochs", "2", "--batch_size", "8", "--output_dir",
                           str(tmp_path / "out")])
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_route_counts(), before))
    assert moved[0] == moved[3] == 0 and moved[1] > 0 and moved[4] > 0, moved
    assert moved[2] == moved[1] and moved[5] == moved[4], moved
    assert all(np.isfinite(v).all() for v in res.fit.history.values())
