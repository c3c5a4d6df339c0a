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
from imagined_speech_decoding_tpu_torch.ops.cuda import _lib, conv4head
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
from imagined_speech_decoding_tpu_torch.serving import (
    GRAPH_BATCHES,
    GraphedChain,
    export_decoder_artifact,
    load_decoder_artifact,
    make_fleet_decoder,
    make_online_decoder,
)
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


SERVE_CFG = FASTConfig(electrodes=ELECTRODES, zone_dict=ZONES, dim_cnn=32, dim_token=16,
                       num_layers=1, num_heads=4)


def test_decode_makes_one_filter_launch(dev):
    """A decode runs its notch and band-pass as one chain launch and never
    the causal entry: the first decode of a shape eagerly (one counted
    launch), its capture records one (counted as a capture, not a launch),
    and each later decode replays the graph that holds it."""
    params = init_jax_layout_params(SERVE_CFG, 2)
    x = np.random.default_rng(4).normal(size=(2, 10, 800)).astype(np.float32)
    decode = make_online_decoder(FAST(SERVE_CFG, device=dev), params)
    before = (sosfiltfilt_chain.launches, sosfiltfilt_chain.captures,
              sosfilt_time_major.launches)
    for _ in range(3):
        post = decode(x)
    assert (decode.eager, len(decode.graphs), decode.replays) == (1, 1, 2)
    assert (sosfiltfilt_chain.launches, sosfiltfilt_chain.captures,
            sosfilt_time_major.launches) == (before[0] + 1, before[1] + 1, before[2])
    ref = make_online_decoder(FAST(SERVE_CFG), params)(x)
    np.testing.assert_allclose(post, ref, rtol=1e-4, atol=1e-5)


def _eager(decode, x, served=None):
    """The un-captured chain on ``x``, zero-padded to ``served`` trials and
    cropped back, as a graph of that batch computes it."""
    xt = torch.zeros((served or len(x), *x.shape[1:]), device=decode.device)
    xt[:len(x)] = torch.tensor(x)
    with torch.inference_mode():
        return decode.fn(xt).narrow(decode.batch_axis, 0, len(x)).cpu().numpy()


@pytest.mark.parametrize("fleet", [False, True], ids=["live", "fleet"])
def test_graph_replay_equals_eager_with_a_graph_per_batch(dev, fleet):
    """One CUDA graph per captured batch size (B = 3 runs in the graph of
    4); each replay equals the un-captured chain on the same padded batch
    bit for bit (B1 and B2f are deterministic) and the chain on the
    request alone to f32 rounding; its launches run in the replay, not
    through the wrappers' counts."""
    if fleet:
        decode = make_fleet_decoder(FAST(SERVE_CFG, n_models=3, device=dev),
                                    init_jax_layout_params(SERVE_CFG, 2, 3))
    else:
        decode = make_online_decoder(FAST(SERVE_CFG, device=dev),
                                     init_jax_layout_params(SERVE_CFG, 2))
    rng = np.random.default_rng(5)
    for b, served in ((1, 1), (3, 4), (8, 8)):
        x = rng.normal(size=(b, 10, 800)).astype(np.float32)
        first = decode(x)
        before = (sosfiltfilt_chain.launches, fused_conv4_head.launches)
        replays = [decode(x) for _ in range(3)]
        assert (sosfiltfilt_chain.launches, fused_conv4_head.launches) == before
        for post in replays:
            np.testing.assert_array_equal(post, first)
            np.testing.assert_array_equal(post, _eager(decode, x, served))
            np.testing.assert_allclose(post, _eager(decode, x), rtol=1e-5, atol=1e-6)
    assert sorted(decode.graphs) == [(b, 10, 800) for b in (1, 4, 8)]
    assert (decode.eager, decode.replays) == (3, 9)


def test_graphs_and_memory_stay_bounded_over_batch_sizes(dev):
    """Every batch size from 1 to 70, then larger ones, against the fleet
    (its rows and ensemble share one pool): at most one graph per entry of
    GRAPH_BATCHES each, requests above the largest run in slices of it,
    and once every graph is captured no request reserves more memory."""
    decode = make_fleet_decoder(FAST(SERVE_CFG, n_models=3, device=dev),
                                init_jax_layout_params(SERVE_CFG, 2, 3))
    x = np.random.default_rng(9).normal(size=(300, 10, 800)).astype(np.float32)
    for b in range(1, 71):
        assert decode(x[:b]).shape == (3, b, 5) and decode.ensemble(x[:b]).shape == (b, 5)
    assert sorted(decode.graphs) == sorted(decode.ensemble.graphs) == \
        [(n, 10, 800) for n in GRAPH_BATCHES]
    assert decode.ensemble.pool == decode.pool
    reserved = torch.cuda.memory_reserved(dev)
    replays = decode.replays
    for b in (71, 100, 129, 150, 300, 5, 17):
        rows = decode(x[:b])
        np.testing.assert_allclose(decode.ensemble(x[:b]), rows.mean(axis=0), rtol=1e-6,
                                   atol=1e-7)
    assert torch.cuda.memory_reserved(dev) == reserved
    assert decode.replays - replays == sum(-(-b // GRAPH_BATCHES[-1])
                                           for b in (71, 100, 129, 150, 300, 5, 17))
    assert len(decode.graphs) == len(GRAPH_BATCHES) and decode.eager == len(GRAPH_BATCHES)
    np.testing.assert_allclose(rows, _eager(decode, x[:17]), rtol=1e-5, atol=1e-6)


def test_swap_weights_is_seen_by_the_replay(dev):
    p1, p2 = init_jax_layout_params(SERVE_CFG, 2), init_jax_layout_params(SERVE_CFG, 3)
    x = np.random.default_rng(6).normal(size=(2, 10, 800)).astype(np.float32)
    decode = make_online_decoder(FAST(SERVE_CFG, device=dev), p1)
    decode(x)
    before = decode(x)
    decode.swap_weights(p2)
    after = decode(x)
    assert decode.replays == 2 and not np.allclose(before, after)
    np.testing.assert_array_equal(after, make_online_decoder(FAST(SERVE_CFG, device=dev), p2)(x))


def test_artifact_runs_the_kernels_on_the_card(dev, tmp_path):
    """The exported chain, loaded onto the card, launches B1 and B2f through
    its operators, and agrees with the artifact on the CPU (plain versions)."""
    params = init_jax_layout_params(SERVE_CFG, 2)
    path = export_decoder_artifact(str(tmp_path / "d.pt2"), FAST(SERVE_CFG), params,
                                   n_channels=10, seq_len=800)
    x = np.random.default_rng(7).normal(size=(3, 10, 800)).astype(np.float32)
    before = (sosfiltfilt_chain.launches, fused_conv4_head.launches)
    post = load_decoder_artifact(path)(x)
    assert (sosfiltfilt_chain.launches, fused_conv4_head.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    np.testing.assert_allclose(post, load_decoder_artifact(path, device="cpu")(x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(post, make_online_decoder(FAST(SERVE_CFG, device=dev),
                                                            params)(x))


def test_fleet_of_15_matches_the_plain_cpu_fleet(dev):
    """The full-width fleet (M = 15, one B2f launch) against the plain CPU fleet."""
    cfg = FASTConfig.default()
    params = init_jax_layout_params(cfg, 8, 15)
    x = np.random.default_rng(8).normal(size=(2, 64, 800)).astype(np.float32)
    card = make_fleet_decoder(FAST(cfg, n_models=15, device=dev), params)
    before = (fused_conv4_head.launches, fused_conv4_head.captures)
    rows = card(x)  # the eager decode's launch, then the capture's
    assert (fused_conv4_head.launches, fused_conv4_head.captures) == (before[0] + 1,
                                                                       before[1] + 1)
    assert rows.shape == (15, 2, 5)
    cpu = make_fleet_decoder(FAST(cfg, n_models=15), params)
    np.testing.assert_allclose(rows, cpu(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card.ensemble(x), rows.mean(axis=0), rtol=1e-6, atol=1e-7)


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
F32_ROUTE_REL_L2 = 1e-2  # tests/test_torch_conv4head_route.py: the f32 route skips bf16 roundings
# A bf16 dx against the plain bf16 backward's, relative L2, at every O: chip_smoke.py's
# GEN_BF16_DX_L2 says where it sits among the readings.
BF16_DX_L2 = 2e-3
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


def test_bf16_input_gradient_runs_b2x_g(dev):
    """A bf16 x's input gradient on the card runs B2x-g bf16 (one launch
    of ``launches_general_bf16``, no tuned B2x), through
    ``fused_conv4_head(...).backward()`` as through ``conv4head_bwd_x``:
    dx in bf16 within BF16_DX_L2 in relative L2 of the plain bf16 backward's."""
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import conv4head_bwd_bf16_plain

    cfg, _, ops, x, g = _full_width_operands(dev, 1, 2, 29)
    geo = (cfg.window_len, cfg.slide_step)
    xb = x.to(torch.bfloat16)
    ref = conv4head_bwd_bf16_plain(g, xb, *ops, *geo)[0]
    before = (conv4head_bwd_x.launches, conv4head_bwd_x.launches_general_bf16)
    direct = conv4head_bwd_x(g, xb, *ops, *geo)
    xg = xb.clone().requires_grad_(True)
    out = fused_conv4_head(xg, *(t.detach() for t in ops), *geo)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (conv4head_bwd_x.launches, conv4head_bwd_x.launches_general_bf16) == (
        before[0], before[1] + 2)
    for got in (direct, xg.grad):
        assert got.dtype == torch.bfloat16 and got.shape == xb.shape
        assert float((got.float() - ref.float()).norm() / ref.float().norm()) <= BF16_DX_L2
    assert torch.equal(direct, xg.grad)


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


@pytest.mark.parametrize("c,w", [(64, 250), (10, 250), (64, 120), (72, 250), (130, 60),
                                 (64, 261), (64, 500), (1, 800), (33, 292)])
def test_bwd_w_bf16_plan_mirror_matches_kernel(dev, c, w):
    """The Python mirror of B2w-bf16's shared-memory plan gives the kernel's
    total (column tiles past windows of 260), and -1 where it is not built
    for C (72, 130: more weight-gradient tiles than its registers hold)."""
    assert bwd_w_bf16_smem_bytes(c, w) == _lib.library().isd_conv4head_bwd_w_bf16_smem_bytes(
        c, w, 32, 5)
    assert bwd_w_bf16_smem_bytes(c, w) in (-1, bwd_w_bf16_plan(c, w)["total"])


# Windows past 260 samples: B2w-bf16 in column tiles (W, step), T = 800.
COLUMN_TILE_WINDOWS = ((261, 130), (280, 130), (292, 127), (500, 150), (800, 1))


@pytest.mark.parametrize("o", [8, 16, 32])
@pytest.mark.parametrize("c", [1, 10, 33, 64])
@pytest.mark.parametrize("w,step", COLUMN_TILE_WINDOWS)
def test_bf16_column_tiles_match_plain(dev, w, step, c, o):
    """bf16 weight gradients at windows of 261 to 800 samples (two to four
    column tiles, the last short at 261-292), C = 1 to 64, O = 8 and 16
    (widened to 32) and 32, M = 2, B = 4, 2 zones: one B2w-bf16 launch, no
    general or f32 one, held against the plain bf16 backward at BF16_BWD_REL
    x max|ref| per tensor; a second launch bit-identical."""
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import conv4head_bwd_bf16_plain

    x, *ops = _head_operands(2, 4, c, 800, 2, o, w + c + o)
    n = (800 - w) // step + 1
    g = torch.tensor(np.random.default_rng(w + o).normal(size=(2, 4, n, 2 * o))
                     .astype(np.float32))
    xb = x.to(torch.bfloat16)
    before = (conv4head_bwd_w.launches_bf16, conv4head_bwd_w.launches,
              conv4head_bwd_w.launches_general_bf16, conv4head_bwd_w.adapted)
    cuda_ops = [t.to(dev) for t in (g, xb, *ops)]
    got = conv4head_bwd_w(*cuda_ops, w, step)
    again = conv4head_bwd_w(*cuda_ops, w, step)
    torch.cuda.synchronize()
    assert (conv4head_bwd_w.launches_bf16, conv4head_bwd_w.launches,
            conv4head_bwd_w.launches_general_bf16, conv4head_bwd_w.adapted) == (
        before[0] + 2, before[1], before[2], before[3] + 2 * (o < 32))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = conv4head_bwd_bf16_plain(g, xb, *ops, w, step)[1:]
    for name, a, r in zip(("dw12", "db12", "dw3", "dw4"), got, ref):
        _bf16_close(a.cpu(), r, BF16_BWD_REL, f"B2w-bf16 W={w} C={c} O={o} {name}")


def test_bf16_column_tiles_at_the_step_shape(dev):
    """B2w-bf16 at section 14 (a)'s step shape (75 models, batch 64, full
    width, 3 windows of 500 in two column tiles): models 0, 37 and 74
    against the plain bf16 backward at BF16_BWD_REL, and a second launch
    bit-identical."""
    cfg, _, ops, x, _ = _full_width_operands(dev, 75, 64, 61)
    w, step = 500, 150
    g = torch.randn((75, 64, 3, 256), generator=torch.Generator(device=dev).manual_seed(61),
                    device=dev)
    xb = x.to(torch.bfloat16)
    before = conv4head_bwd_w.launches_bf16
    got = conv4head_bwd_w(g, xb, *ops, w, step)
    again = conv4head_bwd_w(g, xb, *ops, w, step)
    torch.cuda.synchronize()
    assert conv4head_bwd_w.launches_bf16 == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i in BF16_MODELS:
        one = [t[i : i + 1] for t in (g, xb, *ops)]
        ref = conv4head_bwd_plain(*one, w, step)[1:]
        for name, a, r in zip(("dw12", "db12", "dw3", "dw4"), got, ref):
            _bf16_close(a[i : i + 1], r, BF16_BWD_REL, f"B2w-bf16 W=500 model {i} {name}")


# Windows past B2w's whole-window plan (292 samples at C <= 64, 268 at C = 72):
# f32 weight gradients in column tiles (W, step), T = 800.
F32_COLUMN_TILE_WINDOWS = ((293, 127), (500, 150), (800, 1))


@pytest.mark.parametrize("c", [8, 64, 72])
@pytest.mark.parametrize("w,step", F32_COLUMN_TILE_WINDOWS)
def test_f32_column_tiles_match_plain(dev, w, step, c):
    """f32 weight gradients at windows of 293, 500 and 800 samples (two to
    four column tiles, the last short at 293 and 800), C = 8, 64 and 72, M =
    2, B = 4, 2 zones: one B2w launch, no general one, nothing adapted, held
    against the plain f32 backward on the CPU at the backward's tolerance;
    a second launch bit-identical."""
    x, *ops = _head_operands(2, 4, c, 800, 2, 32, w + c)
    n = (800 - w) // step + 1
    g = torch.tensor(np.random.default_rng(w + c).normal(size=(2, 4, n, 64)).astype(np.float32))
    before = (conv4head_bwd_w.launches, conv4head_bwd_w.launches_general,
              conv4head_bwd_w.adapted)
    cuda_ops = [t.to(dev) for t in (g, x, *ops)]
    got = conv4head_bwd_w(*cuda_ops, w, step)
    again = conv4head_bwd_w(*cuda_ops, w, step)
    torch.cuda.synchronize()
    assert (conv4head_bwd_w.launches, conv4head_bwd_w.launches_general,
            conv4head_bwd_w.adapted) == (before[0] + 2, before[1], before[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = conv4head_bwd_plain(g, x, *ops, w, step)[1:]
    for name, a, r in zip(("dw12", "db12", "dw3", "dw4"), got, ref):
        _assert_grad_close(a.cpu(), r, f"B2w W={w} C={c} {name}")


def test_f32_column_tiles_at_the_step_shape(dev):
    """B2w in column tiles at section 14 (a)'s f32 step shape (75 models,
    batch 64, full width, 3 windows of 500, two tiles each): models 0, 37
    and 74 against the plain f32 backward at the backward's tolerance, and a
    second launch bit-identical."""
    _, _, ops, x, _ = _full_width_operands(dev, 75, 64, 62)
    w, step = 500, 150
    g = torch.randn((75, 64, 3, 256), generator=torch.Generator(device=dev).manual_seed(62),
                    device=dev)
    before = (conv4head_bwd_w.launches, conv4head_bwd_w.launches_general)
    got = conv4head_bwd_w(g, x, *ops, w, step)
    again = conv4head_bwd_w(g, x, *ops, w, step)
    torch.cuda.synchronize()
    assert (conv4head_bwd_w.launches, conv4head_bwd_w.launches_general) == (
        before[0] + 2, before[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i in BF16_MODELS:
        one = [t[i : i + 1] for t in (g, x, *ops)]
        ref = conv4head_bwd_plain(*one, w, step)[1:]
        for name, a, r in zip(("dw12", "db12", "dw3", "dw4"), got, ref):
            _assert_grad_close(a[i : i + 1], r, f"B2w W=500 model {i} {name}")


@pytest.mark.parametrize("c,w", [(64, 250), (64, 292), (64, 293), (64, 500), (8, 800),
                                 (72, 268), (72, 269), (72, 500), (80, 500)])
def test_f32_column_tile_mirror_matches_the_library(dev, c, w):
    """The Python mirror of B2w's plan (``bwd_w_smem_bytes``: the whole
    window's where it fits a block, past it the column tiles') equals the
    library's ``isd_conv4head_bwd_w_smem_bytes`` on both sides of the
    whole window's reach."""
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import bwd_w_smem_bytes

    assert bwd_w_smem_bytes(c, w) == _lib.library().isd_conv4head_bwd_w_smem_bytes(c, w, 32, 5)


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
    (32, 72, 800, 250, 125, torch.bfloat16, (0, 2, 1, 1, 0, 1)),  # C = 72: B2w on the f32 route
])
def test_adapted_geometries_train_on_the_card(dev, o, c, t, w, step, dtype, routes):
    """Head geometries the kernels are not built for launch them on
    zero-padded or split operands: the features and the weight gradients
    of <g, head> match the CPU (f32: rtol 1e-4, atol 1e-5 / 1e-4 x
    max|ref|; bf16: 3e-4 and 1e-3 x max|ref|), and the launch and
    ``adapted`` counters say what ran. At C = 72 in bf16 the forward runs
    B2f-bf16 in groups and the weight gradients run B2w (f32) on the bf16
    operands, B2w-bf16 having no plan for C > 64: those gradients within
    ``F32_ROUTE_REL_L2`` in relative L2 of the CPU's plain bf16 backward."""
    x, *weights = _head_operands(2, 3, c, t, 2, o, o + c + t)
    n = (t - w) // step + 1
    g = torch.tensor(np.random.default_rng(t).normal(size=(2, 3, n, 2 * o)).astype(np.float32))
    f32_route = dtype == torch.bfloat16 and c > 64
    results = {}
    for device in (dev, torch.device("cpu")):
        wd = [p.to(device).requires_grad_(True) for p in weights]
        before = _route_counts()
        out = fused_conv4_head(x.to(device, dtype), *wd, w, step)
        (out * g.to(device)).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(_route_counts(), before)) == routes
        results[device.type] = [out.detach().cpu()] + [p.grad.cpu() for p in wd]
    names = ("out", "dw12", "db12", "dw3", "dw4")
    for name, got, ref in zip(names, results["cuda"], results["cpu"]):
        if f32_route and name != "out":
            assert float((got - ref).norm() / ref.norm()) <= F32_ROUTE_REL_L2, name
        elif dtype == torch.bfloat16:
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


def test_filter_corpus_matches_plain_at_the_corpus_size(dev):
    """The preprocessing CLI's filter (60 Hz notch, then 4-40 Hz band-pass,
    each zero-phase) over the train split's R = 4,500 x 64 = 288,000 rows:
    one B1 chain launch, against the plain chain over all of it."""
    from imagined_speech_decoding_tpu_torch.ops.filters import corpus_filters, filter_corpus

    x = torch.randn(4500, 64, 800, generator=torch.Generator().manual_seed(3)).to(dev)
    launches = sosfiltfilt_chain.launches
    got = filter_corpus(x, 60.0, (4.0, 40.0))
    torch.cuda.synchronize()
    assert sosfiltfilt_chain.launches == launches + 1
    ref = sosfiltfilt_chain_plain(corpus_filters(250.0, 60.0, (4.0, 40.0)), x)
    _iir_close(got, ref)
    assert torch.equal(filter_corpus(x, None, None), x)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_kill_and_resume_is_bit_identical_on_the_card(dev, tmp_path, precision):
    """Full-width FAST, M = 6 stacked models, 4 epochs in segments of 2,
    dropout on: a run that crashes in its second segment and is resumed
    from its checkpoint in a new model equals the uninterrupted run bit for
    bit (parameters, best snapshot, history)."""
    from imagined_speech_decoding_tpu_torch.config import TrainConfig
    from imagined_speech_decoding_tpu_torch.train import engine

    cfg = FASTConfig.default()
    dtype = TrainConfig(precision=precision).compute_dtype
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(40, 64, 800)).astype(np.float32)).to(dev, dtype)
    y = torch.from_numpy(rng.integers(0, 5, 40)).to(dev)
    perms = np.stack([rng.permutation(40) for _ in range(6)])
    p0 = from_jax_params(init_jax_layout_params(cfg, 1, 6))

    class Crash(Exception):
        pass

    def run(crash_at=None, **kw):
        model = FAST(cfg, n_models=6, device=dev)
        model.load_state_dict(p0)
        fit = engine.make_fit(model, 5, epochs=2, batch_size=16, n_train=32, n_val=8,
                              total_epochs=4)

        def progress(epoch, _):
            if epoch == crash_at:
                raise Crash()

        return engine.fit_segmented(fit, perms[:, :32], perms[:, 32:], x, y, seed=5,
                                    progress=progress, **kw)

    ref = run()
    with pytest.raises(Crash):
        run(crash_at=3, checkpoint_dir=str(tmp_path))
    resumed = run(checkpoint_dir=str(tmp_path))
    for k in ref.params:
        assert torch.equal(resumed.params[k], ref.params[k]), k
        assert torch.equal(resumed.best_params[k], ref.best_params[k]), k
    for k in ref.history:
        np.testing.assert_array_equal(resumed.history[k], ref.history[k])
    np.testing.assert_array_equal(resumed.best_epoch, ref.best_epoch)


def test_failed_capture_raises(dev):
    """A chain that cannot be captured (here: it waits for the device) raises;
    the decoder never serves such a shape eagerly instead."""
    decode = GraphedChain(lambda x: x * float(x.sum()), dev)
    x = np.ones((1, 4), np.float32)
    with pytest.raises(RuntimeError):
        decode(x)
    assert decode.graphs == {}
    # the card serves on after the failed capture
    live = make_online_decoder(FAST(SERVE_CFG, device=dev), init_jax_layout_params(SERVE_CFG, 2))
    assert [live(np.zeros((1, 10, 800), np.float32)).shape for _ in range(2)] == [(1, 5)] * 2


# --- the campaign programs: sweep, LOSO, zero-shot, seed ensemble -------------------


def _head_counts():
    """(B2f, B2f-bf16, B2w, B2w-bf16 launches, adapted calls of both)."""
    return (fused_conv4_head.launches, fused_conv4_head.launches_bf16, conv4head_bwd_w.launches,
            conv4head_bwd_w.launches_bf16, fused_conv4_head.adapted + conv4head_bwd_w.adapted)


def _moved(before):
    torch.cuda.synchronize()
    return tuple(a - b for a, b in zip(_head_counts(), before))


def test_sweep_cli_on_the_card(dev, tmp_path):
    """``cli.sweep --synthetic`` at full width in its default bf16 on the
    card: 3 configs x 3 folds of 20 + 10 trials, batch 8, 2 epochs launch
    B2f-bf16 2 x (3 + 2) and B2w-bf16 2 x 3 times, no f32 head kernel,
    nothing adapted; the two configs of one (lr, wd) train bit for bit
    alike; the artifacts are written."""
    from imagined_speech_decoding_tpu_torch.cli import sweep as cli_sweep

    before = _head_counts()
    report = cli_sweep.main(["--synthetic", "30", "--lr_scales", "1,1,2", "--wd_scales", "1",
                             "--n_folds", "3", "--epochs", "2", "--batch_size", "8",
                             "--config", "none.yaml", "--output_dir", str(tmp_path)])
    assert _moved(before) == (0, 10, 0, 6, 0)
    for k, v in report.fit.params.items():
        assert torch.equal(v[:3], v[3:6]), k
    for k in report.history:
        np.testing.assert_array_equal(report.history[k][0], report.history[k][1])
    assert all(np.isfinite(v).all() for v in report.history.values())
    assert (tmp_path / "sweep_results.csv").exists() and (tmp_path / "best.json").exists()


def test_loso_on_the_card_matches_the_cpu(dev, tmp_path):
    """``pretrain_loso`` at tiny width in f32, dropout 0: the card against
    the CPU (trajectory tolerances, rtol 1e-4, atol 1e-5); the card's
    second call launches nothing and returns its saved rows; bf16 runs
    B2f-bf16 and B2w-bf16."""
    from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
    from imagined_speech_decoding_tpu_torch.train import loso

    cfg = FASTConfig(electrodes=ELECTRODES, zone_dict=ZONES, seq_len=200, window_len=100,
                     slide_step=50, dim_token=16, num_layers=1, num_heads=4, dropout=0.0)
    X, Y = synthetic_corpus(0, 3, 20, 10, 200)
    subs = ["01", "02", "03"]
    kw = dict(epochs=2, batch_size=8, learning_rate=1e-3, warmup_epochs=0, verbose=False)
    card, res = loso.pretrain_loso(cfg, X, Y, subs, 5, str(tmp_path / "card"), device=dev,
                                   return_result=True, **kw)
    cpu, ref = loso.pretrain_loso(cfg, X, Y, subs, 5, str(tmp_path / "cpu"), device="cpu",
                                  return_result=True, **kw)
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(res.history[k], ref.history[k], rtol=1e-4, atol=1e-5)
    before = _head_counts()
    again = loso.pretrain_loso(cfg, X, Y, subs, 5, str(tmp_path / "card"), device=dev, **kw)
    assert _moved(before) == (0,) * 5
    for a, b in zip(card, again):
        for x, y in zip(a["head"]["cnn2"].values(), b["head"]["cnn2"].values()):
            np.testing.assert_array_equal(x, y)
    before = _head_counts()
    loso.pretrain_loso(cfg, X, Y, subs, 5, str(tmp_path / "bf16"), device=dev,
                       data_dtype=torch.bfloat16, **kw)
    moved = _moved(before)
    assert moved[0] == moved[2] == 0 and moved[1] > 0 and moved[3] > 0, moved


def test_zero_shot_cli_synthetic_on_the_adapted_route(dev, tmp_path):
    """``cli.zero_shot --synthetic``: its 16-electrode, dim_cnn 8 models
    train and evaluate in f32 on the card through B2f and B2w on zones
    zero-padded to 32 channels (``adapted`` > 0); no bf16 kernel."""
    from imagined_speech_decoding_tpu_torch.cli import zero_shot

    before = _head_counts()
    matrix = zero_shot.main(["--synthetic", "3", "--synthetic_trials", "16",
                             "--synthetic_epochs", "2", "--config", "none.yaml",
                             "--output_dir", str(tmp_path)])
    moved = _moved(before)
    assert moved[0] > 0 and moved[2] > 0 and moved[1] == moved[3] == 0 and moved[4] > 0, moved
    assert matrix.shape == (3, 3) and ((matrix >= 0) & (matrix <= 1)).all()
    assert (tmp_path / "zero_shot_matrix.csv").exists()


def test_train_fast_ensemble_with_hyperparams_on_the_card(dev, tmp_path, capsys):
    """``cli.train_fast --ensemble 2 --hyperparams best.json`` on the card
    at full width: the sweep's winner is applied, both members train
    through B2f-bf16 and B2w-bf16 with nothing adapted, and the root
    predictions are the argmax of the members' mean posteriors."""
    from imagined_speech_decoding_tpu_torch.train.artifacts import load_predictions_csv

    best = tmp_path / "best.json"
    best.write_text('{"learning_rate": 0.001, "weight_decay": 0.05, "warmup_epochs": 1}')
    before = _head_counts()
    res = train_fast.main(["--synthetic", "2", "--synthetic_trials", "15", "--epochs", "2",
                           "--n_folds", "3", "--batch_size", "8", "--ensemble", "2",
                           "--hyperparams", str(best), "--config", "none.yaml",
                           "--output_dir", str(tmp_path / "out")])
    moved = _moved(before)
    assert moved[0] == moved[2] == moved[4] == 0 and moved[1] > 0 and moved[3] > 0, moved
    assert "hyperparams from" in capsys.readouterr().out
    assert len(res.members) == 2
    for sid, proba in res.proba_per_subject.items():
        pred, _ = load_predictions_csv(str(tmp_path / "out" / f"sub-{sid}" / "test_predictions.csv"))
        np.testing.assert_array_equal(pred, proba.argmax(-1))
        assert (tmp_path / "out" / "member-1" / f"sub-{sid}" / "best_subject.npz").exists()


BN_HEADS = ("CVBlock", "EEGNet_Encoder", "HeadConv_Paper_Version")


class _PoolRouting:
    """``heads.max_pool_time2`` that records the share of each pair's
    gradient that the max gives its first element (1, 0, or 1/2 at an
    exact tie, as ``amax`` splits it) in the card's run (``replay``
    None: the function itself), or, in a reference run, gives the
    recorded share where the pair is within 1e-5 (relative) of a tie and
    checks that the shares agree everywhere else. The pool's gradient
    jumps at a tie, so a tie that the card's rounding breaks otherwise, or
    makes exact, moves the gradients upstream of it (by up to 5e-4 of
    their largest in HeadConv's step)."""

    def __init__(self, pool):
        self.pool, self.shares, self.replay, self.rerouted = pool, [], None, []

    def __call__(self, h):
        t = h.shape[-1] // 2 * 2
        p = h[..., :t].reshape(*h.shape[:-1], t // 2, 2)
        a, b = p[..., 0], p[..., 1]
        share = (a > b).to(p.dtype) + 0.5 * (a == b).to(p.dtype)
        if self.replay is None:
            self.shares.append(share.detach().cpu())
            return self.pool(h)
        card = self.replay.pop(0).to(p.dtype)
        near = (a - b).abs() <= 1e-5 * p.abs().amax(-1)
        assert bool((share == card)[~near].all()), "max-pool choices differ away from a tie"
        self.rerouted.append(int((near & (share != card)).sum()))
        share = torch.where(near, card, share.detach())
        return share * a + (1 - share) * b


@pytest.mark.parametrize("head", BN_HEADS)
def test_bn_head_step_matches_cpu(dev, head, monkeypatch):
    """One f32 training step of a stack of 2 full-width FASTs with a
    batch-norm head (cuDNN convolutions, TF32 off) against the CPU from
    the same weights and batch: the logits and new running statistics at
    rtol 1e-4 / atol 1e-5, and each gradient tensor at rtol 1e-4, atol
    1e-4 x max|ref| of that tensor, as TSception's test holds them; no
    hand-written kernel runs.

    A leaf whose f32 gradient is rounding noise is held against the f64
    gradient of the CPU instead, at atol 1e-4 x the largest |f64
    gradient| of the head: a leaf is noise where the CPU's own f32
    gradient misses the f64 one by more than the tolerance above. These
    are the leaves whose exact gradient is 0 or nearly so: ``bn1.bias``
    and HeadConv's ``cnn1_t.b`` (a shift that the next batch norm takes
    out) and ``bn1.scale`` (a scale that it takes out but for its eps).
    HeadConv's max pools share the CPU's gradients within 1e-5 of a tie as
    the card's did (``_PoolRouting``)."""
    from imagined_speech_decoding_tpu_torch.models import heads
    from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout

    cfg = dataclasses.replace(FASTConfig.default(), head=head, dropout=0.0)
    params, state = init_jax_layout(cfg, 3, 2)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(2, 6, 64, 800)).astype(np.float32))
    out, routing = {}, _PoolRouting(heads.max_pool_time2)
    monkeypatch.setattr(heads, "max_pool_time2", routing)
    for name, d, dtype in (("cuda", dev, torch.float32), ("cpu", torch.device("cpu"), torch.float32),
                           ("f64", torch.device("cpu"), torch.float64)):
        if name != "cuda":
            routing.replay = list(routing.shares)
        model = FAST(cfg, n_models=2, device=d).to(dtype)
        model.load_state_dict(from_jax_params(params, state))
        before = _head_counts()
        logits = model.train()(x.to(d, dtype))
        (logits ** 2).sum().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert _head_counts() == before
        out[name] = (logits.detach().cpu(), {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (lg, sd, g), (lc, sdc, gc), (_, _, g64) = out["cuda"], out["cpu"], out["f64"]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)
    for k in sdc:
        if k.endswith((".mean", ".var")):
            torch.testing.assert_close(sd[k], sdc[k], rtol=1e-4, atol=1e-5, msg=k)
    head_scale = max(float(g64[k].abs().max()) for k in g64 if k.startswith("head."))
    noise, seen = set(), {}
    for k in gc:
        scale = float(g64[k].abs().max())
        cpu_err = (gc[k].double() - g64[k]).abs()
        card_err = (g[k].double() - g64[k]).abs()
        seen[k] = (f"{scale:.2e}", f"{float(cpu_err.max()):.2e}", f"{float(card_err.max()):.2e}")
        if bool((cpu_err > 1e-4 * float(gc[k].abs().max()) + 1e-4 * g64[k].abs()).any()):
            noise.add(k)
    print(head, "gradients, max|f64| and max|err| of the CPU's f32 and of the card against it; "
          f"rounding noise: {sorted(noise)}; the head's largest |gradient| {head_scale:.3g}; "
          f"max-pool pairs shared as on the card, by pool and run: {routing.rerouted}:",
          {k: v for k, v in seen.items() if k.startswith("head.")})
    for k in gc:
        if k in noise:
            torch.testing.assert_close(g[k].double(), g64[k], rtol=0.0, atol=1e-4 * head_scale,
                                       msg=lambda m, k=k: f"{k}: {m}")
        else:
            torch.testing.assert_close(g[k], gc[k], rtol=1e-4, atol=1e-4 * float(gc[k].abs().max()),
                                       msg=lambda m, k=k: f"{k}: {m}")
    assert noise <= {"head.bn1.scale", "head.bn1.bias", "head.cnn1_t.b"}, noise


def test_tsception_step_matches_cpu(dev):
    """One f32 TSception training step of a stack of 2 at 64 x 800: logits,
    running statistics and gradients on the card against the CPU."""
    from imagined_speech_decoding_tpu_torch.models.api import make_tsception_model

    mdef = make_tsception_model(64, 800, dropout=0.0)
    params, state = mdef.init(5, 2)
    x = torch.tensor(np.random.default_rng(6).normal(size=(2, 4, 64, 800)).astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        model = mdef.build(2, d)
        mdef.load(model, params, state)
        logits = model.train()(x.to(d))
        (logits ** 2).sum().backward()
        out[d.type] = (logits.detach().cpu(), {k: v.detach().cpu() for k, v in model.state_dict().items()},
                       {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (lg, sd, g), (lc, sdc, gc) = out["cuda"], out["cpu"]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)
    for k in ("bn_t.mean", "bn_t.var", "bn_s.mean", "bn_s.var"):
        torch.testing.assert_close(sd[k], sdc[k], rtol=1e-4, atol=1e-5)
    for k in gc:
        torch.testing.assert_close(g[k], gc[k], rtol=1e-4, atol=1e-4 * float(gc[k].abs().max()))


def test_stateful_checkpoint_live_decode(dev, tmp_path):
    """A CVBlock checkpoint with moved running statistics, served live on
    the card: B1's chain launches once an eager decode, a replay equals
    the eager chain bit for bit, the posteriors match the CPU decoder, and
    ``swap_weights(params, state)`` is seen by the next replay."""
    from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout

    cfg = dataclasses.replace(FASTConfig.default(), head="CVBlock")
    params, state = init_jax_layout(cfg, 7)
    moved = {"head": {k: type(v)(v.mean + 0.3, v.var * 1.7) for k, v in state["head"].items()}}
    x = np.random.default_rng(8).normal(size=(3, 64, 800)).astype(np.float32)
    launches = sosfiltfilt_chain.launches
    decode = make_online_decoder(FAST(cfg, device=dev), params, moved)
    first = decode(x)
    replay = decode(x)
    torch.cuda.synchronize()
    assert sosfiltfilt_chain.launches == launches + 1 and decode.replays == 1
    np.testing.assert_array_equal(first, replay)
    np.testing.assert_array_equal(replay, _eager(decode, x, served=4))  # B = 3 runs at 4
    cpu = make_online_decoder(FAST(cfg), params, moved)
    np.testing.assert_allclose(replay, cpu(x), rtol=1e-4, atol=1e-5)
    decode.swap_weights(params, state)
    fresh = make_online_decoder(FAST(cfg, device=dev), params, state)
    np.testing.assert_array_equal(decode(x), fresh(x))
    assert not np.array_equal(decode(x), replay)


# --- the feature baselines and the bf16 heads' f32 route ------------------

FEAT_RTOL, FEAT_ATOL = 1e-4, 1e-5  # tests/test_torch_pipelines.py
FEAT_DELTA_ATOL = 1e-2  # the stop band's Delta log power: chip_smoke.py's FEAT_DELTA_ATOL says why


def test_bandpower_featurize_launches_b1_and_matches_the_cpu(dev):
    """The band-power featurizer on the card: one B1 chain launch (the
    notch and the band-pass), no causal launch, and the CPU's plain
    featurizer's features at the CPU tests' tolerance (the Delta band, in
    the band-pass's stop band, at ``FEAT_DELTA_ATOL`` on its log); the STFT
    planes likewise, with no launch."""
    from imagined_speech_decoding_tpu_torch import pipelines

    x = np.random.default_rng(0).normal(size=(40, 64, 800)).astype(np.float32)
    chain0, causal0 = sosfiltfilt_chain.launches, sosfilt_time_major.launches
    got = pipelines.bandpower_featurize(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert sosfiltfilt_chain.launches == chain0 + 1 and sosfilt_time_major.launches == causal0
    ref = pipelines.bandpower_featurize(torch.from_numpy(x)).numpy().reshape(-1, 5)
    got = got.cpu().numpy().reshape(-1, 5)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=FEAT_RTOL, atol=FEAT_DELTA_ATOL)
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=FEAT_RTOL, atol=FEAT_ATOL)
    got = pipelines.stft_image_featurize(torch.from_numpy(x[:8]).to(dev))
    ref = pipelines.stft_image_featurize(torch.from_numpy(x[:8]))
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=FEAT_RTOL, atol=FEAT_ATOL)
    assert sosfiltfilt_chain.launches == chain0 + 1


@pytest.mark.parametrize("method", ["iir", "fir"])
def test_bandpass_and_notch_filter_on_the_card(dev, method):
    """``bandpass_filter`` (the IIR as one B1 chain launch; the FIR as an f32
    convolution without TF32) and ``notch_filter`` (one B1 launch) against
    the CPU, at B1's tolerance (rtol 1e-4, atol 1e-4 x max|ref|)."""
    from imagined_speech_decoding_tpu_torch.ops.filters import bandpass_filter, notch_filter

    x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 64, 800)).astype(np.float32))
    before = sosfiltfilt_chain.launches
    for fn in (lambda v: bandpass_filter(v, 250.0, 4.0, 40.0, method=method),
               lambda v: notch_filter(v, 250.0)):
        ref = fn(x)
        torch.testing.assert_close(fn(x.to(dev)).cpu(), ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))
    torch.cuda.synchronize()
    assert sosfiltfilt_chain.launches == before + (2 if method == "iir" else 1)


@pytest.mark.parametrize("name", ["mlp", "stft_eegnet", "cnn_bilstm"])
def test_baseline_step_matches_cpu(dev, name):
    """One f32 training step of a stack of 3 baseline models, dropout off:
    logits, the new running statistics and the gradients on the card
    against the CPU (rtol 1e-4, atol 1e-5)."""
    from imagined_speech_decoding_tpu_torch.models import api

    mdef, shape = {"mlp": (api.make_mlp_model(320, 5, dropout=0.0), (320,)),
                   "stft_eegnet": (api.make_stft_eegnet_model(64, 800, 5, dropout=0.0),
                                   (5, 64, 101)),
                   "cnn_bilstm": (api.make_cnn_bilstm_model(64, 800, 5, dropout=0.0),
                                  (64, 800))}[name]
    params, state = mdef.init(0, 3)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 8) + shape).astype(np.float32))
    outs = {}
    for d in (dev, torch.device("cpu")):
        model = mdef.build(3, d)
        mdef.load(model, params, state)
        model.train()
        logits = model(x.to(d))
        (logits ** 2).sum().backward()
        outs[d.type] = (logits.detach().cpu(),
                        {k: p.grad.cpu() for k, p in model.named_parameters()},
                        {k: b.cpu() for k, b in model.named_buffers()})
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_train_baselines_cli_on_the_card(dev, tmp_path):
    """``cli.train_baselines`` on the card for each pipeline (2 subjects x 20
    trials, 1 epoch, bf16): the tree, and one B1 chain launch a featurized
    split for the band-power pipeline."""
    from imagined_speech_decoding_tpu_torch.cli import train_baselines

    for name in ("bandpower_mlp", "stft_eegnet", "cnn_bilstm"):
        before = sosfiltfilt_chain.launches
        res = train_baselines.main(["--pipeline", name, "--synthetic", "2", "--synthetic_trials",
                                    "20", "--epochs", "1", "--output_dir", str(tmp_path / name)])
        torch.cuda.synchronize()
        assert sosfiltfilt_chain.launches - before == (2 if name == "bandpower_mlp" else 0)
        assert np.isfinite(res.fit.history["loss"]).all()
        assert (tmp_path / name / "sub-02" / "best_subject.npz").exists()



@pytest.mark.parametrize("c,w,step", [(72, 250, 125), (68, 250, 125)])
def test_bf16_geometry_routes_to_the_f32_kernel(dev, c, w, step):
    """A bf16 head geometry that B2w-bf16 has no plan for (C = 72 and 68:
    its weight-gradient tiles; every window at C <= 64 takes its column
    tiles) runs the f32 B2w on the bf16 kernel's operands, counted in ``adapted``,
    within 1e-2 in relative L2 of the plain bf16 backward; the forward
    (B2f-bf16, in groups of windows at C = 72) likewise against the plain
    bf16 forward."""
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import conv4head_bwd_bf16_plain

    rng = np.random.default_rng(3)
    m, b, z, o, k, t = 1, 4, 2, 32, 5, 800
    n = (t - w) // step + 1

    def arr(shape, scale=1.0):
        return torch.tensor(rng.normal(scale=scale, size=shape).astype(np.float32))

    x = arr((m, b, c, t)).to(torch.bfloat16)
    w12, b12 = arr((m, z * o, k * c), (k * c) ** -0.5), arr((m, z * o, 1), 0.1)
    w3, w4 = arr((m, z, o, k * o), (k * o) ** -0.5), arr((m, z, o, k * o), (k * o) ** -0.5)
    g = arr((m, b, n, z * o))
    ops = [t_.to(dev) for t_ in (x, w12, b12, w3, w4)]
    before = (conv4head_bwd_w.launches, conv4head_bwd_w.launches_bf16, conv4head_bwd_w.adapted)
    got = conv4head_bwd_w(g.to(dev), *ops, w, step)
    torch.cuda.synchronize()
    assert (conv4head_bwd_w.launches, conv4head_bwd_w.launches_bf16,
            conv4head_bwd_w.adapted) == (before[0] + 1, before[1], before[2] + 1)
    ref = conv4head_bwd_bf16_plain(g, x, w12, b12, w3, w4, w, step)[1:]
    for a, r in zip(got, ref):
        assert float((a.cpu() - r).norm() / r.norm()) <= F32_ROUTE_REL_L2
    with torch.no_grad():
        fwd = fused_conv4_head(*ops, w, step).cpu()
    ref_f = fused_conv4_head_plain(x, w12, b12, w3, w4, w, step)
    assert float((fwd - ref_f).norm() / ref_f.norm()) <= F32_ROUTE_REL_L2


GENERAL_COUNTERS = ("launches_general", "launches_general_bf16")


def _general_counts():
    return {(fn.__name__, k): getattr(fn, k) for fn in (fused_conv4_head, conv4head_bwd_w,
                                                          conv4head_bwd_x)
            for k in GENERAL_COUNTERS + ("launches", "launches_bf16", "adapted")
            if hasattr(fn, k)}


def _general_operands(dev, c, t, w, step, o, seed, m=2, b=8, z=8):
    """Full-width head operands at C channels, O-wide zones, from numpy."""
    x, *weights = _head_operands(m, b, c, t, z, o, seed)
    n = (t - w) // step + 1
    g = torch.tensor(np.random.default_rng(seed + 1).normal(size=(m, b, n, z * o))
                     .astype(np.float32))
    return [a.to(dev) for a in (g, x, *weights)]


# (d)'s grid of chip_smoke.py section 14: C = 80 and 128 at windows of 250, C =
# 64 at windows of 500 and 800, O = 64 at the shipped geometry.
GENERAL_GRID = [(80, 800, 250, 125, 32), (128, 800, 250, 125, 32), (64, 800, 500, 150, 32),
                (64, 800, 800, 1, 32), (64, 800, 250, 125, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,t,w,step,o", GENERAL_GRID)
def test_general_kernels_match_plain(dev, c, t, w, step, o, dtype):
    """B2f-g, B2w-g and B2x-g at M = 2, B = 8 where no tuned plan fits (or
    O > 32): one general launch each in x's precision, no tuned launch,
    nothing adapted; each held against its plain version on the card (f32:
    features rtol 1e-4 / atol 1e-5, gradients rtol 1e-4 / atol 1e-4 x
    max|ref|; bf16: features 3e-4 and weight gradients 1e-3 x max|ref|, dx
    BF16_DX_L2 in relative L2), and bit-identical on a second run. A bf16 forward that
    B2f-bf16 takes (windows of 500, one a launch) stays there, and weight
    gradients at C = 64 and O = 32 (windows of 500 and 800) run B2w-bf16's
    column tiles in bf16 and B2w's in f32."""
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import conv4head_bwd_bf16_plain

    g, x, *ops = _general_operands(dev, c, t, w, step, o, c + w + o)
    bf16 = dtype == torch.bfloat16
    x = x.to(dtype)
    key = "launches_general_bf16" if bf16 else "launches_general"
    n = (t - w) // step + 1
    tuned_fwd = bf16 and o == 32 and conv4head._bf16_refusal("fwd", c, w, step, n, None,
                                                              None) is None
    tuned_w = o == 32 and c <= (64 if bf16 else 72)
    results = []
    for _ in range(2):
        before = _general_counts()
        with torch.no_grad():
            out = fused_conv4_head(x, *ops, w, step)
        dw = conv4head_bwd_w(g, x, *ops, w, step)
        dx = conv4head_bwd_x(g, x, *ops, w, step)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in _general_counts().items() if v != before[k]}
        groups = moved.pop(("fused_conv4_head", "launches_bf16"), 0)
        moved.pop(("fused_conv4_head", "adapted"), None)  # B2f-bf16 in groups of windows
        tuned = "launches_bf16" if bf16 else "launches"
        want = {("conv4head_bwd_w", tuned if tuned_w else key): 1,
                ("conv4head_bwd_x", key): 1}
        if not tuned_fwd:
            want[("fused_conv4_head", key)] = 1
        assert moved == want and (groups >= 1) == tuned_fwd, (moved, groups)
        results.append([out, dx, *dw])
    for a, b in zip(*results):
        assert torch.equal(a, b)
    out, dx, *dw = results[0]
    if bf16:
        ref = conv4head_bwd_bf16_plain(g, x, *ops, w, step)
        _bf16_close(out, fused_conv4_head_plain(x, *ops, w, step), BF16_FWD_REL, "out")
        assert dx.dtype == torch.bfloat16
        assert float((dx.float() - ref[0].float()).norm() / ref[0].float().norm()) <= BF16_DX_L2
        for name, got, r in zip(("dw12", "db12", "dw3", "dw4"), dw, ref[1:]):
            _bf16_close(got, r, BF16_BWD_REL, name)
        return
    torch.testing.assert_close(out, fused_conv4_head_plain(x, *ops, w, step), rtol=1e-4,
                               atol=1e-5)
    for name, got, r in zip(("dx", "dw12", "db12", "dw3", "dw4"), (dx, *dw),
                            conv4head_bwd_plain(g, x, *ops, w, step)):
        _assert_grad_close(got, r, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shipped_step_launches_no_general_kernel(dev, dtype):
    """A training step of a stacked full-width FAST at the shipped geometry
    (forward and weight gradients) launches the tuned kernels only: every
    general counter stays at 0."""
    cfg, model, ops, x, g = _full_width_operands(dev, 2, 8, 57)
    ops = [t.detach().requires_grad_(True) for t in ops]
    before = _general_counts()
    out = fused_conv4_head(x.to(dtype), *ops, cfg.window_len, cfg.slide_step)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    after = _general_counts()
    assert all(after[k] == before[k] for k in after if k[1] in GENERAL_COUNTERS)
    tuned = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    assert after[("conv4head_bwd_w", tuned)] == before[("conv4head_bwd_w", tuned)] + 1


@pytest.mark.parametrize("c,w", [(64, 250), (72, 250), (80, 250), (128, 250), (64, 280),
                                 (64, 600), (8, 100)])
def test_f32_plan_mirrors_match_the_library(dev, c, w):
    """``fwd_smem_bytes`` / ``bwd_w_smem_bytes`` / ``bwd_x_smem_bytes`` (the
    route's choice between the tuned and the general kernels) equal the
    library's ``isd_conv4head_smem_bytes`` / ``isd_conv4head_bwd_w_smem_bytes``
    / ``isd_conv4head_bwd_x_smem_bytes``."""
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (bwd_w_smem_bytes,
                                                                        bwd_x_smem_bytes,
                                                                        fwd_smem_bytes)

    lib = _lib.library()
    assert fwd_smem_bytes(c, w) == lib.isd_conv4head_smem_bytes(c, w, 32, 5)
    assert bwd_w_smem_bytes(c, w) == lib.isd_conv4head_bwd_w_smem_bytes(c, w, 32, 5)
    assert bwd_x_smem_bytes(c, w) == lib.isd_conv4head_bwd_x_smem_bytes(c, w, 32, 5)


# --- the engine's remaining paths: forward modes, early stopping, dense tokens,
# batch-norm LOSO and sweep ------------------------------------------------------------


@pytest.mark.parametrize("mode,want", [("default", (0, 1, 0, 1, 0)),
                                       ("train_head", (0, 1, 0, 1, 0)),
                                       ("train_transformer", (0, 1, 0, 0, 0))])
def test_forward_mode_step_routes_on_the_card(dev, mode, want):
    """One bf16 engine step of a stack of 2 full-width FASTs bound to each
    mode: B2f-bf16 once, B2w-bf16 once but under ``train_transformer`` (its
    head runs outside autograd), no f32 head kernel, no B2x, nothing
    adapted. Under ``train_transformer`` the head's weights move by the
    weight decay alone, ``p - lr * wd * p`` within two f32 roundings."""
    from imagined_speech_decoding_tpu_torch.models.api import make_fast_model
    from imagined_speech_decoding_tpu_torch.train import engine
    from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout

    lr, wd = 1e-3, 0.01
    cfg = FASTConfig.default()
    mdef = make_fast_model(cfg, forward_mode=mode)
    model = mdef.build(2, dev)
    mdef.load(model, *init_jax_layout(cfg, 5, 2))
    model.train()
    opt = engine.make_optimizer(model.parameters(), wd)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 8, 64, 800), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randint(0, 5, (2, 8), generator=gen, device=dev)
    head0 = {k: p.detach().clone() for k, p in model.named_parameters() if k.startswith("head.")}
    before, bwd_x = _head_counts(), conv4head_bwd_x.launches
    engine.train_step(model, opt, x, y, lr, 5, gen)
    assert _moved(before) == want and conv4head_bwd_x.launches == bwd_x
    for k, p in model.named_parameters():
        if k in head0 and mode == "train_transformer":
            ref = head0[k].double() * (1 - lr * wd)
            err = (p.detach().double() - ref).abs() / head0[k].double().abs().clamp_min(1e-30)
            assert float(err.max()) <= 2.5e-7, k
        elif k in head0:
            assert not torch.equal(p.detach(), head0[k]), k


def test_early_stop_freezes_rows_on_the_card(dev):
    """Early stopping at threshold 0 on a bf16 stack of 2 full-width models,
    3 epochs: every row stops after epoch 1; epochs 2-3 launch B2f-bf16 and
    B2w-bf16 as their batches count them and leave parameters, AdamW
    moments and best snapshots bit for bit."""
    from imagined_speech_decoding_tpu_torch.train import engine
    from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout

    cfg = FASTConfig.default()
    model = FAST(cfg, n_models=2, device=dev)
    model.load_state_dict(from_jax_params(*init_jax_layout(cfg, 6, 2)))
    fit = engine.make_fit(model, 5, epochs=3, batch_size=8, n_train=16, n_val=8,
                          early_stop_threshold=0.0, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(24, 64, 800)).astype(np.float32), device=dev)
    y = torch.tensor(rng.integers(0, 5, 24), device=dev)
    perms = np.stack([rng.permutation(24) for _ in range(2)])
    carry = fit.run(fit.init_carry(perms[:, :16], perms[:, 16:], x, seed=0), x, y, until=1)
    assert bool(carry.stopped.all())
    snap = {k: (p.detach().clone(), carry.opt.state[p]["exp_avg"].clone(),
                carry.opt.state[p]["exp_avg_sq"].clone(), carry.best[k].clone())
            for k, p in carry.params.items()}
    before = _head_counts()
    fit.run(carry, x, y, until=3)
    assert _moved(before) == (0, 2 * (2 + 1), 0, 2 * 2, 0)
    for k, p in carry.params.items():
        got = (p.detach(), carry.opt.state[p]["exp_avg"], carry.opt.state[p]["exp_avg_sq"],
               carry.best[k])
        assert all(torch.equal(a, b) for a, b in zip(got, snap[k])), k
    assert all(np.isfinite(v).all() for v in fit.result(carry).history.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_tokens_on_the_card(dev, dtype):
    """``forward_head(x, step_override=25)`` (23 windows of 250) of one
    full-width model on the card: B2f once (f32), or B2f-bf16 in 5 groups
    of the windows its plan holds (bf16, counted in ``adapted``); the
    kernel's features against the plain version (f32 rtol 1e-4 / atol
    1e-5, bf16 3e-4 x max|ref|), forward_head's their cast; and
    ``batched_forward_head(micro_batch=8)`` over 32 trials equals one call
    bit for bit."""
    cfg = FASTConfig.default()
    model = FAST(cfg, device=dev).eval()
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, 8)))
    x = torch.tensor(np.random.default_rng(9).normal(size=(32, 64, 800)).astype(np.float32),
                     device=dev).to(dtype)
    with torch.no_grad():
        ops = model.head.fused_weights()
        before = _head_counts()
        feat = model.forward_head(x[:8], step_override=25)
        moved = _moved(before)
        assert moved == ((1, 0, 0, 0, 0) if dtype == torch.float32 else (0, 5, 0, 0, 1)), moved
        assert feat.shape == (8, 23, 8, 32) and feat.dtype == dtype
        out = fused_conv4_head(x[None, :8], *ops, 250, 25)
        assert torch.equal(out[0].to(dtype).view(feat.shape), feat)
        ref = fused_conv4_head_plain(x[None, :8], *ops, 250, 25)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
        else:
            _bf16_close(out, ref, 3e-4, "dense B2f-bf16")
        whole = model.forward_head(x, step_override=25)
    assert torch.equal(model.batched_forward_head(x, step=25, micro_batch=8), whole)


def test_bn_head_loso_and_sweep_on_the_card(dev, tmp_path):
    """CVBlock under LOSO and the sweep at tiny width in f32, dropout off
    (the head's too): the card against the CPU (loss and validation
    histories at rtol 1e-4 / atol 1e-5), no hand-written kernel launched,
    the running statistics in the fit, and two sweep rows of one (lr, wd)
    bit for bit alike on the card."""
    from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
    from imagined_speech_decoding_tpu_torch.models import heads
    from imagined_speech_decoding_tpu_torch.train import loso, sweep

    cfg = FASTConfig(electrodes=ELECTRODES, zone_dict=ZONES, seq_len=200, window_len=100,
                     slide_step=50, dim_cnn=8, dim_token=16, num_layers=1, num_heads=4,
                     dropout=0.0, head="CVBlock")
    X, Y = synthetic_corpus(0, 3, 10, 10, 200)
    subs = ["01", "02", "03"]
    kw = dict(epochs=2, batch_size=8, learning_rate=1e-3, warmup_epochs=0, verbose=False)
    drop = heads.CVBlockHead.DROPOUT
    heads.CVBlockHead.DROPOUT = 0.0
    try:
        before = _head_counts()
        _, res = loso.pretrain_loso(cfg, X, Y, subs, 5, str(tmp_path / "card"), device=dev,
                                    return_result=True, **kw)
        assert _moved(before) == (0,) * 5
        _, ref = loso.pretrain_loso(cfg, X, Y, subs, 5, str(tmp_path / "cpu"), device="cpu",
                                    return_result=True, **kw)
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(res.history[k], ref.history[k], rtol=1e-4, atol=1e-5)
        assert "head.bn1.mean" in res.model_state
        grid = dict(n_trials=10, lr_scales=[1.0, 1.0], n_folds=2, epochs=2, batch_size=8)
        card = sweep.cv_sweep(cfg, 5, X[0], Y[0], device=dev, **grid)
        cpu = sweep.cv_sweep(cfg, 5, X[0], Y[0], device="cpu", **grid)
    finally:
        heads.CVBlockHead.DROPOUT = drop
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(card.history[k], cpu.history[k], rtol=1e-4, atol=1e-5)
    for which in ("params", "model_state"):
        for k, v in getattr(card.fit, which).items():
            assert torch.equal(v[:2], v[2:]), (which, k)


def test_bn_head_rows_are_reproducible_on_the_card(dev, monkeypatch):
    """A bf16 CVBlock stack of 4 full-width models whose rows 2 and 3 repeat
    rows 0 and 1 (a sweep's two configs of one (lr, wd)), its first block
    in chunks (``CHUNK_ELEMS`` cut to 12 (model, zone) groups: equal chunks
    of one model, where the old rule cut 12, 12 and 8), one training step
    twice: under ``sweep.deterministic_convolutions`` the repeated rows'
    gradients and running statistics equal the first rows' and the second
    run equals the first, bit for bit. Without it, the largest differences
    are printed (cuDNN's default algorithms)."""
    import dataclasses as dc

    from imagined_speech_decoding_tpu_torch.models import heads
    from imagined_speech_decoding_tpu_torch.train.sweep import deterministic_convolutions, tile_rows
    from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout

    cfg = dc.replace(FASTConfig.default(), head="CVBlock", dropout=0.0)
    b = 16
    monkeypatch.setattr(heads.ZoneHead, "CHUNK_ELEMS", 12 * b * 5 * 8 * 15 * 251)
    monkeypatch.setattr(heads.CVBlockHead, "DROPOUT", 0.0)
    params, state = (tile_rows(t, 2) for t in init_jax_layout(cfg, 3, 2))
    x = torch.randn((2, b, 64, 800), generator=torch.Generator().manual_seed(4)).repeat(2, 1, 1, 1)
    x = x.to(dev, torch.bfloat16)

    def step():
        model = FAST(cfg, n_models=4, device=dev)
        model.load_state_dict(from_jax_params(params, state))
        model.train()(x).float().pow(2).sum().backward()
        return ({k: p.grad for k, p in model.named_parameters()},
                {k: v for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))})

    def parted(a, b_):
        return {k: float((a[k].float() - b_[k].float()).abs().max())
                for k in a if not torch.equal(a[k], b_[k])}

    g, _ = step()
    rows = parted({k: v[:2] for k, v in g.items()}, {k: v[2:] for k, v in g.items()})
    print("cuDNN defaults: repeated rows' gradients part by", rows)
    with deterministic_convolutions(dev):
        runs = [step() for _ in range(2)]
    for grads, stats in runs:
        for t in (grads, stats):
            for k, v in t.items():
                assert torch.equal(v[:2], v[2:]), k
    for a, b_ in zip(runs[0], runs[1]):
        assert not parted(a, b_)


@pytest.mark.parametrize("strategy", ["model", "data", "2d"])
def test_mesh_world_of_one_on_nccl_matches_the_unsharded_fit(dev, strategy):
    """``train_per_subject_cv`` under each strategy in a world of one rank
    over NCCL (the one card: NCCL takes no two ranks on one device) against
    the unsharded fit, at the JAX package's bounds for the strategy; the
    head kernels launch in the sharded fit."""
    import torch.distributed as dist

    from imagined_speech_decoding_tpu_torch.config import TrainConfig
    from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_trials
    from imagined_speech_decoding_tpu_torch.parallel.dryrun import dryrun_config
    from imagined_speech_decoding_tpu_torch.train.cv import train_per_subject_cv

    cfg = dryrun_config()
    tc = TrainConfig(max_epochs=3, batch_size=8, warmup_epochs=1, n_folds=3, precision="f32")
    x, y = synthetic_trials(0, 30, n_channels=cfg.n_channels, n_samples=cfg.seq_len, snr=3.0)
    X, Y = x.reshape(2, 15, cfg.n_channels, cfg.seq_len), y.reshape(2, 15)
    runs = {}
    for axis in (None, strategy):
        before = fused_conv4_head.launches
        runs[axis] = train_per_subject_cv(cfg, tc, X, Y, ["01", "02"], 5, device="cuda",
                                          verbose=False, mesh_axis=axis).fit
        torch.cuda.synchronize()
        assert fused_conv4_head.launches > before
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    rtol, atol = (5e-3, 1e-3) if strategy == "model" else (1e-3, 1e-5)
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(runs[strategy].history[k], runs[None].history[k], rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(runs[strategy].best_val_acc, runs[None].best_val_acc,
                               atol=1 / 5 + 1e-6)


def test_dryrun_multichip_on_nccl(dev):
    """The dry run's five sections on one rank a card, over NCCL."""
    from imagined_speech_decoding_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(torch.cuda.device_count())
    with pytest.raises(RuntimeError, match="cards"):
        dryrun_multichip(torch.cuda.device_count() + 1)
