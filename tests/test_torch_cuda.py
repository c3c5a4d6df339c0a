"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; every test skips without a card. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    fused_conv4_head,
    fused_conv4_head_plain,
)
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    sosfilt_time_major,
    sosfilt_time_major_plain,
)
from imagined_speech_decoding_tpu_torch.ops.filters import butter_sos, sosfiltfilt
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


# butter_sos(order=N) band-pass has N sections; the kernel exists for S = 1 and 4.
@pytest.mark.parametrize("rows,t_len,order", [(1, 50, 4), (111, 300, 4), (4096, 64, 1)])
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
        ops = model.head.prepare_fused_weights()
        before = fused_conv4_head.launches
        out = fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step)
        torch.cuda.synchronize()
        assert fused_conv4_head.launches == before + 1
        ref = fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


def test_head_kernel_refuses_autograd(dev):
    cfg = FASTConfig.default()
    model = FAST(cfg, device=dev)
    x = torch.zeros((1, 64, 800), device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        model.forward_head(x)


def test_head_kernel_rejects_cpu_operands_on_cuda_input(dev):
    cfg = FASTConfig.default()
    model = FAST(cfg)
    ops = model.head.prepare_fused_weights()
    x = torch.zeros((1, 64, 800), device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step)
