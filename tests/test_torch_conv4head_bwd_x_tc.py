"""B2x's tensor-core route, emulated on the CPU, against the JAX package.

Kernel B2x (``conv4head_bwd_x_kernel`` in ``csrc/conv4head_bwd.cu``)
computes each (trial, window, zone) as six GEMMs: B2w's recompute of h1,
h2 and h3, dh3 = g / t1 * gelu'(h3), the two transposed 'same' convs to
dh2 and dh1 (``conv_tc``), and the input gradient ``input_grad_tc``:
dxw[c, w] = sum_{k, o} w12z[o, k*C + c] * dh1[o, w - k] over the window's
W columns rounded up to 8, with dh1 stored from column K - 1 between zeros.
Every product is 3xTF32: each f32 operand is split into hi (its low 13
mantissa bits cleared) and lo = v - hi, which the tensor core reads
truncated to TF32 as well; per reduction step of 8, lo*hi, hi*lo and hi*hi
go into f32 accumulators (``csrc/mma_tf32.cuh``). The channels are padded
from C to Cp = C rounded up to 32, with zero rows in the window and zero
columns in w12. A block adds its zones' gradients into its window's slice
in zone order (the first writes); with SZ zone ranges a fixed-order pass
sums the SZ partials; the wrapper overlap-adds the windows in order.

This file emulates exactly that in f32 on the CPU and holds it against
``jax.grad`` w.r.t. x of the JAX package's ``fused_conv4_head`` (its
Pallas kernels in interpret mode) at ``chip_smoke.py``'s tolerance for
B2x: rtol 1e-4, atol 1e-4 * max|ref|.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from tf32_emulation import im2col, mma

torch.set_num_threads(1)

BWD_RTOL = 1e-4  # atol = BWD_RTOL * max|ref| (chip_smoke.py)
O, K = 32, 5
FULL = dict(c=64, z=8, t=800, window=250, step=125)  # FASTConfig.default() widths
SMALL = dict(c=10, z=3, t=230, window=120, step=37)  # t1 = 116: not a multiple of 8


def b2x_emulated(g, x, w12, b12, w3, w4, window, step, sz=1, passes=3):
    """dx (B, C, T) on B2x's route: g (B, N, Z*O), x (B, C, T), one model's
    operands; ``sz`` zone ranges per window."""
    b, c, t = x.shape
    z = w3.shape[0]
    n = (t - window) // step + 1
    t1 = window - K + 1
    nt8 = -(-t1 // 8) * 8
    wp = -(-window // 8) * 8
    cp = -(-c // 32) * 32
    live = torch.arange(nt8) < t1  # the epilogues' zeros past t1
    # The windows, from column 0 with zero rows C..Cp-1 and zeros after W: (B, N, 1, Cp, nt8 + K - 1)
    xs = torch.zeros((b, n, 1, cp, nt8 + K - 1))
    for i in range(n):
        xs[:, i, 0, :c, :window] = x[..., i * step:i * step + window]
    w12p = torch.zeros((z, O, K, cp))
    w12p[..., :c] = w12.view(z, O, K, c)
    w12p = w12p.view(z, O, K * cp)
    gz = g.view(b, n, z, O, 1) / t1

    def same(h):  # an activation (O, nt8), zero past t1, stored from column K/2 between zeros
        return torch.nn.functional.pad(h, (K // 2, K // 2))

    forward_taps, transposed_taps = range(K), range(K - 1, -1, -1)
    h1 = mma(w12p, im2col(xs, nt8, forward_taps), passes) + b12.view(z, O, 1)
    h1 = torch.where(live, h1, 0.0)
    h2 = torch.where(live, mma(w3, im2col(same(h1), nt8, forward_taps), passes), 0.0)
    h3 = mma(w4, im2col(same(h2), nt8, forward_taps), passes)
    dh3 = torch.where(live, gz * (torch.special.ndtr(h3) + h3 * torch.exp(-0.5 * h3 * h3)
                                  / math.sqrt(2 * math.pi)), 0.0)

    def transposed(w):  # A[o, k*O + o'] = w[o', k*O + o]
        return w.view(z, O, K, O).permute(0, 3, 2, 1).reshape(z, O, K * O)

    dh2 = torch.where(live, mma(transposed(w4), im2col(same(dh3), nt8, transposed_taps), passes),
                      0.0)
    dh1 = torch.where(live, mma(transposed(w3), im2col(same(dh2), nt8, transposed_taps), passes),
                      0.0)
    # dh1 from column K - 1, zeros up to column K - 1 + wp; A[c, k*O + o] = w12z[o, k*Cp + c]
    dh1x = torch.nn.functional.pad(dh1, (K - 1, wp - nt8))
    a_dx = w12p.view(z, O, K, cp).permute(0, 3, 2, 1).reshape(z, cp, K * O)
    dxu = mma(a_dx, im2col(dh1x, wp, transposed_taps), passes)[..., :c, :window]  # (B, N, Z, C, W)
    parts = []
    for zs in range(sz):  # each block: its zones in order, the first writes
        z0, z1 = zs * z // sz, (zs + 1) * z // sz
        acc = dxu[:, :, z0]
        for zi in range(z0 + 1, z1):
            acc = acc + dxu[:, :, zi]
        parts.append(acc)
    dxw = parts[0] if sz == 1 else torch.zeros_like(parts[0])
    if sz > 1:  # the fixed-order pass over the partials
        for p in parts:
            dxw = dxw + p
    dx = torch.zeros_like(x)
    for i in range(n):
        dx[..., i * step:i * step + window] += dxw[:, i]
    return dx


def _operands(geo, batch: int, seed: int):
    """x (B, C, T), one model's head operands at the scales of a trained
    head (unit-variance activations), and a cotangent g (B, N, Z*O)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    c, z, t = geo["c"], geo["z"], geo["t"]
    n = (t - geo["window"]) // geo["step"] + 1
    return (f32(batch, n, z * O), f32(batch, c, t), f32(z * O, K * c) / math.sqrt(K * c),
            0.1 * f32(z * O, 1), f32(z, O, K * O) / math.sqrt(K * O),
            f32(z, O, K * O) / math.sqrt(K * O))


@pytest.fixture(scope="module", params=["full", "small"])
def case(request):
    """Operands at full width (B = 2) or at C = 10 (B = 2), and JAX's dx."""
    geo = FULL if request.param == "full" else SMALL
    g, x, *weights = _operands(geo, 2, 7 if request.param == "full" else 8)
    wj = [jnp.asarray(w) for w in weights]

    def loss(xx):
        return jnp.sum(pallas_head(xx, *wj, geo["window"], geo["step"]) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    return geo, [torch.from_numpy(a) for a in (g, x, *weights)], ref


@pytest.mark.parametrize("sz", [1, 2, 8])
def test_three_tf32_passes_match_jax(case, sz):
    """B2x's route with one, two and eight zone ranges a window (at most
    one a zone: three at C = 10)."""
    geo, ops, ref = case
    got = b2x_emulated(*ops, geo["window"], geo["step"], sz=min(sz, geo["z"]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=BWD_RTOL,
                               atol=BWD_RTOL * np.abs(ref).max())


def test_one_tf32_pass_does_not(case):
    """A single TF32 pass (hi*hi) misses the tolerance by far (13.7 and 15
    times it at full width and at C = 10; three passes reach 0.008 of it):
    the reason for three."""
    geo, ops, ref = case
    got = b2x_emulated(*ops, geo["window"], geo["step"], passes=1).numpy()
    tol = BWD_RTOL * (np.abs(ref).max() + np.abs(ref))
    assert np.max(np.abs(got - ref) / tol) > 5.0
