"""B2f's tensor-core route, emulated on the CPU, against the JAX package.

Kernel B2f (``csrc/conv4head.cu``) computes each (trial, window, zone) as
three GEMMs with one side O = 32 (``conv_tc`` in ``csrc/conv4head_tc.cuh``):
h1 = w12z . im2col(window) + b12z over K * Cp, then the two 'same' convs
over K * O, exact GELU and the mean over t1. Every product is 3xTF32: each
f32 operand is split into hi (its low 13 mantissa bits cleared) and lo =
v - hi, which the tensor core reads truncated to TF32 as well; per
reduction step of 8, lo*hi, hi*lo and hi*hi go into f32 accumulators and
lo*lo is dropped (``csrc/mma_tf32.cuh``). The channels are padded from C
to Cp = C rounded up to 8, with zero rows in the window and zero columns
in w12, so a step of 8 never straddles two taps; time runs to whole
8-column tiles, and the epilogues write zeros past t1.

This file emulates exactly that in f32 on the CPU, at full width, and
holds it against the JAX package's ``fused_conv4_head`` (the Pallas
kernel in interpret mode) at ``chip_smoke.py``'s tolerance for B2f:
rtol 1e-4, atol 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from tf32_emulation import mma

torch.set_num_threads(1)

HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-5  # chip_smoke.py's B2f tolerance
Z, O, K, T, W, STEP = 8, 32, 5, 800, 250, 125  # FASTConfig.default() widths
N, T1 = (T - W) // STEP + 1, W - K + 1
NT8 = -(-T1 // 8) * 8


def im2col(rows: torch.Tensor) -> torch.Tensor:
    """``P[k * R + c, t] = rows[c, t + k]`` for t < NT8 (tap-major)."""
    return torch.cat([rows[:, k:k + NT8] for k in range(K)])


def b2f_emulated(xw, w12z, b12z, w3z, w4z, passes: int = 3, pad: bool = True) -> torch.Tensor:
    """One (trial, window, zone) on B2f's route: xw (C, W) -> (O,)."""
    c = xw.shape[0]
    cp = -(-c // 8) * 8 if pad else c
    xs = torch.zeros((cp, NT8 + K - 1))  # the window from column 0, zero rows and columns after
    xs[:c, :W] = xw
    w12p = torch.zeros((O, K, cp))
    w12p[:, :, :c] = w12z.view(O, K, c)
    live = torch.arange(NT8) < T1  # the epilogues' zeros past t1

    def same_conv(h, w):  # h (O, NT8), zero past t1: stored from column K/2, zeros around
        hp = torch.nn.functional.pad(h, (K // 2, K // 2))
        return mma(w, im2col(hp), passes)

    h1 = torch.where(live, mma(w12p.view(O, K * cp), im2col(xs), passes) + b12z[:, None], 0.0)
    h2 = torch.where(live, same_conv(h1, w3z), 0.0)
    g3 = torch.where(live, torch.nn.functional.gelu(same_conv(h2, w4z)), 0.0)
    return g3.sum(1) / T1


def _operands(c: int, seed: int):
    """x (1, C, T) and one model's head operands, seeded normal, at the
    scales of a trained head (unit-variance activations)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return (f32(1, c, T), f32(Z * O, K * c) / math.sqrt(K * c), 0.1 * f32(Z * O, 1),
            f32(Z, O, K * O) / math.sqrt(K * O), f32(Z, O, K * O) / math.sqrt(K * O))


@pytest.fixture(scope="module", params=[64, 10], ids=["C64", "C10"])
def head(request):
    """The operands at C channels and the JAX package's output for them."""
    ops = _operands(request.param, request.param)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_head(*(jnp.asarray(a) for a in ops), W, STEP)
    return [torch.from_numpy(a) for a in ops], np.asarray(ref)[0].reshape(N, Z, O)


def _unit(ops, n, z):
    x, w12, b12, w3, w4 = ops
    return (x[0, :, n * STEP:n * STEP + W], w12[z * O:(z + 1) * O], b12[z * O:(z + 1) * O, 0],
            w3[z], w4[z])


@pytest.mark.parametrize("n,z", [(0, 0), (2, 5), (4, 7)])
def test_three_tf32_passes_match_jax(head, n, z):
    """Worst element of all 40 (window, zone) units at 0.013 of its
    tolerance, at C = 64 and at C = 10."""
    ops, ref = head
    got = b2f_emulated(*_unit(ops, n, z))
    np.testing.assert_allclose(got.numpy(), ref[n, z], rtol=HEAD_RTOL, atol=HEAD_ATOL)


def test_one_tf32_pass_does_not(head):
    """A single TF32 pass (hi*hi) misses the tolerance by far (29 times
    it, worst of all 40 units): the reason for three."""
    ops, ref = head
    got = b2f_emulated(*_unit(ops, 2, 5), passes=1)
    tol = HEAD_ATOL + HEAD_RTOL * np.abs(ref[2, 5])
    assert np.max(np.abs(got.numpy() - ref[2, 5]) / tol) > 5.0


def test_channel_padding_changes_nothing():
    """At C = 10 the padded route (Cp = 16) and an unpadded one (steps of 8
    straddling taps) agree to f32 rounding: the zero rows and columns
    only add exact zeros."""
    ops = [torch.from_numpy(a) for a in _operands(10, 3)]
    unit = _unit(ops, 1, 3)
    padded, unpadded = b2f_emulated(*unit), b2f_emulated(*unit, pad=False)
    np.testing.assert_allclose(padded.numpy(), unpadded.numpy(), rtol=1e-6, atol=1e-7)
    assert not torch.equal(padded, b2f_emulated(*unit, passes=1))
