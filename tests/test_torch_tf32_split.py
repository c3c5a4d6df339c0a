"""The numerics B2w rests on, checked on the CPU: splitting each f32
operand into two TF32 halves and summing lo*hi + hi*lo + hi*hi (3xTF32)
keeps a weight-gradient product within the card's tolerance of the
exact product, and a single TF32 pass (hi*hi) does not.

The split is the kernel's (``csrc/mma_tf32.cuh``): hi is the operand with
its low 13 mantissa bits cleared, lo = v - hi, and the tensor core reads
lo with its low 13 bits ignored, so both halves are truncated to TF32
here. The product is dw12's, at B2w's real reduction length: dh1
(O = 32, 246 steps) against the window's im2col (K * C = 320 rows),
summed over 64 trials. As in the kernel, each trial's product is one f32
accumulation and the trials are added in f32. The tolerance is
``chip_smoke.py``'s for the backward kernels: rtol 1e-4, atol
1e-4 * max|ref|.
"""

import numpy as np
import pytest
import torch

from tf32_emulation import split, to_tf32

torch.set_num_threads(1)

BWD_RTOL = 1e-4  # chip_smoke.py: atol = BWD_RTOL * max|ref| per gradient tensor
O, T1, KC, TRIALS = 32, 246, 320, 64


def tolerance_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst element's error over its tolerance (<= 1 passes)."""
    tol = BWD_RTOL * ref.abs() + BWD_RTOL * ref.abs().max()
    return float(((got.double() - ref).abs() / tol).max())


def test_tf32_truncation_keeps_the_top_19_bits():
    one_ulp = 2.0 ** -10  # TF32's spacing on [1, 2)
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp - 2.0 ** -23, -(1.0 + 1.5 * one_ulp),
                      1.0 + one_ulp, 3.0e-3], dtype=torch.float32)
    got = to_tf32(x)
    assert got[:5].tolist() == [1.0, 1.0, 1.0, -(1.0 + one_ulp), 1.0 + one_ulp]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert 0 <= float(x[5] - got[5]) < 2.0 ** -10 * 3.0e-3
    hi, lo = split(x)
    assert (hi + lo - x).abs().max() <= 2.0 ** -20 * x.abs().max()


@pytest.fixture(scope="module")
def dw12_operands():
    """dh1 (trials, O, t1) and the im2col of the window (trials, t1, K*C),
    seeded normal f32, and their product over all trials in f64."""
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.normal(size=(TRIALS, O, T1)).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(TRIALS, T1, KC)).astype(np.float32))
    ref = torch.einsum("bot,btr->or", d.double(), p.double())
    return d, p, ref


def _per_trial_f32(pairs):
    """sum over trials (in f32) of each trial's f32 sum of the products."""
    out = torch.zeros((O, KC), dtype=torch.float32)
    for b in range(TRIALS):
        acc = torch.zeros((O, KC), dtype=torch.float32)
        for a, p in pairs:
            acc += a[b] @ p[b]
        out += acc
    return out


def test_three_tf32_passes_hold_the_tolerance(dw12_operands):
    """Worst element at 0.0038 of its tolerance (plain f32: 0.0028)."""
    d, p, ref = dw12_operands
    (dh, dl), (ph, pl) = split(d), split(p)
    got = _per_trial_f32([(dl, ph), (dh, pl), (dh, ph)])
    assert tolerance_share(got, ref) < 0.01


def test_one_tf32_pass_does_not(dw12_operands):
    """Worst element at 4.3 times its tolerance."""
    d, p, ref = dw12_operands
    dh, ph = to_tf32(d), to_tf32(p)
    got = _per_trial_f32([(dh, ph)])
    assert tolerance_share(got, ref) > 2.0
