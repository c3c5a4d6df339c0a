"""Biquad-cascade IIR over a time-major ``(T, R)`` array: CUDA kernel B1
and its plain PyTorch version.

Replaces ``imagined_speech_decoding_tpu/ops/pallas/iir.py``
(``sosfilt_time_major``, kernel body ``_make_kernel``). The kernel source
is ``csrc/iir.cu``; its header says what bounds it on the H100 and what
the design does about that. ``ops.filters.sosfilt`` calls
``sosfilt_time_major``, so ``sosfiltfilt`` on a CUDA tensor runs both
passes through the kernel.

Routing: a CPU tensor goes to ``sosfilt_time_major_plain``; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _lib

KERNEL_SECTIONS = (1, 4)  # section counts csrc/iir.cu is instantiated for


def coefficients(sos: np.ndarray) -> np.ndarray:
    """``(S, 6)`` scipy sections, a0-normalised in f64, then rounded to
    f32 — the constants both the scan path and the Pallas kernel use."""
    sos = np.asarray(sos, np.float64)
    return np.ascontiguousarray(sos / sos[:, 3:4], dtype=np.float32)


def sosfilt_time_major_plain(
    sos: np.ndarray, xt: torch.Tensor, zi: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: one step over all rows per
    time sample, the same DF-II-transposed update order as
    ``ops.filters.sosfilt`` in the JAX package. Runs on any device."""
    coef = [[float(c) for c in row] for row in coefficients(sos)]
    t_len, rows = xt.shape
    if zi is None:
        zi = xt.new_zeros((2 * len(coef), rows))
    z = list(zi.to(xt.dtype).unbind(0))
    y = torch.empty_like(xt)
    for t in range(t_len):
        out = xt[t]
        for s, (b0, b1, b2, _, a1, a2) in enumerate(coef):
            v = b0 * out + z[2 * s]
            z[2 * s] = b1 * out - a1 * v + z[2 * s + 1]
            z[2 * s + 1] = b2 * out - a2 * v
            out = v
        y[t] = out
    return y, torch.stack(z)


def sosfilt_time_major(
    sos: np.ndarray, xt: torch.Tensor, zi: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal biquad cascade over axis 0 of ``xt (T, R)``.

    ``zi (2S, R)`` holds the initial section states (zeros when None),
    row ``2s + j`` being state ``j`` of section ``s``. Returns ``(y (T, R),
    zf (2S, R))``, ``zf`` the final states for chunked continuation.
    """
    coef = coefficients(sos)
    n_sections = coef.shape[0]
    t_len, rows = xt.shape
    if zi is None:
        zi = xt.new_zeros((2 * n_sections, rows))
    if xt.device.type == "cpu":
        return sosfilt_time_major_plain(sos, xt, zi)

    if n_sections not in KERNEL_SECTIONS:
        raise ValueError(f"the kernel is built for S in {KERNEL_SECTIONS}, got S={n_sections}")
    _lib.require_cuda_f32("xt", xt)
    _lib.require_cuda_f32("zi", zi, (2 * n_sections, rows))
    if zi.device != xt.device:
        raise ValueError(f"zi is on {zi.device}, xt on {xt.device}")
    _lib.require_no_grad("the IIR kernel", xt, zi)
    y = torch.empty_like(xt)
    zf = torch.empty_like(zi)
    lib = _lib.library()
    with torch.cuda.device(xt.device):
        code = lib.isd_sosfilt_time_major(
            xt.data_ptr(), zi.data_ptr(), y.data_ptr(), zf.data_ptr(),
            coef.ctypes.data, n_sections, t_len, rows, _lib.stream_of(xt),
        )
    _lib.check(code, "isd_sosfilt_time_major")
    sosfilt_time_major.launches += 1
    return y, zf


sosfilt_time_major.launches = 0  # kernel launches; the CPU route does not count
