"""Batched zero-phase IIR filtering over the trailing time axis, in PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/ops/filters.py``: filter
design stays host-side SciPy; application runs on the tensor's device.
The causal biquad cascade goes through ``ops.cuda.iir.sosfilt_time_major``
(kernel B1 on a CUDA tensor, its plain version on a CPU tensor), and
``sosfiltfilt`` reproduces ``scipy.signal.sosfiltfilt``'s defaults (odd
extension, ``sosfilt_zi`` seeding) with the JAX package's exact
trace-time machinery.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .cuda.iir import default_padlen, sosfilt_time_major


def sosfilt(
    sos: np.ndarray,
    x: torch.Tensor,
    zi: Optional[torch.Tensor] = None,
    *,
    time_major: Callable = sosfilt_time_major,
):
    """Causal biquad-cascade filter over the trailing axis of ``x (..., T)``.

    ``sos``: ``(S, 6)`` scipy sections. ``zi``: optional initial state
    ``(..., S, 2)``. Returns ``y``, or ``(y, zf)`` with the final states
    ``(..., S, 2)`` when ``zi`` is given. ``time_major`` is the causal
    backend over ``(T, R)``; tests and the chip smoke pass the plain
    version to hold the kernel against it.
    """
    batch_shape = x.shape[:-1]
    t_len = x.shape[-1]
    n_sections = np.asarray(sos).shape[0]
    xt = x.reshape(-1, t_len).t().contiguous()  # (T, R)
    zi_t = None
    if zi is not None:
        zi_b = torch.broadcast_to(zi.to(x.dtype), batch_shape + (n_sections, 2))
        zi_t = zi_b.reshape(-1, 2 * n_sections).t().contiguous()  # (2S, R)
    yt, zf_t = time_major(sos, xt, zi_t)
    y = yt.t().reshape(batch_shape + (t_len,))
    if zi is None:
        return y
    return y, zf_t.t().reshape(batch_shape + (n_sections, 2))


def _odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension of the trailing axis by ``n`` samples on both ends.

    Raises like SciPy when the signal is too short — the reversed slices
    would silently truncate and corrupt the filtfilt output otherwise.
    """
    if n < 1:
        return x
    if x.shape[-1] <= n:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen, "
            f"which is {n} (got {x.shape[-1]} samples)"
        )
    left = 2 * x[..., :1] - torch.flip(x[..., 1 : n + 1], dims=(-1,))
    right = 2 * x[..., -1:] - torch.flip(x[..., -(n + 1) : -1], dims=(-1,))
    return torch.cat([left, x, right], dim=-1)


def sos_zero_phase(
    sosfilt_fn, sos: np.ndarray, x: torch.Tensor, padlen: Optional[int] = None
) -> torch.Tensor:
    """SciPy-default ``sosfiltfilt`` machinery (padlen formula, odd
    extension, ``sosfilt_zi`` seeding, forward-backward flips),
    parameterised on the causal backend ``sosfilt_fn(sos, x, zi) -> (y, zf)``
    exactly like the JAX package's ``filters.sos_zero_phase``."""
    from scipy.signal import sosfilt_zi  # host-side design only

    sos = np.asarray(sos, np.float64)
    if padlen is None:
        padlen = default_padlen(sos)
    zi = torch.as_tensor(np.asarray(sosfilt_zi(sos), np.float64), dtype=x.dtype, device=x.device)
    return zero_phase(sosfilt_fn, sos, x, padlen, zi)


def zero_phase(sosfilt_fn, sos: np.ndarray, x: torch.Tensor, padlen: int,
               zi: torch.Tensor) -> torch.Tensor:
    """The forward-backward passes of ``sos_zero_phase`` with ``padlen``
    and the steady-state ``zi (S, 2)`` already known (``ops.cuda.iir``'s
    prepared filters bring both)."""
    ext = _odd_ext(x, padlen)
    y, _ = sosfilt_fn(sos, ext, zi * ext[..., :1, None])
    y = torch.flip(y, dims=(-1,))
    y, _ = sosfilt_fn(sos, y, zi * y[..., :1, None])
    y = torch.flip(y, dims=(-1,))
    return y[..., padlen : y.shape[-1] - padlen] if padlen > 0 else y


def sosfiltfilt(
    sos: np.ndarray,
    x: torch.Tensor,
    padlen: Optional[int] = None,
    *,
    time_major: Callable = sosfilt_time_major,
) -> torch.Tensor:
    """Zero-phase biquad-cascade filter = ``scipy.signal.sosfiltfilt`` defaults."""
    return sos_zero_phase(
        lambda s, v, zi: sosfilt(s, v, zi=zi, time_major=time_major), sos, x, padlen
    )


def butter_sos(
    sfreq: float, l_freq: Optional[float], h_freq: Optional[float], order: int = 4
) -> np.ndarray:
    """Design a Butterworth band/low/high-pass as second-order sections."""
    from scipy.signal import butter

    nyq = sfreq / 2.0
    if l_freq is not None and h_freq is not None:
        return butter(order, [l_freq / nyq, h_freq / nyq], btype="bandpass", output="sos")
    if h_freq is not None:
        return butter(order, h_freq / nyq, btype="lowpass", output="sos")
    if l_freq is not None:
        return butter(order, l_freq / nyq, btype="highpass", output="sos")
    raise ValueError("need at least one of l_freq / h_freq")


def notch_ba(sfreq: float, freq: float, q: float = 30.0) -> Tuple[np.ndarray, np.ndarray]:
    """Design an IIR notch (``scipy.signal.iirnotch``)."""
    from scipy.signal import iirnotch

    return iirnotch(freq, q, fs=sfreq)
