"""Batched zero-phase IIR and FIR filtering over the trailing time axis, in PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/ops/filters.py``: filter
design stays host-side SciPy; application runs on the tensor's device.
The causal biquad cascade goes through ``ops.cuda.iir.sosfilt_time_major``
(kernel B1 on a CUDA tensor, its plain version on a CPU tensor), and
``sosfiltfilt`` reproduces ``scipy.signal.sosfiltfilt``'s defaults (odd
extension, ``sosfilt_zi`` seeding) with the JAX package's exact
trace-time machinery. ``filter_corpus`` is the preprocessing CLI's
notch and band-pass over a whole split, one B1 chain launch a split;
``bandpass_filter(method="iir")`` and ``notch_filter`` are one-filter
chains. ``lfilter`` / ``filtfilt`` are the direct-form II transposed
recurrence of any order, a loop over time (the JAX ``lax.scan``), and
``fir_filter`` one f32 convolution (``F.conv1d``, TF32 off: the JAX
function convolves at ``Precision.HIGHEST``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.constants import SFREQ
from .cuda.iir import default_padlen, prepare_filter, sosfilt_time_major, sosfiltfilt_chain


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


def lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi: Optional[torch.Tensor] = None):
    """Causal IIR/FIR filter over the trailing axis of ``x (..., T)``, Direct
    Form II transposed, one step a sample (the JAX ``lax.scan``). ``b`` /
    ``a`` are 1-D coefficients (``a[0]`` is normalised away in f64, then
    both are rounded to x's dtype); ``zi (..., K)``, ``K = max(len(a),
    len(b)) - 1``, is the initial state. Returns ``y``, or ``(y, zf)`` when
    ``zi`` is given, as ``scipy.signal.lfilter``."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    k = max(len(a), len(b)) - 1
    bt = torch.as_tensor(np.pad(b / a[0], (0, k + 1 - len(b))), dtype=x.dtype, device=x.device)
    at = torch.as_tensor(np.pad(a / a[0], (0, k + 1 - len(a))), dtype=x.dtype, device=x.device)
    batch_shape = x.shape[:-1]
    if zi is None:
        z = x.new_zeros(batch_shape + (k,))
    else:
        z = torch.broadcast_to(zi.to(x.dtype), batch_shape + (k,))
    tail = x.new_zeros(batch_shape + (1,))
    ys = []
    for n in range(x.shape[-1]):
        xn = x[..., n]
        yn = bt[0] * xn + z[..., 0]
        # z_i' = b_{i+1} x - a_{i+1} y + z_{i+1}   (z_K taken as 0)
        z = bt[1:] * xn[..., None] - at[1:] * yn[..., None] + torch.cat([z[..., 1:], tail], -1)
        ys.append(yn)
    y = torch.stack(ys, dim=-1)
    return y if zi is None else (y, z)


def filtfilt(b: np.ndarray, a: np.ndarray, x: torch.Tensor,
             padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase forward-backward ``lfilter`` = ``scipy.signal.filtfilt``
    defaults: odd extension by ``padlen`` (default ``3 * max(len(a),
    len(b))``) and ``lfilter_zi`` steady-state initial conditions."""
    from scipy.signal import lfilter_zi  # host-side design only

    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    if padlen is None:
        padlen = 3 * max(len(a), len(b))
    zi = torch.as_tensor(np.asarray(lfilter_zi(b, a), np.float64), dtype=x.dtype, device=x.device)
    ext = _odd_ext(x, padlen)
    y, _ = lfilter(b, a, ext, zi=zi * ext[..., :1])
    y = torch.flip(y, dims=(-1,))
    y, _ = lfilter(b, a, y, zi=zi * y[..., :1])
    y = torch.flip(y, dims=(-1,))
    return y[..., padlen : y.shape[-1] - padlen] if padlen > 0 else y


@contextlib.contextmanager
def _cudnn_tf32_off():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def fir_filter(taps: np.ndarray, x: torch.Tensor, zero_phase: bool = True) -> torch.Tensor:
    """A linear-phase FIR filter over the trailing axis of ``x (..., T)`` as
    one batched convolution. ``zero_phase=True`` compensates the group
    delay: a centred convolution over the signal edge-reflected (numpy's
    ``reflect``; each side's pad must be shorter than the signal), the MNE
    ``filter_data`` application; else causal, zero-padded in front. The
    taps are rounded to x's dtype; f32 runs without TF32."""
    taps = np.asarray(taps, np.float64)
    n = len(taps)
    t = x.shape[-1]
    flat = x.reshape(-1, 1, t)
    if zero_phase:
        flat = F.pad(flat, ((n - 1) // 2, n - 1 - (n - 1) // 2), mode="reflect")
    else:
        flat = F.pad(flat, (n - 1, 0))
    kern = torch.as_tensor(taps[::-1].copy(), dtype=x.dtype, device=x.device).view(1, 1, n)
    with _cudnn_tf32_off():
        y = F.conv1d(flat, kern)
    return y.reshape(x.shape)


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


def corpus_filters(sfreq: float, notch: Optional[float] = None,
                   bandpass: Optional[Sequence[float]] = None) -> list:
    """The preprocessing CLI's zero-phase stages, prepared for
    ``sosfiltfilt_chain``: the ``notch`` Hz notch (``iirnotch``, Q 30) as
    one second-order section with ``filtfilt``'s default padlen,
    ``3 * max(len(a), len(b))`` = 9, then the order-4 Butterworth
    ``bandpass`` with ``sosfiltfilt``'s. Either may be None."""
    from scipy.signal import tf2sos

    filters = []
    if notch is not None:
        b, a = notch_ba(sfreq, notch)
        filters.append(prepare_filter(tf2sos(b, a), padlen=3 * max(len(a), len(b))))
    if bandpass is not None:
        filters.append(prepare_filter(butter_sos(sfreq, bandpass[0], bandpass[1])))
    return filters


def filter_corpus(x: torch.Tensor, notch: Optional[float] = None,
                  bandpass: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Notch, then band-pass, each zero-phase, over the trailing time axis
    of ``x (N, C, T)`` sampled at ``SFREQ``: the counterpart of the JAX
    preprocessing CLI's ``filtfilt(notch)`` then ``sosfiltfilt(band-pass)``.
    Both stages run in one ``sosfiltfilt_chain`` launch (kernel B1 on a
    CUDA tensor, its plain version on a CPU tensor). With neither stage
    ``x`` comes back as it is."""
    filters = corpus_filters(SFREQ, notch, bandpass)
    return sosfiltfilt_chain(filters, x) if filters else x


def mne_style_fir_taps(
    sfreq: float,
    l_freq: Optional[float],
    h_freq: Optional[float],
    l_trans_bandwidth: Optional[float] = None,
    h_trans_bandwidth: Optional[float] = None,
) -> np.ndarray:
    """A windowed-sinc (hamming) FIR band-pass with MNE ``filter_data``'s
    default geometry: transition bandwidths ``min(max(f * 0.25, 2), f)``
    (low) and ``min(max(f * 0.25, 2), nyq - f)`` (high), length ``3.3 /
    min(transition) * sfreq`` rounded to odd, and ``l_freq`` / ``h_freq``
    as the passband edges: the -6 dB points sit half a transition outside
    them, so ``firwin`` gets the shifted cutoffs."""
    from scipy.signal import firwin

    nyq = sfreq / 2.0
    lt = ht = None
    if l_freq is not None:
        lt = l_trans_bandwidth or min(max(l_freq * 0.25, 2.0), l_freq)
    if h_freq is not None:
        ht = h_trans_bandwidth or min(max(h_freq * 0.25, 2.0), nyq - h_freq)
    trans = min(w for w in (lt, ht) if w is not None)
    n = int(round(3.3 / trans * sfreq))
    n |= 1  # odd length: exact zero phase
    if l_freq is not None and h_freq is not None:
        return firwin(n, [l_freq - lt / 2.0, h_freq + ht / 2.0], fs=sfreq, pass_zero=False,
                      window="hamming")
    if h_freq is not None:
        return firwin(n, h_freq + ht / 2.0, fs=sfreq, pass_zero=True, window="hamming")
    return firwin(n, l_freq - lt / 2.0, fs=sfreq, pass_zero=False, window="hamming")


def bandpass_filter(x: torch.Tensor, sfreq: float, l_freq: Optional[float],
                    h_freq: Optional[float], method: str = "iir", order: int = 4) -> torch.Tensor:
    """Zero-phase band-pass over the trailing axis, batched.
    ``method="iir"``: the Butterworth sections, ``sosfiltfilt``'s defaults,
    as one ``sosfiltfilt_chain`` launch (kernel B1 on a CUDA tensor).
    ``method="fir"``: ``mne_style_fir_taps`` through ``fir_filter``."""
    if method == "iir":
        return sosfiltfilt_chain([prepare_filter(butter_sos(sfreq, l_freq, h_freq, order))], x)
    if method == "fir":
        return fir_filter(mne_style_fir_taps(sfreq, l_freq, h_freq), x, zero_phase=True)
    raise ValueError(f"unknown method {method!r}")


def notch_filter(x: torch.Tensor, sfreq: float, freq: float = 60.0, q: float = 30.0) -> torch.Tensor:
    """Zero-phase power-line notch over the trailing axis, batched: the JAX
    function's ``filtfilt`` of ``iirnotch(freq, q)``, as one second-order
    section with ``filtfilt``'s padlen in one ``sosfiltfilt_chain`` launch
    (kernel B1 on a CUDA tensor), as ``filter_corpus`` runs its notch."""
    from scipy.signal import tf2sos

    b, a = notch_ba(sfreq, freq, q)
    return sosfiltfilt_chain([prepare_filter(tf2sos(b, a), padlen=3 * max(len(a), len(b)))], x)
