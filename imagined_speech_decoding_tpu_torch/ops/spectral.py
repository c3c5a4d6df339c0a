"""Spectral features over the trailing time axis: STFT, Welch PSD, band
powers, filter banks.

Counterpart of ``imagined_speech_decoding_tpu/ops/spectral.py``, with the
same SciPy defaults (``scipy.signal.stft``: zero boundary, padded,
``scaling='spectrum'``; ``scipy.signal.welch``: Hann window, 50% overlap,
constant detrend, one-sided density, and its clamp of ``nperseg`` and its
``ValueError`` for ``noverlap >= nperseg``). Frames are ``unfold`` views,
the FFT is ``torch.fft.rfft`` (pocketfft on the CPU, cuFFT on the card),
and the periodic Hann window is built in numpy, as the JAX ``_hann``.
Frequencies and times come back as numpy arrays, the spectra as tensors
on x's device.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Canonical EEG bands (reference: scripts/global_shap_analysis.py band map).
BANDS: Dict[str, Tuple[float, float]] = {
    "Delta": (0.5, 4.0),
    "Theta": (4.0, 8.0),
    "Alpha": (8.0, 13.0),
    "Beta": (13.0, 30.0),
    "Gamma": (30.0, 45.0),
}


def _hann(n: int) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', n)``)."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def _windowed_rfft(frames: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """``rfft`` of ``frames (..., nperseg)`` times the window, rounded to
    the frames' dtype."""
    return torch.fft.rfft(frames * torch.as_tensor(win, dtype=frames.dtype, device=frames.device),
                          dim=-1)


def _bins(sel: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.flatnonzero(sel), device=device)


def stft(
    x: torch.Tensor,
    fs: float = 1.0,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window: str = "hann",
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """``scipy.signal.stft`` with its defaults over the trailing axis:
    ``x (..., T) -> (freqs, times, Zxx (..., F, N))``, complex."""
    if window != "hann":
        raise NotImplementedError("only 'hann' is supported")
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    win = _hann(nperseg)
    half = nperseg // 2
    xx = F.pad(x, (half, half))
    rem = (xx.shape[-1] - nperseg) % step
    if rem:
        xx = F.pad(xx, (0, step - rem))
    spec = _windowed_rfft(xx.unfold(-1, nperseg, step), win) * (1.0 / win.sum())
    zxx = spec.transpose(-1, -2)  # (..., F, N)
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / fs)
    times = (np.arange(zxx.shape[-1]) * step) / fs
    return freqs, times, zxx


def welch_psd(
    x: torch.Tensor,
    fs: float = 1.0,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
) -> Tuple[np.ndarray, torch.Tensor]:
    """``scipy.signal.welch`` with its defaults: ``x (..., T) -> (freqs,
    Pxx (..., F))``. An ``nperseg`` past the signal is clamped to its
    length with a warning, and ``noverlap >= nperseg`` raises, as SciPy."""
    if nperseg > x.shape[-1]:
        warnings.warn(
            f"nperseg = {nperseg} is greater than signal length = "
            f"{x.shape[-1]}, using nperseg = {x.shape[-1]}",
            stacklevel=2,
        )
        nperseg = x.shape[-1]
    if noverlap is None:
        noverlap = nperseg // 2
    elif noverlap >= nperseg:
        raise ValueError(f"noverlap ({noverlap}) must be less than nperseg ({nperseg})")
    step = nperseg - noverlap
    win = _hann(nperseg)
    frames = x.unfold(-1, nperseg, step)  # (..., N, nperseg)
    frames = frames - frames.mean(dim=-1, keepdim=True)  # detrend='constant'
    spec = _windowed_rfft(frames, win)
    p = (spec.real ** 2 + spec.imag ** 2) * (1.0 / (fs * (win * win).sum()))
    # one-sided doubling (not DC; not Nyquist when nperseg is even)
    mult = np.full(p.shape[-1], 2.0)
    mult[0] = 1.0
    if nperseg % 2 == 0:
        mult[-1] = 1.0
    p = p * torch.as_tensor(mult, dtype=p.dtype, device=p.device)
    return np.fft.rfftfreq(nperseg, d=1.0 / fs), p.mean(dim=-2)


def band_power(
    x: torch.Tensor,
    fs: float,
    bands: Sequence[Tuple[float, float]],
    nperseg: int = 256,
    log: bool = True,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Per-band (log-)power, the rectangle-rule integral of the Welch PSD
    over each band's inclusive edges: ``x (..., T) -> (..., n_bands)``."""
    freqs, pxx = welch_psd(x, fs=fs, nperseg=min(nperseg, x.shape[-1]))
    df = float(freqs[1] - freqs[0]) if len(freqs) > 1 else 1.0
    outs = [pxx[..., _bins((freqs >= lo) & (freqs <= hi), pxx.device)].sum(dim=-1) * df
            for lo, hi in bands]
    bp = torch.stack(outs, dim=-1)
    return torch.log(bp + eps) if log else bp


def log_bandpower_features(x: torch.Tensor, fs: float, nperseg: int = 256) -> torch.Tensor:
    """The canonical 5-band log-power vector per channel, ``(..., C, T) ->
    (..., C * 5)``: the MLP baseline's features (BASELINE.json config #1)."""
    bp = band_power(x, fs, list(BANDS.values()), nperseg=nperseg, log=True)
    return bp.reshape(*bp.shape[:-2], -1)


def filterbank(
    x: torch.Tensor,
    fs: float,
    bands: Sequence[Tuple[float, float]],
    method: str = "iir",
    order: int = 4,
) -> torch.Tensor:
    """A bank of zero-phase band-passes (``filters.bandpass_filter``):
    ``(..., T) -> (..., B, T)``."""
    from .filters import bandpass_filter

    return torch.stack([bandpass_filter(x, fs, lo, hi, method=method, order=order)
                        for lo, hi in bands], dim=-2)


def band_bins(freqs: np.ndarray, lo: float, hi: float) -> Tuple[np.ndarray, bool]:
    """The bins of ``[lo, hi)`` as a mask, or the bin nearest the band's
    centre when none lies in it (second value False)."""
    sel = (freqs >= lo) & (freqs < hi)
    if sel.any():
        return sel, True
    sel = np.zeros_like(sel)
    sel[np.argmin(np.abs(freqs - (lo + hi) / 2))] = True
    return sel, False


def band_stft_heatmap(
    x: torch.Tensor,
    fs: float,
    nperseg: int = 64,
    noverlap: int = 32,
    bands: Dict[str, Tuple[float, float]] = BANDS,
) -> Tuple[Tuple[str, ...], np.ndarray, torch.Tensor]:
    """Band x time magnitude matrix from an STFT (the group-SHAP band
    heatmaps, reference ``scripts/global_shap_analysis.py:120-174``):
    ``x (..., T) -> (..., n_bands, n_frames)``, the mean ``|STFT|`` of each
    band's bins."""
    freqs, times, zxx = stft(x, fs=fs, nperseg=nperseg, noverlap=noverlap)
    mag = zxx.abs()
    rows = [mag[..., _bins(band_bins(freqs, lo, hi)[0], mag.device), :].mean(dim=-2)
            for lo, hi in bands.values()]
    return tuple(bands.keys()), times, torch.stack(rows, dim=-2)
