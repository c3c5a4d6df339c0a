"""Baseline pipelines: a featurizer and a model family as one unit.

Counterpart of ``imagined_speech_decoding_tpu/pipelines.py``: the three
baseline configurations of BASELINE.json that train on the stacked CV
engine (``train.cv.train_per_subject_cv``) beside FAST:

  * ``bandpower_mlp`` (config #1): 60 Hz notch and 8-70 Hz band-pass,
    Welch log-bandpower over 2-s segments, -> MLP;
  * ``stft_eegnet`` (config #3): per-channel STFT log-magnitude binned into
    the five canonical bands -> plane-stacked EEGNet;
  * ``cnn_bilstm`` (config #4): raw trials -> conv frontend -> BiLSTM, with
    optional train-time augmentation (``models.api.make_augmented_model``).

The featurizers are tensor functions over ``(..., C, T)`` on the input's
device. ``bandpower_featurize`` filters with kernel B1: the notch and the
band-pass as one ``sosfiltfilt_chain`` launch on a CUDA tensor (the JAX
function runs both through the Pallas IIR on a TPU), the plain chain on a
CPU tensor. ``featurize_corpus`` takes numpy in and gives numpy back.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .data.constants import SFREQ
from .ops.cuda.iir import PreparedFilter, prepare_filter, sosfiltfilt_chain
from .ops.spectral import BANDS, band_bins, log_bandpower_features, stft


@functools.lru_cache(maxsize=8)
def bandpower_filters(sfreq: float = SFREQ, l_freq: float = 8.0, h_freq: float = 70.0,
                      notch: float = 60.0) -> Tuple[PreparedFilter, PreparedFilter]:
    """``bandpower_featurize``'s two zero-phase stages for
    ``sosfiltfilt_chain``: the ``iirnotch(notch, Q 30)`` section
    (``tf2sos``) and the order-4 Butterworth band-pass, each with
    ``sosfiltfilt``'s default padlen for its sections (9 for the notch, as
    the JAX function's ``sosfiltfilt`` takes it)."""
    from scipy.signal import tf2sos

    from .ops.filters import butter_sos, notch_ba

    return (prepare_filter(tf2sos(*notch_ba(sfreq, notch))),
            prepare_filter(butter_sos(sfreq, l_freq, h_freq)))


def bandpower_featurize(
    x: torch.Tensor,
    sfreq: float = SFREQ,
    l_freq: float = 8.0,
    h_freq: float = 70.0,
    notch: float = 60.0,
    epoch_seconds: float = 2.0,
) -> torch.Tensor:
    """Config #1's features: notch, then band-pass (zero-phase, one B1
    chain launch on a CUDA tensor), then each channel's 5-band log-power
    from Welch over ``epoch_seconds`` Hann segments at 50% overlap (the
    config's "2 s epochs"): ``(..., C, T) -> (..., C * 5)``."""
    x = sosfiltfilt_chain(bandpower_filters(sfreq, l_freq, h_freq, notch), x)
    nper = int(round(epoch_seconds * sfreq))
    return log_bandpower_features(x, sfreq, nperseg=min(nper, x.shape[-1]))


def stft_n_frames(n_samples: int, nperseg: int = 64, step: int = 8) -> int:
    """Frame count of ``ops.spectral.stft`` (SciPy's default zero padding)."""
    t = n_samples + 2 * (nperseg // 2)
    rem = (t - nperseg) % step
    if rem:
        t += step - rem
    return (t - nperseg) // step + 1


def stft_image_featurize(
    x: torch.Tensor,
    sfreq: float = SFREQ,
    nperseg: int = 64,
    step: int = 8,
) -> torch.Tensor:
    """Config #3's features: the band-binned STFT log-magnitude "image",
    ``(..., C, T) -> (..., n_bands, C, n_frames)``, each band
    (``ops.spectral.BANDS``) the mean of ``log(|Zxx| + 1e-8)`` over its
    bins: one input plane of the EEGNet. A band with no bin takes its
    nearest one, and two bands on the same bins would train on duplicate
    planes: each warns."""
    freqs, _, zxx = stft(x, fs=sfreq, nperseg=nperseg, noverlap=nperseg - step)
    logmag = torch.log(zxx.abs() + 1e-8)  # (..., C, F, N)
    rows, band_sets = [], []
    for name, (lo, hi) in BANDS.items():
        sel, found = band_bins(freqs, lo, hi)
        if not found:
            warnings.warn(
                f"stft_image_featurize: band {name} [{lo}, {hi}) Hz contains "
                f"no rfft bin at nperseg={nperseg}, sfreq={sfreq} — falling "
                "back to its nearest bin. Increase nperseg (frequency "
                f"resolution is {freqs[1] - freqs[0]:.2f} Hz/bin).",
                stacklevel=2,
            )
        idx = np.flatnonzero(sel)
        band_sets.append((name, tuple(idx)))
        rows.append(logmag[..., torch.as_tensor(idx, device=logmag.device), :].mean(dim=-2))
    for (na, ba), (nb, bb) in zip(band_sets, band_sets[1:]):
        if ba == bb:
            warnings.warn(
                f"stft_image_featurize: bands {na} and {nb} resolve to "
                f"identical rfft bins {ba} — their input planes are "
                "duplicates. Increase nperseg or drop a band.",
                stacklevel=2,
            )
    return torch.stack(rows, dim=-3)  # (..., n_bands, C, N)


@dataclass(frozen=True)
class Pipeline:
    """A baseline configuration: how raw trials are featurized and which
    model trains on the features.

    ``featurize(x)``: raw ``(..., C, T)`` tensor -> feature tensor (None for
    a raw-input model). ``make_model(n_channels, n_samples, n_classes)``: a
    ``models.api.ModelDef`` over the featurized input; its compute dtype
    is the input's (the training config's precision). ``augmentable``: the
    model takes raw EEG, so ``ops.augment``'s noise and channel dropout
    mean something on its input. ``whole_split``: ``featurize_corpus``
    featurizes a whole split at once (its intermediates are a small
    multiple of the input), else one subject at a time."""

    name: str
    description: str
    featurize: Optional[Callable]
    make_model: Callable
    augmentable: bool = False
    whole_split: bool = False


def _make_bandpower_mlp(n_channels: int, n_samples: int, n_classes: int):
    from .models.api import make_mlp_model

    return make_mlp_model(n_channels * len(BANDS), n_classes)


def _make_stft_eegnet(n_channels: int, n_samples: int, n_classes: int):
    from .models.api import make_stft_eegnet_model

    return make_stft_eegnet_model(n_channels, n_samples, n_classes)


def _make_cnn_bilstm(n_channels: int, n_samples: int, n_classes: int):
    from .models.api import make_cnn_bilstm_model

    return make_cnn_bilstm_model(n_channels, n_samples, n_classes)


PIPELINES: Dict[str, Pipeline] = {
    "bandpower_mlp": Pipeline(
        name="bandpower_mlp",
        description="notch + 8-70 Hz bandpass, 2-s Welch log-bandpower -> MLP "
        "(BASELINE.json config #1)",
        featurize=bandpower_featurize,
        make_model=_make_bandpower_mlp,
        whole_split=True,
    ),
    "stft_eegnet": Pipeline(
        name="stft_eegnet",
        description="band-binned STFT log-magnitude planes -> EEGNet "
        "(BASELINE.json config #3)",
        featurize=stft_image_featurize,
        make_model=_make_stft_eegnet,
    ),
    "cnn_bilstm": Pipeline(
        name="cnn_bilstm",
        description="raw windows -> CNN frontend + BiLSTM sequence head "
        "(BASELINE.json config #4; --augment wires noise + channel "
        "dropout into the jitted train step)",
        featurize=None,
        make_model=_make_cnn_bilstm,
        augmentable=True,
    ),
}


def featurize_corpus(
    pipeline: Pipeline,
    X: np.ndarray,  # (S, N, C, T)
    test_per_subject: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
    device="cuda",
):
    """The pipeline's featurizer over the train+val corpus and the
    per-subject test sets, on ``device`` (CUDA unless the caller names
    another; without a card it raises), as numpy ``(Xf (S, N, ...), testf)``.
    ``whole_split`` pipelines take the corpus in one call and all the test
    sets in another; the others go one subject at a time (the STFT's
    complex intermediate of the whole corpus is ~9 GB). Raw pipelines
    pass through unchanged."""
    from .devices import require_device

    if pipeline.featurize is None:
        return X, test_per_subject
    device = require_device(device)

    def feat(a: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)
            return pipeline.featurize(x).cpu().numpy()

    if pipeline.whole_split:
        Xf = feat(X)
    else:
        Xf = np.stack([feat(X[s]) for s in range(X.shape[0])])
    testf = None
    if test_per_subject is not None:
        items = list(test_per_subject.items())
        if pipeline.whole_split and items:
            flat = feat(np.concatenate([xt for _, (xt, _) in items]))
            ends = np.cumsum([len(xt) for _, (xt, _) in items])
            testf = {sid: (part, yt) for (sid, (_, yt)), part in
                     zip(items, np.split(flat, ends[:-1]))}
        else:
            testf = {sid: (feat(xt), yt) for sid, (xt, yt) in items}
    return Xf, testf
