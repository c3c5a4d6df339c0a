"""Online decoding: raw EEG window -> class posteriors, on one device.

Counterpart of ``_build_decode_fn`` and ``make_online_decoder`` in
``imagined_speech_decoding_tpu/serving.py``. The chain is the same:

    raw (B, C, T) -> [60 Hz notch -> 4-40 Hz band-pass, zero-phase IIR]
        -> FAST (default mode, eval) -> softmax posteriors (B, K)

Both filter stages are prepared once, when the decoder is built
(``ops.cuda.iir.prepare_filter``: SciPy runs there and never per decode),
and run as one ``sosfiltfilt_chain``: one launch of kernel B1 on a CUDA
device. The FAST head runs through kernel B2f.
Weights are runtime state of the decoder: ``swap_weights`` copies a new
checkpoint into the same module, in place.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .data.constants import SFREQ
from .ops.cuda.iir import load_tables, prepare_filter, sosfiltfilt_chain
from .ops.filters import butter_sos, notch_ba
from .transplant import from_jax_params


def _build_decode_fn(
    sfreq: float, notch_hz: Optional[float], band: Optional[Tuple[float, float]]
) -> Callable:
    """The serving chain as ``(model, x) -> posteriors`` on ``x``'s device:
    notch + band-pass zero-phase IIR, model forward, softmax."""
    from scipy.signal import tf2sos

    # The notch's (b, a) pair converts exactly to one second-order section.
    filters = []
    if notch_hz:
        filters.append(prepare_filter(tf2sos(*notch_ba(sfreq, notch_hz))))
    if band:
        filters.append(prepare_filter(butter_sos(sfreq, band[0], band[1])))

    def _decode(model, x):
        with torch.inference_mode():
            if filters:
                x = sosfiltfilt_chain(filters, x)
            return torch.softmax(model(x).float(), dim=-1)

    _decode.filters = filters
    return _decode


def make_online_decoder(
    model: torch.nn.Module,
    params,
    *,
    sfreq: float = SFREQ,
    notch_hz: Optional[float] = 60.0,
    band: Optional[Tuple[float, float]] = (4.0, 40.0),
) -> Callable:
    """Serve ``model`` (a ``FAST``) with the JAX-layout weights ``params``.

    Returns ``decode(x (B, C, T) array) -> posteriors (B, K) float32 array``,
    computed on the model's device, with an attached
    ``decode.swap_weights(params)`` that copies new weights into the same
    module. The Conv4Layers FAST has no mutable state, so no ``state``
    tree travels with the weights.
    """
    _decode = _build_decode_fn(sfreq, notch_hz, band)
    device = next(model.parameters()).device
    if device.type == "cuda" and _decode.filters:
        load_tables(_decode.filters, device)
    model.eval()

    def swap_weights(new_params) -> None:
        """Replace the serving weights in place (same shapes)."""
        model.load_state_dict(from_jax_params(new_params))

    def decode(x: np.ndarray) -> np.ndarray:
        xt = torch.tensor(np.asarray(x, np.float32), device=device)
        return _decode(model, xt).cpu().numpy()

    swap_weights(params)
    decode.swap_weights = swap_weights
    return decode
