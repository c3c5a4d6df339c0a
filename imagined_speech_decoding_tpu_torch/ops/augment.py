"""Train-time EEG augmentation: per-trial noise, then whole-channel dropout.

Counterpart of ``gaussian_noise``, ``channel_dropout`` and
``augment_batch`` of ``imagined_speech_decoding_tpu/ops/augment.py``.
``augment_with_draws`` is the arithmetic on draws it is given (the tests
feed it JAX's own draws); ``augment_batch`` draws them from a
``torch.Generator`` on x's device (the fit's dropout generator, so a
seed gives one stream of augmentations and masks) and applies them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.modules import draw_rows


def gaussian_noise(x: torch.Tensor, noise: torch.Tensor, sigma: float = 0.1) -> torch.Tensor:
    """``x + sigma * std * noise``, ``std`` each trial's (biased) standard
    deviation over its channels and samples; ``noise`` standard normal,
    shaped as x."""
    std = x.std(dim=(-2, -1), keepdim=True, correction=0)
    return x + sigma * std * noise


def channel_dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the channels where ``keep (..., C)`` is False; the survivors are
    not rescaled (spatial patterns stay calibrated)."""
    return x * keep[..., None].to(x.dtype)


def augment_with_draws(x: torch.Tensor, noise: torch.Tensor, keep: torch.Tensor,
                       noise_sigma: float = 0.1) -> torch.Tensor:
    """The augmentation chain on explicit draws: noise, then channel dropout."""
    return channel_dropout(gaussian_noise(x, noise, noise_sigma), keep)


def augment_batch(x: torch.Tensor, noise_sigma: float = 0.1, ch_drop: float = 0.1,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``augment_with_draws`` on standard-normal noise and Bernoulli(1 -
    ``ch_drop``) channel keeps drawn from ``generator``, in that order
    (``models.modules.draw_rows``: shared or sharded rows as the
    generator says). ``x (M, B, C, T)``, model axis first."""
    if generator is None:
        raise ValueError("augment_batch needs a torch.Generator")
    if x.dim() != 4:
        raise ValueError(f"augment_batch takes raw trials (M, B, C, T), got {tuple(x.shape)}: "
                         "noise and channel dropout have no meaning on features")
    noise = draw_rows(generator, x.shape, lambda s: torch.randn(
        s, generator=generator, device=x.device, dtype=x.dtype))
    keep = draw_rows(generator, x.shape[:-1], lambda s: torch.rand(
        s, generator=generator, device=x.device) < 1.0 - ch_drop)
    return augment_with_draws(x, noise, keep, noise_sigma)
