"""Gradient attributions of a FAST model's class scores.

Counterparts of ``integrated_gradients``, ``expected_gradients`` and
``attribution_for_predictions`` in
``imagined_speech_decoding_tpu/explain/attribution.py``: gradients of the
target-class logit with respect to the raw input, at points between a
baseline (or background trials) and ``x``, averaged and times ``x`` minus
that baseline. The input gradient runs through kernel B2x on a CUDA
device (the model's weights are held out of the graph, so B2w does not
run), once per interpolation step on the whole batch.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def _frozen(model):
    """``model`` at eval with its weights out of the graph; restored after."""
    was_training = model.training
    needs = [p.requires_grad for p in model.parameters()]
    model.eval().requires_grad_(False)
    try:
        yield
    finally:
        for p, need in zip(model.parameters(), needs):
            p.requires_grad_(need)
        model.train(was_training)


def _input_grad(model, xi: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """d/dxi of the sum over trials of the target-class logits."""
    xi = xi.detach().requires_grad_(True)
    score = model(xi).gather(-1, target.long().unsqueeze(-1)).sum()
    return torch.autograd.grad(score, xi)[0]


def integrated_gradients(model, x: torch.Tensor, target: torch.Tensor,
                         baseline: Optional[torch.Tensor] = None,
                         n_steps: int = 32) -> torch.Tensor:
    """Attributions ``(B, C, T)`` of ``model`` (one model, at eval) for the
    classes ``target (B,)`` on trials ``x (B, C, T)``, along the straight
    path from ``baseline`` (``(C, T)`` or ``(B, C, T)``, zeros by default)
    by the midpoint rule; they satisfy completeness, ``sum(attr) ~ f(x) -
    f(baseline)``."""
    baseline = torch.zeros_like(x) if baseline is None else baseline.expand_as(x)
    with _frozen(model):
        total = torch.zeros_like(x)
        for i in range(n_steps):
            alpha = (i + 0.5) / n_steps
            total += _input_grad(model, baseline + alpha * (x - baseline), target)
    return total / n_steps * (x - baseline)


def expected_gradients(model, x: torch.Tensor, background: torch.Tensor, target: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       n_samples: int = 32) -> torch.Tensor:
    """Expected gradients (SHAP's GradientExplainer) ``(B, C, T)``: for
    each of ``n_samples`` draws, a random trial of ``background (N_bg, C,
    T)`` and a random point ``alpha`` in [0, 1) per trial; the mean of
    ``grad(bg + alpha (x - bg)) * (x - bg)``. The draws come from
    ``generator`` on its own device (the default CPU generator if None)."""
    device = generator.device if generator is not None else torch.device("cpu")
    shape = (n_samples, x.shape[0])
    bg_idx = torch.randint(0, background.shape[0], shape, generator=generator, device=device)
    alphas = torch.rand(shape, generator=generator, device=device)
    return expected_gradients_from_draws(model, x, background, target, bg_idx, alphas)


def expected_gradients_from_draws(model, x: torch.Tensor, background: torch.Tensor,
                                  target: torch.Tensor, bg_idx: torch.Tensor,
                                  alphas: torch.Tensor) -> torch.Tensor:
    """``expected_gradients`` on given draws: ``bg_idx (n_samples, B)``
    indexes ``background``, ``alphas (n_samples, B)`` the points."""
    bg_idx, alphas = bg_idx.to(x.device), alphas.to(x.device, x.dtype)
    with _frozen(model):
        total = torch.zeros_like(x)
        for idx, alpha in zip(bg_idx, alphas):
            bg = background[idx]
            diff = x - bg
            total += _input_grad(model, bg + alpha[:, None, None] * diff, target) * diff
    return total / bg_idx.shape[0]


def attribution_for_predictions(model, x: torch.Tensor, background: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                n_samples: int = 32):
    """Expected gradients w.r.t. each trial's predicted class: ``(attr
    (B, C, T), preds (B,))``."""
    with _frozen(model), torch.no_grad():
        preds = model(x).argmax(-1)
    return expected_gradients(model, x, background, preds, generator, n_samples), preds
