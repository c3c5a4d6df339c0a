"""Integrated-gradients attribution of a FAST model's class scores.

Counterpart of ``integrated_gradients`` in
``imagined_speech_decoding_tpu/explain/attribution.py``: the gradient of
the target-class logit with respect to the raw input, averaged over
``n_steps`` midpoints of the straight path from a baseline to ``x``, times
``x - baseline``. The input gradient runs through kernel B2x on a CUDA
device (the model's weights are held out of the graph, so B2w does not
run); the scores satisfy completeness, ``sum(attr) ~ f(x) - f(baseline)``.
"""

from __future__ import annotations

from typing import Optional

import torch


def integrated_gradients(model, x: torch.Tensor, target: torch.Tensor,
                         baseline: Optional[torch.Tensor] = None,
                         n_steps: int = 32) -> torch.Tensor:
    """Attributions ``(B, C, T)`` of ``model`` (one model, at eval) for the
    classes ``target (B,)`` on trials ``x (B, C, T)``; ``baseline`` is
    ``(C, T)`` or ``(B, C, T)``, zeros by default."""
    baseline = torch.zeros_like(x) if baseline is None else baseline.expand_as(x)
    was_training = model.training
    needs = [p.requires_grad for p in model.parameters()]
    model.eval().requires_grad_(False)
    try:
        total = torch.zeros_like(x)
        for i in range(n_steps):
            alpha = (i + 0.5) / n_steps  # midpoint rule
            xi = (baseline + alpha * (x - baseline)).detach().requires_grad_(True)
            score = model(xi).gather(-1, target.long().unsqueeze(-1)).sum()
            total += torch.autograd.grad(score, xi)[0]
    finally:
        for p, need in zip(model.parameters(), needs):
            p.requires_grad_(need)
        model.train(was_training)
    return total / n_steps * (x - baseline)
