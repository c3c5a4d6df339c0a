"""Common Spatial Patterns (CSP) in PyTorch, batched over trials.

Counterpart of ``imagined_speech_decoding_tpu/ops/csp.py``: class
covariances are one batched product, the generalized eigenproblem is
solved by whitening and ``torch.linalg.eigh``, and more than two classes
decompose one-vs-rest. Conventions, as in the JAX module:

  * filters ordered by descending ``|lambda - 0.5|`` (most
    discriminative first, alternating ends);
  * each filter's largest-|coefficient| entry is made positive.

Everything runs on the trials' device and in their dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class CSPModel(NamedTuple):
    filters: torch.Tensor  # (n_components, C) spatial filters W
    patterns: torch.Tensor  # (n_components, C) spatial patterns A = pinv(W)
    mean: torch.Tensor  # (n_components,) feature standardization mean
    std: torch.Tensor  # (n_components,) feature standardization std


def _class_covariances(x: torch.Tensor, y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Per-class mean of the trace-normalised trial covariances: ``x (N, C,
    T)``, ``y (N,)`` -> ``(K, C, C)``, weighted by a one-hot matrix (a
    class without trials gives zeros)."""
    xc = x - x.mean(dim=-1, keepdim=True)
    cov = torch.einsum("nct,ndt->ncd", xc, xc) / x.shape[-1]
    tr = cov.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None]
    cov = cov / tr.clamp(min=1e-12)
    onehot = F.one_hot(y.long(), n_classes).to(x.dtype)  # (N, K)
    counts = onehot.sum(0).clamp(min=1.0)
    return torch.einsum("nk,ncd->kcd", onehot, cov) / counts[:, None, None]


def _solve_csp_pair(c_a: torch.Tensor, c_b: torch.Tensor,
                    reg: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``C_a v = lambda (C_a + C_b) v``: ``(eigenvalues ascending, filters
    as rows)``, by whitening with ``(C_a + C_b)^{-1/2}`` (shrunk toward the
    identity by ``reg``) and ``eigh`` of the symmetrised ``W C_a W``."""
    c = c_a + c_b
    dim = c.shape[-1]
    c = (1 - reg) * c + reg * torch.trace(c) / dim * torch.eye(dim, dtype=c.dtype, device=c.device)
    evals, evecs = torch.linalg.eigh(c)
    whiten = evecs * torch.rsqrt(evals.clamp(min=1e-12))[None, :]
    s = whiten.T @ c_a @ whiten
    lam, u = torch.linalg.eigh((s + s.T) / 2)
    return lam, (whiten @ u).T


def _order_and_sign(lam: torch.Tensor, filters: torch.Tensor, n_components: int) -> torch.Tensor:
    """The ``n_components`` most discriminative filters, signs pinned."""
    order = torch.argsort(-(lam - 0.5).abs())
    sel = filters[order[:n_components]]
    amax = sel.abs().argmax(dim=1)
    signs = torch.sign(sel[torch.arange(sel.shape[0], device=sel.device), amax])
    return sel * torch.where(signs == 0, torch.ones_like(signs), signs)[:, None]


def csp_fit(x: torch.Tensor, y: torch.Tensor, n_classes: int, n_components: int = 8,
            reg: float = 1e-6) -> CSPModel:
    """CSP filters from trials ``x (N, C, T)`` and labels ``y (N,)``: the
    pairwise decomposition for two classes; one-vs-rest for more, each
    class giving ``n_components // n_classes`` filters (``n_components``
    must divide evenly)."""
    covs = _class_covariances(x, y, n_classes)
    if n_classes == 2:
        lam, filt = _solve_csp_pair(covs[0], covs[1], reg)
        w = _order_and_sign(lam, filt, n_components)
    else:
        if n_components % n_classes != 0:
            raise ValueError(
                f"n_components={n_components} must be divisible by n_classes={n_classes} for OVR CSP"
            )
        per = n_components // n_classes
        total = covs.sum(dim=0)
        w = torch.cat([_order_and_sign(*_solve_csp_pair(covs[k], total - covs[k], reg), per)
                       for k in range(n_classes)])
    feats = _raw_features(x, w)
    return CSPModel(filters=w, patterns=torch.linalg.pinv(w).T, mean=feats.mean(dim=0),
                    std=feats.std(dim=0, unbiased=False).clamp(min=1e-12))


def _raw_features(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Log-variance of the CSP projections: ``(N, C, T) -> (N, n_components)``."""
    proj = torch.einsum("fc,nct->nft", filters, x)
    return torch.log(proj.var(dim=-1, unbiased=False).clamp(min=1e-12))


def csp_transform(x: torch.Tensor, model: CSPModel, standardize: bool = True) -> torch.Tensor:
    """Trials -> log-variance CSP features, standardised by the fit's
    mean and std."""
    feats = _raw_features(x, model.filters)
    return (feats - model.mean) / model.std if standardize else feats


def csp_fit_transform(x: torch.Tensor, y: torch.Tensor, n_classes: int, n_components: int = 8,
                      reg: float = 1e-6) -> Tuple[CSPModel, torch.Tensor]:
    model = csp_fit(x, y, n_classes, n_components, reg)
    return model, csp_transform(x, model)
