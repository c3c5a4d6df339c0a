"""FastICA in PyTorch: the decomposition the artifact QC runs on the card.

The same function as scikit-learn's ``FastICA(n_components,
random_state=seed, max_iter=500, whiten="unit-variance")`` with its
defaults (``algorithm="parallel"``, ``fun="logcosh"``, ``tol=1e-4``,
``whiten_solver="svd"``), done in the input tensor's dtype on its device:

1. centre the features;
2. whiten by the SVD of ``X^T`` (signs fixed by ``u *= sign(u[0])``),
   ``K = (u / d)^T[:k]``, ``X1 = K X^T sqrt(n)``;
3. start from ``RandomState(seed).normal(size=(k, k))`` (numpy, so the
   start is sklearn's), symmetrically decorrelated;
4. iterate the parallel fixed point with the logcosh contrast,
   ``W <- sym(tanh(W X1) X1^T / n - mean(1 - tanh^2) W)``, until the
   largest ``| |diag(W_new W^T)| - 1 |`` is under ``tol``, with a
   ``ConvergenceWarning`` after ``max_iter`` iterations;
5. rescale the sources to unit variance; ``components = W K`` and
   ``mixing = pinv(components)``.

Each iteration reads its convergence test on the host.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional, Union

import numpy as np
import torch


class ConvergenceWarning(UserWarning):
    """FastICA stopped at ``max_iter`` before reaching ``tol``."""


class ICAResult(NamedTuple):
    mixing: torch.Tensor  # (n_features, k): sklearn's mixing_
    sources: torch.Tensor  # (n_samples, k), unit variance: fit_transform's result
    n_iter: int  # sklearn's n_iter_
    components: torch.Tensor  # (k, n_features): sklearn's components_
    mean: torch.Tensor  # (n_features,): sklearn's mean_


def _sym_decorrelation(w: torch.Tensor) -> torch.Tensor:
    """``(W W^T)^{-1/2} W``, the eigenvalues clipped at the dtype's tiny."""
    s, u = torch.linalg.eigh(w @ w.T)
    s = s.clamp(min=torch.finfo(w.dtype).tiny)
    return (u * (1.0 / torch.sqrt(s))) @ (u.T @ w)


def _ica_par(x1: torch.Tensor, w_init: torch.Tensor, tol: float, max_iter: int):
    w = _sym_decorrelation(w_init)
    p = float(x1.shape[1])
    for ii in range(max_iter):
        gwtx = torch.tanh(w @ x1)
        g_wtx = (1 - gwtx ** 2).mean(dim=-1)
        w1 = _sym_decorrelation(gwtx @ x1.T / p - g_wtx[:, None] * w)
        lim = float(((w1 * w).sum(dim=-1).abs() - 1).abs().max())
        w = w1
        if lim < tol:
            break
    else:
        warnings.warn("FastICA did not converge. Consider increasing tolerance or the maximum "
                      "number of iterations.", ConvergenceWarning, stacklevel=3)
    return w, ii + 1


def fast_ica(x: torch.Tensor, n_components: Optional[int] = None,
             seed: Union[int, np.random.RandomState, None] = None, max_iter: int = 500,
             tol: float = 1e-4) -> ICAResult:
    """FastICA of ``x (n_samples, n_features)`` as the module docstring sets
    out. ``seed``: an int or a ``RandomState`` (sklearn's
    ``random_state``; None draws from numpy's global state)."""
    xt = x.T
    n_features, n_samples = xt.shape
    k = min(n_samples, n_features) if n_components is None else n_components
    if k > min(n_samples, n_features):
        k = min(n_samples, n_features)
        warnings.warn(f"n_components is too large: it will be set to {k}", stacklevel=2)
    mean = xt.mean(dim=-1)
    xt = xt - mean[:, None]
    u, d, _ = torch.linalg.svd(xt, full_matrices=False)
    u = u * torch.sign(u[0])
    whitening = (u / d).T[:k]
    x1 = whitening @ xt * math.sqrt(n_samples)
    rs = seed if isinstance(seed, np.random.RandomState) else (
        np.random.mtrand._rand if seed is None else np.random.RandomState(seed))
    w_init = torch.as_tensor(rs.normal(size=(k, k)), dtype=x.dtype, device=x.device)
    w, n_iter = _ica_par(x1, w_init, tol, max_iter)
    unmix = w @ whitening
    sources = (unmix @ xt).T
    s_std = sources.std(dim=0, keepdim=True, unbiased=False)
    sources = sources / s_std
    components = (w / s_std.T) @ whitening
    return ICAResult(mixing=torch.linalg.pinv(components), sources=sources, n_iter=n_iter,
                     components=components, mean=mean)
