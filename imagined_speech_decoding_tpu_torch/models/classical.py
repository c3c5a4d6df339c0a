"""Classical baseline: band-pass -> CSP -> standardisation -> SVM or shrinkage LDA.

Counterpart of ``imagined_speech_decoding_tpu/models/classical.py``: a
4-40 Hz band-pass (or a filterbank of bands), CSP log-variance features
standardised by the training set, then an RBF SVM (``C=1, gamma='scale',
class_weight='balanced'``) or an eigen-solver shrinkage LDA. The filters
(``ops.filters.bandpass_filter``: ``fir`` one convolution, ``iir`` one
kernel-B1 chain launch a band on the card) and CSP (``ops.csp``) run on
the trials' device; the features go to the host for scikit-learn's
classifier, which ``fit`` imports. ``save`` / ``load`` use joblib,
imported by them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices import require_device
from ..ops.csp import CSPModel, csp_fit, csp_transform
from ..ops.filters import bandpass_filter


@dataclass
class CSPClassifierPipeline:
    """fit / predict: band-pass (or filterbank) -> CSP -> classifier.

    ``classifier``: 'svm' (RBF) or 'lda' (eigen-solver shrinkage LDA).
    ``device``: where the filters and CSP run (numpy trials are moved
    there); the card unless the caller names the CPU.
    """

    n_classes: int = 5
    sfreq: float = 250.0
    l_freq: Optional[float] = 4.0
    h_freq: Optional[float] = 40.0
    filter_method: str = "fir"
    bands: Optional[Sequence[Tuple[float, float]]] = None  # filterbank mode
    n_components: int = 10
    classifier: str = "svm"
    device: str = "cuda"
    csp_models: List[CSPModel] = field(default_factory=list)
    clf: object = None

    def _filter(self, x: torch.Tensor) -> List[torch.Tensor]:
        bands = self.bands or [(self.l_freq, self.h_freq)]
        return [bandpass_filter(x, self.sfreq, lo, hi, method=self.filter_method)
                for lo, hi in bands]

    def features(self, x, y=None) -> np.ndarray:
        """CSP features ``(N, n_bands * n_components)`` of trials ``x (N, C,
        T)`` on the host; with labels ``y`` the CSP filters are fitted
        first."""
        xt = torch.as_tensor(np.asarray(x, np.float32), device=require_device(self.device))
        feats = []
        for bi, xb in enumerate(self._filter(xt)):
            if y is not None:
                self.csp_models.append(csp_fit(
                    xb, torch.as_tensor(np.asarray(y).astype(np.int64), device=self.device),
                    self.n_classes, self.n_components))
            feats.append(csp_transform(xb, self.csp_models[bi]).cpu().numpy())
        return np.concatenate(feats, axis=-1)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "CSPClassifierPipeline":
        self.csp_models = []
        feats = self.features(x, y)
        if self.classifier == "svm":
            from sklearn.svm import SVC

            self.clf = SVC(C=1.0, gamma="scale", kernel="rbf", class_weight="balanced")
        elif self.classifier == "lda":
            from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

            self.clf = LinearDiscriminantAnalysis(solver="eigen", shrinkage="auto")
        else:
            raise ValueError(f"unknown classifier {self.classifier!r}")
        self.clf.fit(feats, np.asarray(y))
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self.clf is None:
            raise RuntimeError("pipeline not fitted")
        return self.clf.predict(self.features(x))

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))

    def save(self, path: str) -> str:
        """The fitted pipeline, its CSP tensors on the CPU, through joblib."""
        import joblib

        joblib.dump(self._replace_device("cpu"), path)
        return path

    def _replace_device(self, device: str) -> "CSPClassifierPipeline":
        models = [CSPModel(*(t.to(device) for t in m)) for m in self.csp_models]
        return dataclasses.replace(self, device=device, csp_models=models)

    @staticmethod
    def load(path: str, device: str = "cuda") -> "CSPClassifierPipeline":
        import joblib

        return joblib.load(path)._replace_device(device)
