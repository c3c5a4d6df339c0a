"""FAST architecture, training and data configs, and their YAML loader.

Counterparts of ``FASTConfig``, ``TrainConfig``, ``DataConfig`` and
``load_config`` in ``imagined_speech_decoding_tpu/config.py`` with the same fields and
defaults, restated here because the JAX package's module imports
``yaml`` at import time and its ``default()`` imports ``jax``. Here PyYAML
is imported only inside ``load_config``, when a file is read. A CPU test
holds both packages field for field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class FASTConfig:
    """FAST architecture: 64 electrodes / 8 zones / dim 32 / 4 layers /
    8 heads, 800-sample trials tokenized into 5 overlapping 250-sample
    windows (with ``default()``)."""

    electrodes: Tuple[str, ...] = ()
    zone_dict: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    dim_cnn: int = 32
    dim_token: int = 32
    seq_len: int = 800
    window_len: int = 250
    slide_step: int = 125
    head: str = "Conv4Layers"
    n_classes: int = 5
    num_layers: int = 4
    num_heads: int = 8
    dropout: float = 0.1

    def __post_init__(self):
        object.__setattr__(self, "electrodes", tuple(self.electrodes))
        object.__setattr__(
            self, "zone_dict", {k: tuple(v) for k, v in dict(self.zone_dict).items()}
        )

    @property
    def n_tokens(self) -> int:
        """Sliding-window token count."""
        return (self.seq_len - self.window_len) // self.slide_step + 1

    @property
    def n_zones(self) -> int:
        return len(self.zone_dict)

    @property
    def n_channels(self) -> int:
        return len(self.electrodes)

    @classmethod
    def default(cls) -> "FASTConfig":
        from .data.constants import Electrodes, Zones

        return cls(electrodes=tuple(Electrodes), zone_dict=Zones)


@dataclass(frozen=True)
class TrainConfig:
    """Training/optimization config (reference ``configs/default.yaml:23-41``)."""

    max_epochs: int = 200
    batch_size: int = 64
    learning_rate: float = 5e-4
    final_lr_scale: float = 0.1
    warmup_epochs: int = 10
    weight_decay: float = 0.01  # torch AdamW default
    seed: int = 42
    n_folds: int = 5
    shuffle_folds: bool = True
    precision: str = "bf16"  # compute dtype; params/optimizer stay f32
    forward_mode: str = "default"
    # 1 = validation every epoch; k > 1 validates every k-th epoch only.
    val_every: int = 1

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def compute_dtype(self):
        """``torch.bfloat16`` for ``"bf16"`` (the default), ``torch.float32``
        for ``"f32"``, as JAX ``TrainConfig.compute_dtype``; any other
        precision raises ``ValueError``."""
        import torch

        dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
        if self.precision not in dtypes:
            raise ValueError(f"unknown precision {self.precision!r}")
        return dtypes[self.precision]


@dataclass(frozen=True)
class DataConfig:
    """Data paths (reference ``configs/default.yaml:5-10``)."""

    raw_folder: str = "BCIC2020Track3"
    processed_folder: str = "data/processed"
    results_folder: str = "results"
    excel_labels: Optional[str] = None


@dataclass(frozen=True)
class ExperimentConfig:
    model: FASTConfig = field(default_factory=FASTConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)


_MODEL_KEYS = {f.name for f in dataclasses.fields(FASTConfig)}
_TRAIN_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}
_DATA_KEYS = {f.name for f in dataclasses.fields(DataConfig)}


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> ExperimentConfig:
    """An ``ExperimentConfig`` from the reference YAML schema (sections
    ``data`` / ``model`` / ``training`` / ``cv``; others are ignored, as
    unknown keys are) with flat ``overrides`` applied last: overrides > YAML >
    defaults, as ``load_config`` of the JAX package. PyYAML is imported
    here, only when ``path`` is given."""
    raw: Dict[str, Any] = {}
    if path is not None:
        import yaml

        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}

    model_kw: Dict[str, Any] = {}
    train_kw: Dict[str, Any] = {}
    data_kw: Dict[str, Any] = {}
    for k, v in (raw.get("model") or {}).items():
        if k in _MODEL_KEYS:
            model_kw[k] = v
    for k, v in (raw.get("training") or {}).items():
        if k == "precision":
            train_kw["precision"] = "bf16" if "bf16" in str(v) else "f32"
        elif k in _TRAIN_KEYS:
            train_kw[k] = v
    cv = raw.get("cv") or {}
    if "n_folds" in cv:
        train_kw["n_folds"] = cv["n_folds"]
    if "shuffle" in cv:
        train_kw["shuffle_folds"] = cv["shuffle"]
    for k, v in (raw.get("data") or {}).items():
        if k in _DATA_KEYS:
            data_kw[k] = v

    for k, v in (overrides or {}).items():
        if k in _MODEL_KEYS:
            model_kw[k] = v
        elif k in _TRAIN_KEYS:
            train_kw[k] = v
        elif k in _DATA_KEYS:
            data_kw[k] = v

    if "electrodes" not in model_kw or "zone_dict" not in model_kw:
        from .data.constants import Electrodes, Zones

        model_kw.setdefault("electrodes", tuple(Electrodes))
        model_kw.setdefault("zone_dict", Zones)
    return ExperimentConfig(model=FASTConfig(**model_kw), train=TrainConfig(**train_kw),
                            data=DataConfig(**data_kw))
