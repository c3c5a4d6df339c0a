"""FAST architecture config.

Counterpart of ``FASTConfig`` in ``imagined_speech_decoding_tpu/config.py``
with the same fields and defaults, restated here because the JAX
package's module imports ``yaml`` and its ``default()`` imports ``jax``.
A CPU test holds both field for field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


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
