"""BCI Competition 2020 Track #3 montage, zone atlas and zone geometry.

Counterpart of ``imagined_speech_decoding_tpu/data/constants.py``
(``NAME``, ``SUBJECTS``, ``CLASSES``, ``Electrodes``, ``Zones``, ``SFREQ``,
``zone_layout``), restated here
because importing the JAX package's module imports ``jax``. A CPU test
holds both field for field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

NAME = "BCIC2020Track3"
SUBJECTS: Tuple[str, ...] = tuple(f"{i:02d}" for i in range(1, 16))
CLASSES: Tuple[str, ...] = ("hello", "help-me", "stop", "thank-you", "yes")
TARGET_TIMEPOINTS = 800  # trials are padded 795 -> 800 samples
SFREQ = 250  # Hz

# 64-channel montage, in recorded channel order.
Electrodes: Tuple[str, ...] = (
    "Fp1", "Fp2", "F7", "F3", "Fz", "F4", "F8", "FC5", "FC1", "FC2", "FC6",
    "T7", "C3", "Cz", "C4", "T8", "TP9", "CP5", "CP1", "CP2", "CP6", "TP10",
    "P7", "P3", "Pz", "P4", "P8", "PO9", "O1", "Oz", "O2", "PO10", "AF7",
    "AF3", "AF4", "AF8", "F5", "F1", "F2", "F6", "FT9", "FT7", "FC3", "FC4",
    "FT8", "FT10", "C5", "C1", "C2", "C6", "TP7", "CP3", "CPz", "CP4", "TP8",
    "P5", "P1", "P2", "P6", "PO7", "PO3", "POz", "PO4", "PO8",
)

# Functional brain-area atlas: 8 zones covering all 64 channels exactly once.
Zones: Dict[str, Tuple[str, ...]] = {
    "Pre-frontal": ("AF7", "Fp1", "Fp2", "AF8", "AF3", "AF4"),
    "Frontal": ("F7", "F5", "F3", "F1", "Fz", "F2", "F4", "F6", "F8"),
    "Pre-central": ("FC1", "FC2", "FC3", "FC4", "FC5", "FC6"),
    "Central": ("C1", "C2", "C3", "Cz", "C4", "C5", "C6"),
    "Post-central": ("CP1", "CP2", "CP3", "CPz", "CP4", "CP5", "CP6"),
    "Temporal": ("T7", "T8", "FT7", "FT8", "TP7", "TP8", "TP9", "TP10", "FT9", "FT10"),
    "Parietal": (
        "P1", "P2", "P3", "P4", "Pz", "P5", "P6", "P7", "P8",
        "PO3", "PO4", "PO7", "PO8", "PO9", "PO10",
    ),
    "Occipital": ("O1", "O2", "Oz", "POz"),
}


@dataclass(frozen=True)
class ZoneLayout:
    """Dense ``(Z, C_max)`` zone geometry: montage index of each zone slot
    (padded slots point at channel 0), the real-slot mask, and per-zone
    channel counts."""

    names: Tuple[str, ...]
    indices: np.ndarray
    mask: np.ndarray
    counts: np.ndarray

    @property
    def n_zones(self) -> int:
        return len(self.names)

    @property
    def c_max(self) -> int:
        return int(self.indices.shape[1])


def zone_layout(
    electrodes: Sequence[str] = Electrodes,
    zones: Dict[str, Sequence[str]] = Zones,
    c_max: int | None = None,
) -> ZoneLayout:
    """Build the dense ``(Z, C_max)`` index/mask arrays for a zone atlas;
    every zone is padded to the widest one."""
    electrodes = list(electrodes)
    names = tuple(zones.keys())
    counts = np.array([len(zones[z]) for z in names], dtype=np.int32)
    width = int(counts.max()) if c_max is None else int(c_max)
    if width < counts.max():
        raise ValueError(f"c_max={width} smaller than widest zone ({counts.max()})")

    indices = np.zeros((len(names), width), dtype=np.int32)
    mask = np.zeros((len(names), width), dtype=bool)
    for zi, zname in enumerate(names):
        for ci, ch in enumerate(zones[zname]):
            try:
                indices[zi, ci] = electrodes.index(ch)
            except ValueError as e:
                raise ValueError(f"zone {zname!r} channel {ch!r} not in montage") from e
            mask[zi, ci] = True
    return ZoneLayout(names=names, indices=indices, mask=mask, counts=counts)
