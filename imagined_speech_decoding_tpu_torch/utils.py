"""Host helpers restated from ``imagined_speech_decoding_tpu/utils.py``."""

from __future__ import annotations

import random

import numpy as np


def seed_all(seed: int) -> int:
    """Seed Python's and numpy's global generators, as the JAX package's
    ``seed_all`` does before a run (the port's own randomness comes from
    seeded generators of its own). Returns ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    return seed
