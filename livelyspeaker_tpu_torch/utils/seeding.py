"""Seeding discipline (reference: scripts/mdm_utils/fixseed.py:6-10 and the
loaders' module-level seeds, ted_loader.py:12-15).

Port of ``livelyspeaker_tpu/utils/seeding.py``. The port draws its device
randomness from explicit ``torch.Generator`` objects, so the global state to
pin is Python's and numpy's (data shuffling, the eval's speaker choice);
``fixseed`` returns the seeded generator the rest should draw from, where
the JAX function returns its master key.
"""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["fixseed"]


def fixseed(seed: int = 233, device=None) -> torch.Generator:
    """Pin the host-side RNGs and return a ``torch.Generator`` seeded with
    ``seed`` (on ``device``, the CPU by default)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)
