"""Seeded weights, made on the device in one draw.

The benchmark, not the program, makes every weight: one ``torch.randn`` of
all the elements a model has, from a ``torch.Generator`` on the card seeded
by ``--seed`` and the model's name, cut into the model's tensors and scaled
by a rule on each tensor's name and shape. The program's modules load a
copy; the plain reference reads the same tensors.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["derive_seed", "seeded_tensors", "shapes_of"]


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit generator seed for ``seed`` and ``tags`` (ints or strings),
    the same on every machine."""
    words = [int(seed) & (2 ** 64 - 1)] + [
        zlib.crc32(t.encode()) if isinstance(t, str) else int(t) & (2 ** 64 - 1) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The name and shape of each tensor of ``module``'s state dict."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(scale, offset) of a tensor of standard normals: biases small, the
    LayerNorms' gains near 1, embeddings unit normal, every other weight
    normal with variance 1 / fan-in (the product of its trailing sizes)."""
    leaf = name.rsplit(".", 1)[-1]
    if "bias" in leaf:
        return 0.02, 0.0
    if len(shape) == 1:
        return 0.1, 1.0
    if "embedding" in name:
        return 1.0, 0.0
    return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0


@torch.no_grad()
def seeded_tensors(shapes: Dict[str, Tuple[int, ...]], seed: int, tag: str,
                   device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``shapes``, f32 on ``device``, cut from one draw of
    a generator seeded by ``seed`` and ``tag``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", tag))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, offset = _rule(name, shape)
        out[name] = flat[at: at + n].view(shape).mul_(scale).add_(offset)
        at += n
    return out
