"""Seeded weights of the language model text tower, made on the device in
one draw.

As ``benchmark/weights.py`` (one ``torch.randn`` of every element, from a
generator seeded by ``--seed`` and the tower's name, cut into the tensors
and scaled by a rule on each name and shape), with the rule of a
DeepSeek-V3 stack, whose experts are stacked [E, out, in]: every product's
fan-in is its last dimension. The tensors are the program's parameters
(the port's module is built on the meta device and takes them with
``load_state_dict(..., assign=True)``) and the plain reference's inputs:
62.5 GB at Moonlight's sizes, held once.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .weights import derive_seed

__all__ = ["seeded_tensors", "scale_rule"]


def scale_rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(scale, offset) of a tensor of standard normals: biases (the
    adapter's, the routers' score corrections) 0.02 N, RMSNorm gains 1 +
    0.1 N, the embedding unit normal, every product's weight normal with
    variance 1 / its last dimension."""
    leaf = name.rsplit(".", 1)[-1]
    if "bias" in leaf:
        return 0.02, 0.0
    if len(shape) == 1:
        return 0.1, 1.0
    if "embed" in name:
        return 1.0, 0.0
    return 1.0 / math.sqrt(shape[-1]), 0.0


@torch.no_grad()
def seeded_tensors(shapes: Dict[str, Tuple[int, ...]], seed: int, tag: str,
                   device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``shapes``, f32 on ``device``, views of one draw of
    a generator seeded by ``seed`` and ``tag``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", tag))
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, offset = scale_rule(name, shape)
        out[name] = flat[at: at + n].view(shape).mul_(scale).add_(offset)
        at += n
    return out
