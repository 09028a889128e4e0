"""Seeded initialisers that mirror Flax's, for modules built without JAX.

Flax stores a Dense kernel as ``[in, out]`` and a Conv kernel as
``[k, in, out]``; torch stores ``[out, in]`` and ``[out, in, k]``. The fans
below are computed the Flax way from the torch shapes, so a torch module
initialised here has the same distribution as its Flax counterpart (the
numbers differ: the generators differ).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["lecun_normal_", "dense_default_", "conv_default_", "xavier_uniform_",
           "random_normal_"]

# Flax's truncated_normal(stddev) draws from N(0, 1) cut at +-2 and rescales
# by this constant so the variance of the cut distribution is stddev**2.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(
    w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """variance_scaling(1, fan_in, truncated_normal) in place."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


def xavier_uniform_(
    w: torch.Tensor, gain: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """variance_scaling(gain**2, fan_avg, uniform) on a torch Linear weight."""
    with torch.no_grad():
        return nn.init.xavier_uniform_(w, gain=gain, generator=generator)


def dense_default_(
    layer: nn.Linear, generator: Optional[torch.Generator] = None
) -> nn.Linear:
    """Flax ``Dense`` defaults: lecun-normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


@torch.no_grad()
def random_normal_(
    module: nn.Module, generator: Optional[torch.Generator] = None
) -> nn.Module:
    """Overwrite every parameter with normals of unit-fan-in scale: std
    1/sqrt(fan_in) for a matrix or conv kernel, 1 for an embedding table,
    1 + 0.1 N for a LayerNorm scale and 0.1 N for any other vector.

    The trained-from-scratch init leaves the channel mix near 1e-8 and the
    embeddings at 1e-6; weights of this scale exercise every path."""
    for name, p in module.named_parameters():
        z = torch.randn(p.shape, generator=generator, device=generator.device
                        if generator is not None else p.device).to(p.device)
        leaf = name.rsplit(".", 1)[-1]
        parent = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if isinstance(parent, nn.Embedding):
            p.copy_(z)
        elif p.ndim >= 2:  # Linear [out, in], Conv1d [out, in, k], token mix
            fan_in = p[0].numel()
            p.copy_(z / math.sqrt(fan_in))
        elif isinstance(parent, nn.LayerNorm) and leaf == "weight":
            p.copy_(1.0 + 0.1 * z)
        else:
            p.copy_(0.1 * z)
    return module


def conv_default_(
    layer: nn.Conv1d, generator: Optional[torch.Generator] = None
) -> nn.Conv1d:
    """Flax ``Conv`` defaults: lecun-normal over fan_in = k * in, zero bias."""
    lecun_normal_(
        layer.weight, layer.in_channels * layer.kernel_size[0], generator
    )
    with torch.no_grad():
        layer.bias.zero_()
    return layer
