"""The products through which a tensor-parallel replica routes its ruled
weights.

Each function takes a weight that is a tensor, and then computes exactly
what the model computed before (the same ops, the same bits), or a weight
that a tensor-parallel replica holds in slices
(``parallel/tensor_parallel.py``: ``TPWeight`` or ``Split``), which then
computes its own column-, row-parallel or embedding product. The models
call these where they use a ruled weight outside an ``nn.Linear`` or
``nn.Embedding`` call: the channel mix and the timestep MLP
(``mlp_backbone.py``), the packed attention projections
(``transformer.py``, ``clip_text.py``) and CLIP's token table.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["linear", "lookup", "in_projection"]


def linear(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """``F.linear(x, w, b)``."""
    if isinstance(w, torch.Tensor):
        return F.linear(x, w, b)
    return w.linear(x, b)


def lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``."""
    if isinstance(table, torch.Tensor):
        return table[ids]
    return table.lookup(ids)


def in_projection(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, w, b,
                  d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v of a packed [3D, D] projection ``w`` (bias ``b`` [3D]).
    Split on its 3D outputs, the cut falls across q|k|v: each distinct input
    gets the whole gathered projection, which is then split into the three."""
    if isinstance(w, torch.Tensor):
        return (query @ w[:d].T + b[:d], key @ w[d:2 * d].T + b[d:2 * d],
                value @ w[2 * d:].T + b[2 * d:])
    full = {}
    for x in (query, key, value):
        if id(x) not in full:
            full[id(x)] = w.linear(x, b)
    return full[id(query)][..., :d], full[id(key)][..., d:2 * d], full[id(value)][..., 2 * d:]
