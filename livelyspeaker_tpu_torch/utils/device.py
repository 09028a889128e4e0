"""Where an entry point runs: on the card unless the caller asks otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["place_model", "resolve_device"]


def place_model(model: torch.nn.Module, device: Optional[Union[str, torch.device]],
                who: str) -> torch.device:
    """Move ``model`` to the device an entry point runs on, and return it.

    ``device=None`` means the card: a model already on a CUDA device stays
    there, any other is moved to ``cuda``, and without a CUDA device this
    raises (no quiet CPU run). An explicit ``device``, ``"cpu"`` included,
    is taken as given."""
    if device is None:
        current = next(model.parameters()).device
        if current.type == "cuda":
            return current
    device = resolve_device(device, who)
    model.to(device)
    return next(model.parameters()).device


def resolve_device(device: Optional[Union[str, torch.device]], who: str) -> torch.device:
    """The device an entry point runs on, by :func:`place_model`'s rule,
    for one that has no model yet: ``None`` is ``cuda`` and raises without
    a CUDA device; an explicit device is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on an NVIDIA GPU by default and torch.cuda.is_available() is "
                'False; pass device="cpu" to run the plain PyTorch versions on the CPU')
        device = "cuda"
    return torch.device(device)
