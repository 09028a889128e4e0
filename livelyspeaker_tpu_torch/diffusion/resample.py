"""Timestep samplers for training, in PyTorch.

Port of ``livelyspeaker_tpu/diffusion/resample.py``: uniform sampling with
unit weights, and loss-second-moment importance sampling whose history (a
[T, 10] table and [T] counts, small) is kept on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "uniform_sample_t",
    "LossSecondMomentState",
    "loss_aware_sample_t",
    "loss_aware_update",
]


def _gen_device(generator: Optional[torch.Generator], device) -> torch.device:
    return generator.device if generator is not None else torch.device(device)


def uniform_sample_t(
    generator: Optional[torch.Generator], batch: int, num_timesteps: int,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """t uniform in [0, num_timesteps), with unit weights; on ``device``."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=_gen_device(generator, device)).to(device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


@dataclasses.dataclass
class LossSecondMomentState:
    """The per-timestep loss history of the importance sampler."""

    history: torch.Tensor  # [T, history_per_term] f32
    counts: torch.Tensor  # [T] int32
    uniform_prob: float = 0.001

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10,
               uniform_prob: float = 0.001) -> "LossSecondMomentState":
        return cls(
            history=torch.zeros((num_timesteps, history_per_term), dtype=torch.float32),
            counts=torch.zeros((num_timesteps,), dtype=torch.int32),
            uniform_prob=uniform_prob,
        )

    @property
    def history_per_term(self) -> int:
        return self.history.shape[1]

    def weights(self) -> torch.Tensor:
        """sqrt(E[loss^2]) per timestep, normalised and mixed with
        ``uniform_prob`` of the uniform law; all ones until every timestep
        has a full history."""
        if not bool((self.counts == self.history_per_term).all()):
            return torch.ones(self.history.shape[0], dtype=torch.float32)
        w = torch.sqrt((self.history ** 2).mean(-1))
        w = w / torch.clamp(w.sum(), min=1e-12)
        return w * (1 - self.uniform_prob) + self.uniform_prob / w.shape[0]


def loss_aware_sample_t(
    state: LossSecondMomentState, generator: Optional[torch.Generator],
    batch: int, device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """t drawn with probability proportional to the history weights, and
    the importance weights 1 / (T p(t)); on ``device``."""
    w = state.weights()
    p = w / w.sum()
    gdev = _gen_device(generator, device)
    t = torch.multinomial(p.to(gdev), batch, replacement=True, generator=generator)
    weights = 1.0 / (w.shape[0] * p.to(gdev)[t])
    return t.to(device), weights.to(device, torch.float32)


def loss_aware_update(
    state: LossSecondMomentState, t: torch.Tensor, losses: torch.Tensor
) -> LossSecondMomentState:
    """Append each (t, loss) of the batch to the history, in batch order.

    Whether a timestep's row is full is decided once, from the counts before
    the batch, as the JAX scan does: a row that was full shifts left and
    takes the loss at its end for every occurrence; a row that was not
    writes at its running count, and once that reaches the end each further
    occurrence in the batch overwrites the last slot, so the last one
    stands."""
    hist = state.history.numpy().copy()
    counts = state.counts.numpy().copy()
    hpt = state.history_per_term
    t_np = t.detach().cpu().numpy()
    l_np = losses.detach().to("cpu", torch.float32).numpy()
    full = counts[t_np] == hpt
    for ti, li, is_full in zip(t_np, l_np, full):
        if is_full:
            hist[ti, :-1] = hist[ti, 1:].copy()
            hist[ti, -1] = li
        else:
            hist[ti, min(counts[ti], hpt - 1)] = li
        counts[ti] = min(counts[ti] + 1, hpt)
    return dataclasses.replace(state, history=torch.from_numpy(hist),
                               counts=torch.from_numpy(counts))
