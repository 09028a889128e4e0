"""Diffusion noise schedules as precomputed tables of tensors.

Port of ``livelyspeaker_tpu/diffusion/schedule.py``: named beta schedules,
timestep respacing and the derived per-step buffers of a Gaussian diffusion.
The tables are computed in float64 NumPy and stored as float32 tensors, as in
the JAX package. Move a schedule to the device with :meth:`DiffusionSchedule.to`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "space_timesteps",
    "DiffusionSchedule",
]


def get_named_beta_schedule(
    schedule_name: str, num_diffusion_timesteps: int, scale_betas: float = 1.0
) -> np.ndarray:
    """``linear`` (Ho et al., rescaled to any step count) or ``cosine``
    (Nichol & Dhariwal) betas, float64."""
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(
    num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999
) -> np.ndarray:
    """Discretise a continuous alpha-bar function into float64 betas."""
    t = np.arange(num_diffusion_timesteps, dtype=np.float64)
    t1 = t / num_diffusion_timesteps
    t2 = (t + 1) / num_diffusion_timesteps
    ab1 = np.array([alpha_bar(float(x)) for x in t1], dtype=np.float64)
    ab2 = np.array([alpha_bar(float(x)) for x in t2], dtype=np.float64)
    return np.minimum(1.0 - ab2 / ab1, max_beta)


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Original timesteps a respaced process keeps: a list of per-section
    step counts, a comma string, or ``"ddimN"`` for fixed DDIM striding."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired_count:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}"
            )
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(section_count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep constants of a (possibly respaced) Gaussian diffusion.

    ``timestep_map`` maps a spaced index to the timestep the model was
    trained on (the identity without respacing)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: torch.Tensor
    num_timesteps: int
    original_num_steps: int

    @classmethod
    def from_betas(
        cls,
        betas: np.ndarray,
        use_timesteps: Iterable[int] | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> "DiffusionSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        original_num_steps = len(betas)

        if use_timesteps is not None:
            use_timesteps = sorted(set(int(t) for t in use_timesteps))
            base_acp = np.cumprod(1.0 - betas)
            last = 1.0
            new_betas = []
            for i in use_timesteps:
                new_betas.append(1.0 - base_acp[i] / last)
                last = base_acp[i]
            betas = np.array(new_betas, dtype=np.float64)
            timestep_map = np.array(use_timesteps, dtype=np.int64)
        else:
            timestep_map = np.arange(original_num_steps, dtype=np.int64)

        n = len(betas)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)

        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
        # t=0's posterior variance is 0: clip with the t=1 value; a length-1
        # chain has no t=1 and takes a tiny floor instead.
        if n > 1:
            posterior_log_variance_clipped = np.log(
                np.append(posterior_variance[1], posterior_variance[1:])
            )
        else:
            posterior_log_variance_clipped = np.log(np.array([1e-20]))

        as_t = lambda a: torch.tensor(a, dtype=dtype)
        return cls(
            betas=as_t(betas),
            alphas_cumprod=as_t(acp),
            alphas_cumprod_prev=as_t(acp_prev),
            alphas_cumprod_next=as_t(acp_next),
            sqrt_alphas_cumprod=as_t(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=as_t(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=as_t(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=as_t(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=as_t(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=as_t(posterior_variance),
            posterior_log_variance_clipped=as_t(posterior_log_variance_clipped),
            posterior_mean_coef1=as_t(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=as_t(
                (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)
            ),
            log_betas=as_t(np.log(betas)),
            timestep_map=torch.from_numpy(timestep_map),
            num_timesteps=n,
            original_num_steps=original_num_steps,
        )

    @classmethod
    def create(
        cls,
        *,
        steps: int = 1000,
        schedule: str = "cosine",
        timestep_respacing: str | Sequence[int] | None = None,
        scale_betas: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ) -> "DiffusionSchedule":
        """Named betas plus optional respacing."""
        betas = get_named_beta_schedule(schedule, steps, scale_betas)
        use = None
        if timestep_respacing:
            use = space_timesteps(steps, timestep_respacing)
        return cls.from_betas(betas, use_timesteps=use, dtype=dtype)

    def to(self, device) -> "DiffusionSchedule":
        """The same schedule with every table on ``device``."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    def map_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Spaced index -> original training timestep."""
        return self.timestep_map[t]
