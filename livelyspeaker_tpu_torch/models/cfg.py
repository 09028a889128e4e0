"""Classifier-free guidance as a batched denoiser closure.

Port of ``livelyspeaker_tpu/models/cfg.py``: the cond and uncond passes run
as one forward of 2B rows (cond half first), and the audio is encoded once
before the diffusion loop.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

__all__ = ["make_cfg_denoiser", "make_guidance_schedule", "scheduled_scale",
           "guidance_scale_tensor", "duplicate_cond"]


def make_guidance_schedule(
    name: Optional[str], t_boundary: int
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Per-step CFG weight ``w(t) in [0, 1]`` over original-process
    timesteps; the guided combine is ``out_u + (1 + (scale-1) w(t))
    (out_c - out_u)``. ``t_boundary`` is the highest timestep the denoiser
    sees, so 'linear' and 'cosine' span the executed window.

    None/'const' -> None (no-op); 'linear' -> t/t_boundary; 'cosine' ->
    0.5 (1 - cos(pi t/t_boundary)); 'step:T0' -> 1 if t >= T0 else 0."""
    if name is None or name == "const":
        return None
    tb = float(max(int(t_boundary), 1))
    if name == "linear":
        return lambda t: torch.clamp(t.to(torch.float32) / tb, 0.0, 1.0)
    if name == "cosine":
        return lambda t: 0.5 * (
            1.0 - torch.cos(math.pi * torch.clamp(t.to(torch.float32) / tb, 0.0, 1.0))
        )
    if name.startswith("step:"):
        t0 = float(name.split(":", 1)[1])
        return lambda t: (t.to(torch.float32) >= t0).to(torch.float32)
    raise ValueError(
        f"unknown guidance schedule {name!r}; expected 'const', 'linear', "
        "'cosine' or 'step:<t0>'"
    )


def scheduled_scale(scale: torch.Tensor, guidance_schedule, t: torch.Tensor,
                    b: int) -> torch.Tensor:
    """[B,1,1,1] effective scale at original-process timesteps ``t`` [B]."""
    if guidance_schedule is None:
        return scale
    w = guidance_schedule(t).reshape(b, 1, 1, 1)
    return 1.0 + (scale - 1.0) * w


def guidance_scale_tensor(guidance_scale, b: int, device) -> torch.Tensor:
    """A scalar or per-sample [B] guidance scale as [B, 1, 1, 1] f32."""
    scale = torch.as_tensor(guidance_scale, dtype=torch.float32, device=device)
    if scale.ndim == 0:
        scale = scale.expand(b)
    return scale.reshape(b, 1, 1, 1)


def duplicate_cond(cond: Dict[str, torch.Tensor], b: int, device):
    """The 2B-row conditioning of a CFG batch: every entry but the audio
    twice, with ``cond_drop`` 0 on the first half and 1 on the second."""
    cond2 = {k: torch.cat([v, v]) for k, v in cond.items()
             if k not in ("audio", "cond_drop")}
    cond2["cond_drop"] = torch.cat(
        [torch.zeros(b, device=device), torch.ones(b, device=device)]
    )
    return cond2


def make_cfg_denoiser(
    model,
    cond: Dict[str, torch.Tensor],
    guidance_scale,
    *,
    batch: Optional[int] = None,
    guidance_schedule=None,
):
    """Guided denoiser closure ``(x, t, generator) -> x0_hat``:
    out_uncond + scale * (out_cond - out_uncond), both passes in one batch.
    ``guidance_scale`` is a scalar or a per-sample [B] tensor."""
    b = batch if batch is not None else cond["vid"].shape[0]
    device = cond["vid"].device
    audio_feats = model.encode_audio(cond["audio"])
    audio_feats2 = torch.cat([audio_feats, audio_feats])
    cond2 = duplicate_cond(cond, b, device)
    scale = guidance_scale_tensor(guidance_scale, b, device)

    def denoise_fn(x, t, generator=None):
        out = model(torch.cat([x, x]), torch.cat([t, t]), cond2,
                    audio_feats=audio_feats2, generator=generator)["output"]
        out_cond, out_uncond = out[:b], out[b:]
        s = scheduled_scale(scale, guidance_schedule, t, b)
        return out_uncond + s * (out_cond - out_uncond)

    return denoise_fn
