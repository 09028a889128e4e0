"""Diffusion posterior math and the reverse sampling loop, in PyTorch.

Port of the main-path subset of ``livelyspeaker_tpu/diffusion/sampling.py``:
the q/p posterior functions with the fixed variances, and ``sample_loop``
for DDPM, DDIM and DPM-Solver++(2M). A Python loop stands in for
``lax.scan``; every per-step quantity stays on the device.

``denoise_fn(x, t_model, generator) -> prediction`` is the model contract: it
receives the original-process timesteps (the ``timestep_map`` remapping is
applied here) and returns the model's prediction (x0 by default).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Optional

import torch

from .schedule import DiffusionSchedule

__all__ = [
    "VarType",
    "extract",
    "q_sample",
    "q_mean_variance",
    "q_posterior_mean_variance",
    "predict_xstart_from_eps",
    "predict_eps_from_xstart",
    "predict_xstart_from_xprev",
    "p_mean_variance",
    "sample_loop",
]


class VarType(str, enum.Enum):
    """Reverse-process variance (learned variances are not supported)."""

    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep scalars, broadcastable against an ``ndim`` tensor."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Sample q(x_t | x_0)."""
    nd = x_start.ndim
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """Moments of q(x_t | x_0): (mean, variance, log variance)."""
    nd = x_start.ndim
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_start,
            extract(1.0 - sched.alphas_cumprod, t, nd),
            extract(sched.log_one_minus_alphas_cumprod, t, nd))


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    """Moments of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.ndim
    mean = (extract(sched.posterior_mean_coef1, t, nd) * x_start
            + extract(sched.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(sched.posterior_variance, t, nd),
            extract(sched.posterior_log_variance_clipped, t, nd))


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    nd = x_t.ndim
    return (extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    nd = x_t.ndim
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))


def predict_xstart_from_xprev(sched: DiffusionSchedule, x_t, t, xprev):
    nd = x_t.ndim
    return (extract(1.0 / sched.posterior_mean_coef1, t, nd) * xprev
            - extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, nd) * x_t)


def p_mean_variance(
    sched: DiffusionSchedule,
    model_pred: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    var_type: VarType = VarType.FIXED_SMALL,
) -> Dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) moments from the model's x0 prediction (the RAG
    predicts x0; the JAX package's other mean types have no caller here)."""
    nd = x.ndim
    if var_type == VarType.FIXED_SMALL:
        variance = extract(sched.posterior_variance, t, nd)
        log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    else:  # FIXED_LARGE: betas, with posterior_variance[1] at t=0
        large = torch.cat([sched.posterior_variance[1:2], sched.betas[1:]])
        variance = extract(large, t, nd)
        log_variance = torch.log(variance)
    mean, _, _ = q_posterior_mean_variance(sched, model_pred, x, t)
    return {"mean": mean, "variance": variance, "log_variance": log_variance,
            "pred_xstart": model_pred}


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return (t != 0).to(torch.float32).reshape((-1,) + (1,) * (ndim - 1))


def _ddpm_update(sched, out, x, t, noise):
    """Ancestral step."""
    return out["mean"] + _nonzero_mask(t, x.ndim) * torch.exp(
        0.5 * out["log_variance"]) * noise


def _ddim_update(sched, out, x, t, noise, eta):
    """DDIM step, eq. 12 of Song et al."""
    nd = x.ndim
    eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
    alpha_bar = extract(sched.alphas_cumprod, t, nd)
    alpha_bar_prev = extract(sched.alphas_cumprod_prev, t, nd)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(
        torch.clamp(1 - alpha_bar_prev - sigma ** 2, min=0.0)) * eps
    return mean_pred + _nonzero_mask(t, nd) * sigma * noise


def _randn(shape, generator, device):
    dev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=dev).to(device)


@torch.no_grad()
def sample_loop(
    denoise_fn: Callable,
    sched: DiffusionSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    *,
    method: str = "ddpm",
    eta: float = 0.0,
    var_type: VarType = VarType.FIXED_SMALL,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the reverse diffusion in f32 on the device ``sched`` is on.

    method: "ddpm" (ancestral), "ddim" or "dpmpp" (DPM-Solver++(2M), data
    prediction, multistep). With ``skip_timesteps`` the chain starts
    ``skip_timesteps`` steps late from ``init_image`` (zeros if absent)
    q_sample-noised to that step. ``noise`` replaces the initial draw."""
    if method not in ("ddpm", "ddim", "dpmpp"):
        raise ValueError(f"unsupported sampler {method!r}")
    n_steps = sched.num_timesteps - skip_timesteps
    if n_steps < 1:
        raise ValueError(f"skip_timesteps {skip_timesteps} leaves no step of "
                         f"{sched.num_timesteps}")
    device = sched.betas.device
    batch = shape[0]

    img = (_randn(shape, generator, device) if noise is None
           else noise.to(device, torch.float32))
    if skip_timesteps and init_image is None:
        init_image = torch.zeros(shape, device=device)
    if init_image is not None:
        t0 = torch.full((batch,), n_steps - 1, dtype=torch.long, device=device)
        img = q_sample(sched, init_image.to(device, torch.float32), t0, img)

    def step_out(x, i):
        t = torch.full((batch,), i, dtype=torch.long, device=device)
        pred = denoise_fn(x, sched.map_timesteps(t), generator)
        return p_mean_variance(sched, pred, x, t, var_type=var_type), t

    x = img
    if method in ("ddpm", "ddim"):
        for i in range(n_steps - 1, -1, -1):
            out, t = step_out(x, i)
            step_noise = _randn(x.shape, generator, device)
            if method == "ddpm":
                x = _ddpm_update(sched, out, x, t, step_noise)
            else:
                x = _ddim_update(sched, out, x, t, step_noise, eta)
        return x

    # DPM-Solver++(2M), data-prediction form (Lu et al. 2022):
    # lambda = log(alpha / sigma) with alpha = sqrt(acp), sigma = sqrt(1-acp),
    # in f32 from the f32 tables; the last step (t=0) returns pred_xstart.
    acp = sched.alphas_cumprod
    acp_prev = sched.alphas_cumprod_prev
    log_lambda = 0.5 * (torch.log(acp) - torch.log1p(-acp))
    # lambda at the destination of step i (t-1 in the spaced chain)
    log_lambda_prev = 0.5 * (torch.log(acp_prev)
                             - torch.log(torch.clamp(1.0 - acp_prev, min=1e-20)))
    alpha_next_t = torch.sqrt(acp_prev)
    sigma_next_t = torch.sqrt(torch.clamp(1.0 - acp_prev, min=0.0))
    sigma_cur_t = torch.sqrt(1.0 - acp)
    d_prev = h_prev = None
    for i in range(n_steps - 1, 0, -1):
        d = step_out(x, i)[0]["pred_xstart"]
        h = log_lambda_prev[i] - log_lambda[i]
        if d_prev is None:
            d_tilde = d
        else:  # 2M correction: (1 + 1/(2r)) D_i - 1/(2r) D_{i-1}
            r = h_prev / torch.where(h == 0, torch.ones_like(h), h)
            coef = 1.0 / torch.clamp(2.0 * r, min=1e-20)
            d_tilde = (1.0 + coef) * d - coef * d_prev
        x = (sigma_next_t[i] / sigma_cur_t[i]) * x - alpha_next_t[i] * (
            torch.exp(-h) - 1.0) * d_tilde
        d_prev, h_prev = d, h
    return step_out(x, 0)[0]["pred_xstart"]  # the last step lands on x0
