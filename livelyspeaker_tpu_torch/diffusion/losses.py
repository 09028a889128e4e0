"""Diffusion training losses and likelihood terms, in PyTorch.

Port of ``livelyspeaker_tpu/diffusion/losses.py``: the smooth-L1 (Huber,
beta 0.1, mean reduction) and masked-MSE training terms, the style token's
KLD, the normal KL and discretised Gaussian likelihood, the bits/dim chain,
and the parameter EMA. The model call is factored out as a closure,
``model_fn(x_t, t_model) -> {'output': ..., 'z_mu'?, 'z_logvar'?}``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch

from .sampling import (
    p_mean_variance,
    q_mean_variance,
    q_posterior_mean_variance,
    q_sample,
)
from .schedule import DiffusionSchedule

__all__ = [
    "huber",
    "huber_per_sample",
    "sum_flat",
    "mean_flat",
    "masked_l2",
    "normal_kl",
    "discretized_gaussian_log_likelihood",
    "kld_from_mu_logvar",
    "vb_terms_bpd",
    "calc_bpd_loop",
    "ema_update",
    "training_losses",
]

_LN2 = math.log(2.0)


def _smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    d = (pred - target) / beta
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def huber(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.1) -> torch.Tensor:
    """Scaled smooth-L1 ``smooth_l1(pred/beta, target/beta) * beta``, mean
    over every element."""
    return _smooth_l1(pred, target, beta).mean() * beta


def huber_per_sample(pred: torch.Tensor, target: torch.Tensor,
                     beta: float = 0.1) -> torch.Tensor:
    """Per-sample smooth-L1 means, [B]; their mean is :func:`huber`."""
    return mean_flat(_smooth_l1(pred, target, beta)) * beta


def sum_flat(x: torch.Tensor) -> torch.Tensor:
    return x.sum(tuple(range(1, x.ndim)))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(tuple(range(1, x.ndim)))


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample masked MSE over [B, J, F, T] with mask [B, 1, 1, T]."""
    mask = mask.to(a.dtype)
    loss = sum_flat((a - b) ** 2 * mask)
    return loss / (sum_flat(mask) * (a.shape[1] * a.shape[2]))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) in nats, elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a [-1, 1] image discretised to 255 bins."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def kld_from_mu_logvar(z_mu: torch.Tensor, z_logvar: torch.Tensor) -> torch.Tensor:
    """VAE KLD of the speaker-style token, a mean over every element."""
    return -0.5 * torch.mean(1 + z_logvar - z_mu ** 2 - torch.exp(z_logvar))


def vb_terms_bpd(
    sched: DiffusionSchedule,
    model_pred: torch.Tensor,
    x_start: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """The variational bound's term at t in bits/dim, for an x0 prediction:
    KL(q(x_{t-1}|x_t, x_0) || p(x_{t-1}|x_t)) for t > 0, the decoder NLL at
    t = 0."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_pred, x_t, t)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"],
                             out["log_variance"])) / _LN2
    decoder_nll = mean_flat(-discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])) / _LN2
    return {"output": torch.where(t == 0, decoder_nll, kl),
            "pred_xstart": out["pred_xstart"]}


def calc_bpd_loop(
    denoise_fn: Callable,
    sched: DiffusionSchedule,
    x_start: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Bits/dim over the whole chain, from t = T-1 down to 0: each step's VB
    term and x0 MSE, the prior term and the total.

    ``denoise_fn(x_t, t_model, generator) -> x0 prediction``. ``noise``
    ([T, *x_start.shape], in loop order) replaces the per-step draws."""
    b = x_start.shape[0]
    n = sched.num_timesteps
    dev = x_start.device
    vb, mse = [], []
    for k, i in enumerate(range(n - 1, -1, -1)):
        t = torch.full((b,), i, dtype=torch.long, device=dev)
        if noise is None:
            eps = torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                              device=generator.device if generator is not None else dev).to(dev)
        else:
            eps = noise[k]
        x_t = q_sample(sched, x_start, t, eps)
        pred = denoise_fn(x_t, sched.map_timesteps(t), generator)
        out = vb_terms_bpd(sched, pred, x_start, x_t, t)
        vb.append(out["output"])
        mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
    vb, mse = torch.stack(vb), torch.stack(mse)  # [T, B], descending t

    t_last = torch.full((b,), n - 1, dtype=torch.long, device=dev)
    qt_mean, _, qt_logvar = q_mean_variance(sched, x_start, t_last)
    kl_prior = normal_kl(qt_mean, qt_logvar, torch.zeros_like(qt_mean),
                         torch.zeros_like(qt_logvar))
    prior_bpd = mean_flat(kl_prior) / _LN2
    return {"total_bpd": vb.sum(0) + prior_bpd, "prior_bpd": prior_bpd,
            "vb": vb.t(), "mse": mse.t()}


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               new_params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """``e * decay + p * (1 - decay)`` for each parameter, as new tensors."""
    return {k: e * decay + new_params[k] * (1 - decay) for k, e in ema_params.items()}


def training_losses(
    model_fn: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
    sched: DiffusionSchedule,
    x_start: torch.Tensor,
    t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    mask: Optional[torch.Tensor] = None,
    loss_type: str = "huber",
    lambda_vel: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Diffusion training terms for one batch of (spaced) timesteps ``t``;
    the model sees ``sched.map_timesteps(t)`` and predicts x0.

    huber: the rotation and velocity terms are scalar means, and
    ``loss_per_sample`` their per-sample breakdown; mse: per-sample masked
    MSE. ``loss = rot_mse + lambda_vel * vel_mse``; the caller adds the
    weighted KLD. ``noise`` replaces the draw from ``generator``."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                            device=generator.device if generator is not None
                            else x_start.device).to(x_start.device)
    x_t = q_sample(sched, x_start, t, noise)

    out = model_fn(x_t, sched.map_timesteps(t))
    model_output = out["output"]

    if model_output.shape != x_start.shape:
        raise ValueError(f"model output {tuple(model_output.shape)} is not "
                         f"shaped like x_start {tuple(x_start.shape)}")

    vel = lambda a: a[..., 1:] - a[..., :-1]
    terms: Dict[str, torch.Tensor] = {}
    if loss_type == "huber":
        rot_ps = huber_per_sample(x_start, model_output)
        terms["rot_mse"] = rot_ps.mean()
        terms["loss_per_sample"] = rot_ps
        if lambda_vel > 0.0:
            vel_ps = huber_per_sample(vel(x_start), vel(model_output))
            terms["vel_mse"] = vel_ps.mean()
            terms["loss_per_sample"] = rot_ps + lambda_vel * vel_ps
    elif loss_type == "mse":
        if mask is None:
            mask = torch.ones((x_start.shape[0], 1, 1, x_start.shape[-1]),
                              dtype=x_start.dtype, device=x_start.device)
        elif mask.ndim == 2:
            mask = mask[:, None, None, :]
        terms["rot_mse"] = masked_l2(x_start, model_output, mask)
        if lambda_vel > 0.0:
            terms["vel_mse"] = masked_l2(vel(x_start), vel(model_output), mask[..., 1:])
    else:
        raise NotImplementedError(loss_type)

    if "z_mu" in out:
        terms["kld"] = kld_from_mu_logvar(out["z_mu"], out["z_logvar"])

    terms["loss"] = terms["rot_mse"] + lambda_vel * terms.get("vel_mse", 0.0)
    if "loss_per_sample" not in terms:
        terms["loss_per_sample"] = terms["loss"]  # mse: already [B]
    return terms
