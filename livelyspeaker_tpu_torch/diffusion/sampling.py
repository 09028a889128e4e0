"""Diffusion posterior math and the reverse sampling loops, in PyTorch.

Port of ``livelyspeaker_tpu/diffusion/sampling.py``: the q/p posterior
functions with the fixed variances and every mean type, inpainting in time,
classifier guidance (``cond_fn``), ``sample_loop`` for DDPM, DDIM, PLMS and
DPM-Solver++(2M) with its trajectory and dump forms, and the deterministic
DDIM encoder (``reverse_loop``). A Python loop stands in for ``lax.scan``;
every per-step quantity stays on the device.

``denoise_fn(x, t_model, generator) -> prediction`` is the model contract: it
receives the original-process timesteps (the ``timestep_map`` remapping is
applied here) and returns the model's prediction (x0 by default).

Every random draw of a chain comes from the one ``generator`` it is given,
in a fixed order: the initial noise, then each step's denoiser draws, its
inpainting blend noise and its step noise.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..utils.profiling import annotate
from .schedule import DiffusionSchedule

__all__ = [
    "MeanType",
    "VarType",
    "extract",
    "q_sample",
    "q_mean_variance",
    "q_posterior_mean_variance",
    "predict_xstart_from_eps",
    "predict_eps_from_xstart",
    "predict_xstart_from_xprev",
    "p_mean_variance",
    "Inpainting",
    "condition_mean",
    "condition_score",
    "ddim_reverse_step",
    "reverse_loop",
    "sample_loop",
    "sample_loop_with_dump",
]

METHODS = ("ddpm", "ddim", "plms", "dpmpp")


class MeanType(str, enum.Enum):
    """What the model predicts."""

    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


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


class Inpainting(NamedTuple):
    """Inpainting in time: ``mask`` (bool, broadcastable against the
    sample) is True where frames are held to ``motion``. ``noised=True``
    blends a copy of the constraint q-sampled to t-1 (the TED tree),
    ``noised=False`` the clean constraint (the BEAT tree)."""

    mask: torch.Tensor
    motion: torch.Tensor
    noised: bool = True


def _apply_inpainting(sched: DiffusionSchedule, pred: torch.Tensor, t: torch.Tensor,
                      inpaint: Inpainting, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """``pred`` with the constrained frames replaced; ``noise`` (shaped like
    ``inpaint.motion``) is the q-sample noise of the ``noised`` blend."""
    if inpaint.noised:
        noisy = q_sample(sched, inpaint.motion, torch.clamp(t - 1, min=0), noise)
        src = torch.where(t[0] > 0, noisy, inpaint.motion)  # the reference gates on t[0]
    else:
        src = inpaint.motion
    return torch.where(inpaint.mask, src, pred)


def p_mean_variance(
    sched: DiffusionSchedule,
    model_pred: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    mean_type: MeanType = MeanType.START_X,
    var_type: VarType = VarType.FIXED_SMALL,
    clip_denoised: bool = False,
    denoised_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) moments from a model prediction of ``mean_type``;
    ``denoised_fn``, then the clip to [-1, 1], act on the x0 estimate."""
    nd = x.ndim
    if var_type == VarType.FIXED_SMALL:
        variance = extract(sched.posterior_variance, t, nd)
        log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    else:  # FIXED_LARGE: betas, with posterior_variance[1] at t=0
        large = torch.cat([sched.posterior_variance[1:2], sched.betas[1:]])
        variance = extract(large, t, nd)
        log_variance = torch.log(variance)

    def process_xstart(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return x0

    if mean_type == MeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_pred))
        mean = model_pred
    else:
        if mean_type == MeanType.START_X:
            pred_xstart = process_xstart(model_pred)
        else:
            pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, model_pred))
        mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return {"mean": mean, "variance": variance, "log_variance": log_variance,
            "pred_xstart": pred_xstart}


def _grad_log_p(cond_fn: Callable, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``cond_fn(x, t)``, the gradient of log p(y | x) at ``x``, called with
    autograd on (the loops run under ``torch.no_grad()``) on a detached copy
    of ``x`` that requires grad, so a ``cond_fn`` may differentiate through
    a classifier with ``torch.autograd.grad``."""
    with torch.enable_grad():
        grad = cond_fn(x.detach().requires_grad_(True), t)
    return grad.detach()


def condition_mean(sched: DiffusionSchedule, cond_fn: Callable, out, x, t) -> torch.Tensor:
    """Classifier guidance on the posterior mean: mean + variance * grad
    log p(y|x), with ``cond_fn(x, t) -> grad log p(y|x)``."""
    return out["mean"] + out["variance"] * _grad_log_p(cond_fn, x, t)


def condition_score(sched: DiffusionSchedule, cond_fn: Callable, out, x, t):
    """Score-based conditioning: eps shifted by -sqrt(1 - acp) * grad log
    p(y|x), then x0 and the posterior mean recomputed from it."""
    alpha_bar = extract(sched.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
    eps = eps - torch.sqrt(1 - alpha_bar) * _grad_log_p(cond_fn, x, t)
    new = dict(out)
    new["pred_xstart"] = predict_xstart_from_eps(sched, x, t, eps)
    new["mean"], _, _ = q_posterior_mean_variance(sched, new["pred_xstart"], x, t)
    return new


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


def ddim_reverse_step(sched: DiffusionSchedule, model_pred, x, t, *,
                      mean_type: MeanType = MeanType.START_X, clip_denoised: bool = False):
    """Deterministic DDIM encoder step x_t -> x_{t+1}."""
    out = p_mean_variance(sched, model_pred, x, t, mean_type=mean_type,
                          clip_denoised=clip_denoised)
    nd = x.ndim
    eps = ((extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x - out["pred_xstart"])
           / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))
    alpha_bar_next = extract(sched.alphas_cumprod_next, t, nd)
    return out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(
        1 - alpha_bar_next) * eps


def _randn(shape, generator, device, dtype=torch.float32):
    dev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=dev, dtype=dtype).to(device)


@torch.no_grad()
def reverse_loop(
    denoise_fn: Callable,
    sched: DiffusionSchedule,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    mean_type: MeanType = MeanType.START_X,
    clip_denoised: bool = False,
) -> torch.Tensor:
    """Deterministic DDIM encoding x_0 -> x_T over every step of ``sched``
    (inversion-based editing)."""
    batch, device = x0.shape[0], sched.betas.device
    x = x0
    for i in range(sched.num_timesteps):
        t = torch.full((batch,), i, dtype=torch.long, device=device)
        pred = denoise_fn(x, sched.map_timesteps(t), generator)
        x = ddim_reverse_step(sched, pred, x, t, mean_type=mean_type,
                              clip_denoised=clip_denoised)
    return x


@torch.no_grad()
def sample_loop(
    denoise_fn: Callable,
    sched: DiffusionSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    *,
    method: str = "ddpm",
    eta: float = 0.0,
    order: int = 2,
    clip_denoised: bool = False,
    denoised_fn: Optional[Callable] = None,
    mean_type: MeanType = MeanType.START_X,
    var_type: VarType = VarType.FIXED_SMALL,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    inpainting: Optional[Inpainting] = None,
    cond_fn: Optional[Callable] = None,
    const_noise: bool = False,
    return_trajectory: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
):
    """Run the reverse diffusion on the device ``sched`` is on.

    method: "ddpm" (ancestral), "ddim", "plms" (Adams-Bashforth of
    ``order`` 1-4; its first step at order > 1 is a pseudo improved Euler
    step, which calls the denoiser twice) or "dpmpp" (DPM-Solver++(2M), data
    prediction, multistep). With ``skip_timesteps`` the chain starts
    ``skip_timesteps`` steps late from ``init_image`` (zeros if absent)
    q_sample-noised to that step. ``noise`` replaces the initial draw;
    ``const_noise`` gives every row the first row's noise, at the start and
    at every DDPM/DDIM step. ``inpainting`` holds frames to a constraint.
    ``cond_fn(x, t) -> grad log p(y|x)`` (``t`` the spaced timesteps) guides
    the mean (DDPM) or the score (DDIM, PLMS, DPM-Solver++); it runs with
    autograd on. The chain's state is kept in ``dtype``.

    Returns the final sample, or with ``return_trajectory`` ("pred_xstart"
    or "sample") ``(final, stacked [n_steps, *shape])``: each step's x0
    estimate or its result."""
    if method not in METHODS:
        raise ValueError(f"unsupported sampler {method!r}; expected one of {METHODS}")
    if method == "plms" and not 1 <= order <= 4:
        raise ValueError("plms order must be in [1, 4]")
    if return_trajectory not in (None, "pred_xstart", "sample"):
        raise ValueError(f"return_trajectory {return_trajectory!r}: expected "
                         "'pred_xstart' or 'sample'")
    n_steps = sched.num_timesteps - skip_timesteps
    if n_steps < 1:
        raise ValueError(f"skip_timesteps {skip_timesteps} leaves no step of "
                         f"{sched.num_timesteps}")
    device = sched.betas.device
    batch = shape[0]

    def draw(shp, const=False):
        z = _randn(shp, generator, device, dtype)
        return z[:1].expand(shp) if const else z

    img = draw(shape, const_noise) if noise is None else noise.to(device, dtype)
    if skip_timesteps and init_image is None:
        init_image = torch.zeros(shape, device=device, dtype=dtype)
    if init_image is not None:
        t0 = torch.full((batch,), n_steps - 1, dtype=torch.long, device=device)
        img = q_sample(sched, init_image.to(device, dtype), t0, img).to(dtype)

    def step_out(x, i):
        t = torch.full((batch,), i, dtype=torch.long, device=device)
        pred = denoise_fn(x, sched.map_timesteps(t), generator)
        if inpainting is not None:
            blend = draw(inpainting.motion.shape) if inpainting.noised else None
            pred = _apply_inpainting(sched, pred, t, inpainting, blend)
        out = p_mean_variance(sched, pred, x, t, mean_type=mean_type, var_type=var_type,
                              clip_denoised=clip_denoised, denoised_fn=denoised_fn)
        if cond_fn is not None:
            if method == "ddpm":
                out = dict(out, mean=condition_mean(sched, cond_fn, out, x, t))
            else:
                out = condition_score(sched, cond_fn, out, x, t)
        return out, t

    trajectory = []

    def record(out, x):
        if return_trajectory == "pred_xstart":
            trajectory.append(out["pred_xstart"])
        elif return_trajectory == "sample":
            trajectory.append(x)

    def finish(x):
        return (x, torch.stack(trajectory)) if return_trajectory else x

    x = img
    if method in ("ddpm", "ddim"):
        for i in range(n_steps - 1, -1, -1):
            with annotate("rag.step"):
                out, t = step_out(x, i)
                step_noise = draw(x.shape, const_noise)
                if method == "ddpm":
                    x = _ddpm_update(sched, out, x, t, step_noise).to(dtype)
                else:
                    x = _ddim_update(sched, out, x, t, step_noise, eta).to(dtype)
                record(out, x)
        return finish(x)

    if method == "dpmpp":
        # DPM-Solver++(2M), data-prediction form (Lu et al. 2022):
        # lambda = log(alpha / sigma) with alpha = sqrt(acp), sigma =
        # sqrt(1-acp), from the f32 tables; the last step (t=0) returns
        # pred_xstart.
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
            with annotate("rag.step"):
                out, _ = step_out(x, i)
                d = out["pred_xstart"]
                h = log_lambda_prev[i] - log_lambda[i]
                if d_prev is None:
                    d_tilde = d
                else:  # 2M correction: (1 + 1/(2r)) D_i - 1/(2r) D_{i-1}
                    r = h_prev / torch.where(h == 0, torch.ones_like(h), h)
                    coef = 1.0 / torch.clamp(2.0 * r, min=1e-20)
                    d_tilde = (1.0 + coef) * d - coef * d_prev
                x = ((sigma_next_t[i] / sigma_cur_t[i]) * x - alpha_next_t[i] * (
                    torch.exp(-h) - 1.0) * d_tilde).to(dtype)
                record(out, x)
                d_prev, h_prev = d, h
        with annotate("rag.step"):
            out, _ = step_out(x, 0)
            x = out["pred_xstart"].to(dtype)  # the last step lands on x0
            record(out, x)
        return finish(x)

    # PLMS (Adams-Bashforth multistep). The history holds the raw eps of the
    # last order-1 steps (zeros at first); n_old counts them, up to order.
    nd = len(shape)
    old_eps = [torch.zeros(shape, device=device, dtype=dtype)] * max(order - 1, 1)
    n_old = 0
    for step, i in enumerate(range(n_steps - 1, -1, -1)):
        with annotate("rag.step"):
            out, t = step_out(x, i)
            eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
            alpha_bar_prev = extract(sched.alphas_cumprod_prev, t, nd)
            if order > 1 and step == 0:
                # pseudo improved Euler: a second denoiser call at the next step
                mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(
                    1 - alpha_bar_prev) * eps
                out2, t2 = step_out(mean_pred, max(i - 1, 0))
                eps_prime = (eps + predict_eps_from_xstart(sched, mean_pred, t2,
                                                           out2["pred_xstart"])) / 2
            elif order > 1:
                cur = min(n_old + 1, order)
                e1, e2 = eps, old_eps[-1]
                e3 = old_eps[-2] if order >= 3 else e2
                e4 = old_eps[-3] if order >= 4 else e3
                if cur == 2:
                    eps_prime = (3 * e1 - e2) / 2
                elif cur == 3:
                    eps_prime = (23 * e1 - 16 * e2 + 5 * e3) / 12
                else:
                    eps_prime = (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4) / 24
            else:
                eps_prime = eps
            pred_prime = predict_xstart_from_eps(sched, x, t, eps_prime)
            mean_pred = pred_prime * torch.sqrt(alpha_bar_prev) + torch.sqrt(
                1 - alpha_bar_prev) * eps_prime
            nzm = _nonzero_mask(t, nd)
            x = (mean_pred * nzm + out["pred_xstart"] * (1 - nzm)).to(dtype)
            old_eps = old_eps[1:] + [eps]
            n_old = min(n_old + 1, order)
            record(out, x)
    return finish(x)


def sample_loop_with_dump(
    denoise_fn: Callable,
    sched: DiffusionSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    *,
    dump_steps,
    dump_field: str = "pred_xstart",
    **kwargs,
):
    """The reference's ``dump_steps``: the field of each step (pred_xstart
    in the TED tree, the post-step sample in the BEAT tree) at the loop
    indices ``dump_steps``. Returns ``(final, dumped [len(dump_steps),
    *shape])``."""
    final, trajectory = sample_loop(denoise_fn, sched, shape, generator,
                                    return_trajectory=dump_field, **kwargs)
    idx = torch.as_tensor(list(dump_steps), dtype=torch.long, device=trajectory.device)
    return final, trajectory[idx]
