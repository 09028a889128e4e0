"""Progressive distillation: halve the sampler's step count by training.

Port of the JAX package's ``experiments/distillation/distill.py``. Salimans
and Ho, "Progressive Distillation for Fast Sampling of Diffusion Models"
(ICLR 2022), in the x0-prediction parameterisation the package uses
everywhere (model_util.py:42 predict_xstart=True): a student is trained so
that ONE deterministic DDIM step from t to t-2 lands where the teacher's
TWO steps (t -> t-1 -> t-2) land. Each round halves the steps.
DPM-Solver++ already gives a training-free 20-step path; this is the
training-based lever below it. No reference counterpart (the reference only
respaces).

Its status is the JAX package's: kept under ``experiments/`` because four
measured operating points found no headroom on this workload (the
x0-parameterised denoiser is insensitive to the step count under DDIM on
every fixture tried), so students only add fine-tuning drift. The math is
held by the oracle identity (``tests/test_torch_distill.py``).

The teacher is a frozen module of the student's architecture: it runs
under ``torch.no_grad()``, so no gradient reaches it. The optimizer is any
``torch.optim`` optimizer of the student's parameters (the JAX scripts'
``optax.adamw(lr)`` is ``torch.optim.AdamW(lr=lr, weight_decay=1e-4)``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ...diffusion.sampling import extract, q_sample
from ...diffusion.schedule import DiffusionSchedule
from ...training.trainer import global_norm

__all__ = ["distill_targets", "make_distill_step"]


def _alpha_sigma(sched: DiffusionSchedule, t: torch.Tensor, nd: int):
    acp = extract(sched.alphas_cumprod, t, nd)
    return torch.sqrt(acp), torch.sqrt(torch.clamp(1.0 - acp, min=1e-12))


def distill_targets(
    sched: DiffusionSchedule,
    teacher_x0: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_t: torch.Tensor,
    t: torch.Tensor,  # [B] long, in [2, num_timesteps)
):
    """The x0 target of the student's one-step jump t -> t-2.

    Runs the teacher's two deterministic (eta 0) DDIM steps and solves for
    the x0 that makes the student's single DDIM step land on the same
    x_{t-2} (Salimans and Ho eq. 7, App. G):

        x~0 = (x_{t-2} - (sigma_{t-2}/sigma_t) x_t)
              / (alpha_{t-2} - (sigma_{t-2}/sigma_t) alpha_t)

    With a perfect teacher (the true x0) the target is that x0. Returns
    ``(x0_target, snr_weight)``, the paper's truncated SNR weight
    max(alpha^2/sigma^2, 1)."""
    nd = x_t.ndim
    a_t, s_t = _alpha_sigma(sched, t, nd)

    x0_1 = teacher_x0(x_t, t)
    eps1 = (x_t - a_t * x0_1) / s_t
    t1 = torch.clamp(t - 1, min=0)
    a_1, s_1 = _alpha_sigma(sched, t1, nd)
    x_t1 = a_1 * x0_1 + s_1 * eps1

    x0_2 = teacher_x0(x_t1, t1)
    eps2 = (x_t1 - a_1 * x0_2) / s_1
    t2 = torch.clamp(t - 2, min=0)
    a_2, s_2 = _alpha_sigma(sched, t2, nd)
    x_t2 = a_2 * x0_2 + s_2 * eps2

    ratio = s_2 / s_t
    denom = a_2 - ratio * a_t
    x0_target = (x_t2 - ratio * x_t) / torch.where(denom.abs() < 1e-12,
                                                    torch.ones_like(denom), denom)
    w = torch.clamp(a_t ** 2 / s_t ** 2, min=1.0)
    return x0_target, w


def make_distill_step(model, sched: DiffusionSchedule, opt: torch.optim.Optimizer, teacher):
    """The distillation step, ``step(batch, generator=None, *, t=None,
    noise=None, style_eps=None) -> metrics``: one update of the student
    ``model`` (in place, through ``opt``) toward the frozen ``teacher``'s
    two-step map.

    ``batch``: 'motion' [B, J, F, T], 'audio', 'vid' and optional 'emo',
    tensors on the student's device; ``sched`` on that device (respaced: t
    counts its steps). ``generator`` draws t in [2, num_timesteps), the
    noise, the teacher's style token (one draw for its two calls, as the
    JAX step's one key) and the student's; ``t``, ``noise`` and
    ``style_eps`` [B, 1, D] (then one draw for all three calls) replace
    those draws. Metrics: 'loss', 'grad_norm' and 't_mean', 0-d tensors on
    the device."""
    teacher.eval().requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]

    def cond_of(batch: Dict, style_eps: torch.Tensor):
        cond = {"audio": batch["audio"], "vid": batch["vid"], "origin_x": batch["motion"],
                "style_eps": style_eps}
        if "emo" in batch:
            cond["emo"] = batch["emo"]
        return cond

    def x0_of(module, x, t, cond, feats):
        return module(x, sched.map_timesteps(t), cond, train=False, audio_feats=feats)["output"]

    def step(batch: Dict, generator: Optional[torch.Generator] = None, *, t=None, noise=None,
             style_eps=None):
        x0 = batch["motion"]
        b = x0.shape[0]
        if t is None:
            t = torch.randint(2, sched.num_timesteps, (b,), generator=generator,
                              device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        if style_eps is None:
            shape = (b, 1, model.cfg.latent_dim)
            t_eps, s_eps = (torch.randn(shape, generator=generator, device=x0.device)
                            for _ in range(2))
        else:
            t_eps = s_eps = style_eps
        with torch.no_grad():
            # the audio features once a model: three denoiser calls share two
            t_cond = cond_of(batch, t_eps)
            t_feats = teacher.encode_audio(t_cond["audio"])
            x_t = q_sample(sched, x0, t, noise)
            target, w = distill_targets(
                sched, lambda x, tt: x0_of(teacher, x, tt, t_cond, t_feats), x_t, t)
        s_cond = cond_of(batch, s_eps)
        pred = x0_of(model, x_t, t, s_cond, model.encode_audio(s_cond["audio"]))
        per_sample = torch.mean(w * (pred - target) ** 2, dim=tuple(range(1, x0.ndim)))
        loss = per_sample.mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = global_norm([p.grad for p in params if p.grad is not None])
        opt.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
                "t_mean": t.to(torch.float32).mean()}

    return step
