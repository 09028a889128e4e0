"""The RAG training step in PyTorch.

Port of ``livelyspeaker_tpu/training/trainer.py``: timestep sampling
(uniform or loss-second-moment), the diffusion losses with
``loss = mean(loss_per_sample * weights) + kld_weight * kld``, AdamW as
``optax.adamw`` computes it (optionally after ``clip_by_global_norm``) with
the linear LR anneal, a step that leaves params, moments and the update
count alone when any gradient is not finite, and an optional parameter EMA.

The model holds the f32 master parameters and the step updates them in
place; ``TrainState.params`` is the dict of those same tensors. One host
sync per step reads the finiteness check and the scalar metrics together.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..diffusion import (
    DiffusionSchedule,
    LossSecondMomentState,
    ema_update,
    loss_aware_sample_t,
    loss_aware_update,
    training_losses,
    uniform_sample_t,
)
from ..models.rag import RAG
from ..utils.profiling import annotate

__all__ = ["TrainState", "TrainConfig", "AdamW", "AdamWState", "make_optimizer",
           "make_loss_fn", "make_train_step", "make_step_parts", "StepParts", "ShardGrads",
           "init_train_state", "global_norm"]


class TrainConfig:
    """Training hyperparameters, with the JAX package's defaults."""

    def __init__(
        self,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        lr_anneal_steps: int = 0,
        loss_type: str = "huber",
        lambda_vel: float = 1.0,
        kld_weight: float = 0.01,  # BEAT trains with 0.0
        grad_clip: float = 0.0,
        schedule_sampler: str = "uniform",
        ema_rate: float = 0.0,
        ema_warmup: bool = False,
        compute_dtype: str = "float32",
    ):
        self.lr = lr
        self.weight_decay = weight_decay
        self.lr_anneal_steps = lr_anneal_steps
        self.loss_type = loss_type
        self.lambda_vel = lambda_vel
        self.kld_weight = kld_weight
        self.grad_clip = grad_clip
        self.schedule_sampler = schedule_sampler
        # EMA of the params, 0.0 = off; with ema_warmup the decay is
        # min(ema_rate, (1 + n) / (10 + n)) after n completed steps
        self.ema_rate = ema_rate
        self.ema_warmup = ema_warmup
        # "bfloat16": the forward runs on bf16 copies of the f32 master
        # params; the gradients come back f32
        self.compute_dtype = compute_dtype


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int  # steps taken, skipped ones included
    params: Dict[str, torch.Tensor]  # the model's parameters, updated in place
    opt_state: AdamWState
    sampler_state: Optional[LossSecondMomentState] = None
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor (on
    the first one's device, where they lie on several)."""
    dev = tensors[0].device
    return torch.linalg.vector_norm(torch.stack([n.to(dev) for n in
                                                 torch._foreach_norm(tensors)]))


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)``, with ``lr`` annealed
    as ``lr * max(0, 1 - count / lr_anneal_steps)`` over the count of
    applied updates, and optionally ``clip_by_global_norm(grad_clip)``
    first. Functional: :meth:`update` returns the updates and a new state."""

    def __init__(self, lr: float, weight_decay: float = 0.0, lr_anneal_steps: int = 0,
                 grad_clip: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr = lr
        self.weight_decay = weight_decay
        self.lr_anneal_steps = lr_anneal_steps
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def learning_rate(self, count: int) -> float:
        if self.lr_anneal_steps:
            return self.lr * max(0.0, 1.0 - count / self.lr_anneal_steps)
        return self.lr

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor], clip_norm: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
        """``clip_norm``: the global norm to clip by, where ``grads`` are
        only a slice of the gradient (FSDP); by default theirs."""
        names = list(grads)
        g = [grads[k] for k in names]
        if self.grad_clip > 0:
            norm = global_norm(g) if clip_norm is None else clip_norm
            clip = lambda x, n: torch.where(n < self.grad_clip, x, x / n * self.grad_clip)
            g = [clip(x, norm.to(x.device)) for x in g]
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state.mu[k] for k in names], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul([state.nu[k] for k in names], b2))
        count = state.count + 1
        # bias corrections in f32, as optax takes them: 1 - 0.999 alone is
        # 1.3e-5 off in f32, and that shows in every update
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(count)) for b in (b1, b2))
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        u = torch._foreach_add(u, torch._foreach_mul([params[k] for k in names],
                                                     self.weight_decay))
        u = torch._foreach_mul(u, -self.learning_rate(state.count))
        return (dict(zip(names, u)),
                AdamWState(count=count, mu=dict(zip(names, mu)), nu=dict(zip(names, nu))))


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(cfg.lr, weight_decay=cfg.weight_decay,
                 lr_anneal_steps=cfg.lr_anneal_steps, grad_clip=cfg.grad_clip)


_LOSS_AWARE_NAMES = ("loss-second-moment", "loss_second_moment")


def init_train_state(
    params: Mapping[str, torch.Tensor],
    tx: AdamW,
    *,
    cfg: Optional[TrainConfig] = None,
    num_timesteps: Optional[int] = None,
) -> TrainState:
    """``params`` is the model's ``dict(named_parameters())``."""
    sampler_state = ema_params = None
    if cfg is not None:
        if cfg.schedule_sampler in _LOSS_AWARE_NAMES:
            if not num_timesteps:
                raise ValueError("loss-second-moment sampler needs num_timesteps")
            sampler_state = LossSecondMomentState.create(num_timesteps)
        if cfg.ema_rate > 0:
            ema_params = {k: p.detach().clone() for k, p in params.items()}
    return TrainState(step=0, params=dict(params), opt_state=tx.init(params),
                      sampler_state=sampler_state, ema_params=ema_params)


def make_loss_fn(model: RAG, sched: DiffusionSchedule, cfg: TrainConfig,
                 backbone_factory: Optional[Callable] = None) -> Callable:
    """``loss_fn(batch, t, weights, generator=None, noise=None,
    style_eps=None, cond_drop=None) -> (loss, terms)``: the training loss of
    one batch already on the model's device, as the train step
    differentiates it. ``sched`` must be on that device too.

    ``backbone_factory(params) -> backbone_apply`` routes the mixer stack
    through another forward built from the live parameters (``params``:
    the model's, or their compute-dtype copies, by state_dict key), as the
    JAX step's hook does (``trainer.py:138-200``); the pipeline stages
    (``parallel.pipeline.make_pipeline_backbone_factory``) plug in here."""
    compute_dtype = getattr(torch, cfg.compute_dtype)

    def loss_fn(batch, t, weights, generator=None, noise=None, style_eps=None,
                cond_drop=None):
        cond = {"audio": batch["audio"], "vid": batch["vid"], "origin_x": batch["motion"]}
        for k, v in (("emo", batch.get("emo")), ("style_eps", style_eps),
                     ("cond_drop", cond_drop)):
            if v is not None:
                cond[k] = v
        if compute_dtype != torch.float32:
            apply_params = {k: p.to(compute_dtype) if p.dtype == torch.float32 else p
                            for k, p in model.named_parameters()}
            backbone_apply = backbone_factory(apply_params) if backbone_factory else None

            def model_fn(x_t, t_model):
                out = torch.func.functional_call(
                    model, apply_params, (x_t.to(compute_dtype), t_model, cond),
                    {"train": True, "generator": generator, "backbone_apply": backbone_apply})
                return {k: v.to(torch.float32) for k, v in out.items()}
        else:
            backbone_apply = (backbone_factory(dict(model.named_parameters()))
                              if backbone_factory else None)

            def model_fn(x_t, t_model):
                return model(x_t, t_model, cond, train=True, generator=generator,
                             backbone_apply=backbone_apply)

        terms = training_losses(model_fn, sched, batch["motion"], t, generator,
                                mask=batch.get("mask"), loss_type=cfg.loss_type,
                                lambda_vel=cfg.lambda_vel, noise=noise)
        loss = (terms["loss_per_sample"] * weights).mean() + cfg.kld_weight * terms.get("kld", 0.0)
        return loss, terms

    return loss_fn


class ShardGrads(NamedTuple):
    """What one shard's forward and backward give the apply half of a step."""

    loss: torch.Tensor  # the scalar loss, detached
    grads: List[torch.Tensor]  # in the order of ``state.params``
    t: torch.Tensor  # [B] timesteps
    losses: torch.Tensor  # [B] per-sample losses, detached
    means: torch.Tensor  # [3]: rot_mse, vel_mse, kld (0 where the loss has none)
    terms: Tuple[str, ...]  # which of rot_mse, vel_mse, kld the loss has


class StepParts(NamedTuple):
    """The train step in its halves, so that a data-parallel step can
    average between them (``parallel/training.py``):

    - ``shard_grads(state, batch, generator, *, t, noise, style_eps,
      cond_drop) -> ShardGrads``: the loss, its terms and its gradients on
      one batch, with no host sync;
    - ``read_host(state, sg, norms=None) -> dict``: the step's one host
      sync, the finite checks, the norms and the scalar metrics (``norms``:
      the [3, m] inf-norms and 2-norms of the gradients and the 2-norms of
      the parameters over which the global norms run, by default those of
      ``sg.grads`` and ``state.params``);
    - ``sampler_update(state, sg, host)``: the loss-aware history after
      the step (the state's own when the sampler is uniform or a loss is
      not finite);
    - ``apply(state, grads, host, sampler_state, clip_norm=None) ->
      TrainState``: AdamW (skipped when a gradient is not finite) and the
      EMA;
    - ``metrics(sg, host) -> dict``.

    ``shard_grads`` runs under the profiler span ``train.grads``,
    ``read_host`` under ``train.sync``, ``apply`` and the loss-aware
    history's update under ``train.apply`` (``utils/profiling.annotate``)."""

    shard_grads: Callable[..., ShardGrads]
    read_host: Callable[..., Dict]
    sampler_update: Callable[..., Optional[LossSecondMomentState]]
    apply: Callable[..., TrainState]
    metrics: Callable[..., Dict]


_TERMS = ("rot_mse", "vel_mse", "kld")


def make_step_parts(
    model: RAG,
    sched: DiffusionSchedule,
    tx: AdamW,
    cfg: TrainConfig,
    backbone_factory: Optional[Callable] = None,
) -> StepParts:
    """The halves of :func:`make_train_step` for ``model`` on its device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    use_loss_aware = cfg.schedule_sampler in _LOSS_AWARE_NAMES
    if not use_loss_aware and cfg.schedule_sampler != "uniform":
        raise NotImplementedError(f"unknown schedule_sampler: {cfg.schedule_sampler!r}")
    device = next(model.parameters()).device
    sched = sched.to(device)
    num_t = sched.num_timesteps
    loss_fn = make_loss_fn(model, sched, cfg, backbone_factory)

    @annotate("train.grads")
    def shard_grads(state: TrainState, batch, generator: Optional[torch.Generator] = None, *,
                    t=None, noise=None, style_eps=None, cond_drop=None) -> ShardGrads:
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
                 if k in ("motion", "audio", "vid", "mask", "emo")}
        as_dev = lambda v: None if v is None else torch.as_tensor(v).to(device)
        noise, style_eps, cond_drop = as_dev(noise), as_dev(style_eps), as_dev(cond_drop)
        b = batch["motion"].shape[0]
        if t is None and use_loss_aware:
            t, weights = loss_aware_sample_t(state.sampler_state, generator, b, device)
        elif t is None:
            t, weights = uniform_sample_t(generator, b, num_t, device)
        else:
            t = as_dev(t).long()
            weights = torch.ones((b,), dtype=torch.float32, device=device)
            if use_loss_aware:  # the importance weights of the given t
                w = state.sampler_state.weights().to(device)
                weights = 1.0 / (num_t * (w / w.sum())[t])

        params = list(state.params.values())
        loss, terms = loss_fn(batch, t, weights, generator, noise, style_eps, cond_drop)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        means = torch.stack([terms[k].detach().float().mean() if k in terms
                             else loss.new_zeros(()) for k in _TERMS])
        return ShardGrads(loss.detach(), grads, t, terms["loss_per_sample"].detach(), means,
                          tuple(k for k in _TERMS if k in terms))

    @annotate("train.sync")
    def read_host(state: TrainState, sg: ShardGrads,
                  norms: Optional[torch.Tensor] = None) -> Dict:
        # one host sync: a max-abs norm is finite iff every element is
        if norms is None:
            norms = torch.stack([torch.stack(torch._foreach_norm(sg.grads, float("inf"))),
                                 torch.stack(torch._foreach_norm(sg.grads)),
                                 torch.stack(torch._foreach_norm(list(state.params.values())))])
        n = norms.shape[1]
        host = torch.cat([
            norms.reshape(-1),
            torch.stack([sg.loss, torch.isfinite(sg.losses).all().float(),
                         sg.t.float().mean()]).to(norms.device),
            sg.means.to(norms.device),
        ]).tolist()
        loss_v, losses_finite, t_mean, *means = host[3 * n:]
        return {
            "grads_finite": all(v == v and abs(v) != float("inf") for v in host[:n]),
            "grad_norm": sum(v * v for v in host[n:2 * n]) ** 0.5,
            "param_norm": sum(v * v for v in host[2 * n:3 * n]) ** 0.5,
            "loss": loss_v, "losses_finite": losses_finite, "t_mean": t_mean,
            "means": dict(zip(_TERMS, means)),
        }

    def sampler_update(state: TrainState, sg: ShardGrads, host: Dict):
        if use_loss_aware and host["losses_finite"]:
            with annotate("train.apply"):
                return loss_aware_update(state.sampler_state, sg.t, sg.losses)
        return state.sampler_state

    @annotate("train.apply")
    def apply(state: TrainState, grads: List[torch.Tensor], host: Dict,
              sampler_state, clip_norm: Optional[torch.Tensor] = None) -> TrainState:
        names = list(state.params)
        opt_state = state.opt_state
        if host["grads_finite"]:
            updates, opt_state = tx.update(dict(zip(names, grads)), opt_state, state.params,
                                           clip_norm)
            with torch.no_grad():
                torch._foreach_add_(list(state.params.values()), [updates[k] for k in names])

        ema = state.ema_params
        if cfg.ema_rate > 0 and ema is not None:
            rate = cfg.ema_rate
            if cfg.ema_warmup:
                rate = min(rate, (1.0 + state.step) / (10.0 + state.step))
            ema = ema_update(ema, state.params, rate)
        return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state,
                          sampler_state=sampler_state, ema_params=ema)

    def metrics(sg: ShardGrads, host: Dict) -> Dict:
        out = {
            "loss": host["loss"],
            "grad_norm": host["grad_norm"],
            "param_norm": host["param_norm"],
            "t_mean": host["t_mean"],
            "skipped_nonfinite": 0.0 if host["grads_finite"] else 1.0,
            "t": sg.t,
            "loss_per_sample": sg.losses,
        }
        out.update((k, host["means"][k]) for k in sg.terms)
        return out

    return StepParts(shard_grads, read_host, sampler_update, apply, metrics)


def make_train_step(
    model: RAG,
    sched: DiffusionSchedule,
    tx: AdamW,
    cfg: TrainConfig,
    backbone_factory: Optional[Callable] = None,
) -> Callable[..., Tuple[TrainState, Dict]]:
    """The train step, ``step(state, batch, generator=None, *, t=None,
    noise=None, style_eps=None, cond_drop=None) -> (state, metrics)``.

    batch: 'motion' [B, J, F, T], 'audio' [B, L], 'vid' [B], optional
    'mask' [B, T] and 'emo' [B]; tensors or arrays, moved to the model's
    device. ``generator`` draws t, the noise, the condition drop and the
    style token, in that order; ``t``, ``noise``, ``style_eps`` [B, 1, D]
    and ``cond_drop`` [B] replace those draws. Metrics: floats, and the
    per-sample 't' and 'loss_per_sample' as device tensors.

    ``backbone_factory``: see :func:`make_loss_fn`.

    Building the step pins TF32 off for matmul and cuDNN: the WavEncoder's
    f32 convs would otherwise run in TF32."""
    parts = make_step_parts(model, sched, tx, cfg, backbone_factory)

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator] = None, *,
                   t=None, noise=None, style_eps=None, cond_drop=None):
        sg = parts.shard_grads(state, batch, generator, t=t, noise=noise, style_eps=style_eps,
                               cond_drop=cond_drop)
        host = parts.read_host(state, sg)
        new = parts.apply(state, sg.grads, host, parts.sampler_update(state, sg, host))
        return new, parts.metrics(sg, host)

    return train_step
