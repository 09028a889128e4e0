"""Data-parallel training over a mesh: the step runs on every shard.

Port of ``livelyspeaker_tpu/parallel/training.py:40-77`` with the collectives
of ``training/trainer.py:245-270`` of the JAX package. Each shard holds a
replica of the model and its own optimizer state; a step computes each
shard's loss and gradients on its slice of the global batch (through K2 on
each shard when the model has ``fused_train_backbone``), averages the
gradients, the loss and its terms over the shards (``mesh.pmean``),
gathers the per-sample t and losses in shard order, then takes the finite
check and the global norms on the averaged gradient in one host sync and
applies the same update on every replica. Every replica starts from the
same bits and applies the same averaged gradient with the same arithmetic,
so the replicas stay bit-identical (the JAX module's "TrainStates stay
bitwise in sync").

The JAX package trains with this step only for the fused backbone on a
multi-device mesh and otherwise lets GSPMD partition a plain jitted step;
the port has no GSPMD, so both backbones train through this step.

Random streams: each shard draws t, the noise, the condition drop and the
style token from ``fold_in(generator, shard)`` (``jax.random.fold_in(rng,
axis_index)``); ``fold_shard_rng=False`` gives every shard the parent's
stream, as the tests use it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..training.trainer import (
    AdamW,
    AdamWState,
    ShardGrads,
    TrainConfig,
    TrainState,
    make_step_parts,
)
from .mesh import MODEL_AXIS, Mesh, gather_batch, on_device, pmean, replicate_module, \
    shard_batch, shard_generators

__all__ = ["shard_train_step"]

_FIELDS = ("motion", "audio", "vid", "mask", "emo")


def _copy_state(state: TrainState, params: Dict[str, torch.Tensor]) -> TrainState:
    """``state`` for a replica whose parameters are ``params``: the values
    copied into them, the moments and the EMA copied to their device."""
    dev = next(iter(params.values())).device
    like = lambda d: None if d is None else {k: v.to(dev, copy=True) for k, v in d.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(state.params[k])
    opt = state.opt_state
    return TrainState(step=state.step, params=params,
                      opt_state=AdamWState(count=opt.count, mu=like(opt.mu), nu=like(opt.nu)),
                      sampler_state=state.sampler_state, ema_params=like(state.ema_params))


def shard_train_step(
    model,
    sched,
    tx: AdamW,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    fold_shard_rng: bool = True,
) -> Callable[..., Tuple[TrainState, Dict]]:
    """The data-parallel train step over ``mesh``, called like the plain
    step: ``step(state, batch, generator=None, *, t=None, noise=None,
    style_eps=None, cond_drop=None) -> (state, metrics)``.

    ``model`` is shard 0's replica (moved to its device); ``state`` is
    shard 0's state, over ``model``'s parameters. When a call gets another
    state than the one the last call returned (the first call, a resumed
    checkpoint), that state is first copied to every replica. ``batch``
    (and the injected draws) carry the global batch, which the mesh size
    must divide, or ``batch`` is a list of one batch a shard (the loaders'
    form with a mesh). Returns shard 0's new state and the metrics of the
    global batch: the averaged loss and terms, the norms of the averaged
    gradient, and 't' and 'loss_per_sample' of length N * B_local in shard
    order on shard 0's device. ``step.replicas`` are the replica modules,
    ``step.states()`` every shard's state."""
    if mesh.shape[MODEL_AXIS] != 1:
        raise ValueError("data-parallel training takes a model axis of size 1, got "
                         f"{mesh.shape[MODEL_AXIS]}")
    replicas = replicate_module(model, mesh)
    parts = [make_step_parts(r, sched, tx, cfg) for r in replicas]
    n = mesh.size
    states = [None] * n

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None, *,
             t=None, noise=None, style_eps=None, cond_drop=None):
        if state is not states[0]:
            states[:] = [state] + [_copy_state(state, dict(r.named_parameters()))
                                   for r in replicas[1:]]
        if isinstance(batch, (list, tuple)):
            if len(batch) != n:
                raise ValueError(f"{len(batch)} batch shards for a mesh of {n}")
            shards = [{k: v for k, v in b.items() if k in _FIELDS} for b in batch]
        else:
            shards = shard_batch({k: v for k, v in batch.items() if k in _FIELDS}, mesh)
        drawn = shard_batch({"t": t, "noise": noise, "style_eps": style_eps,
                             "cond_drop": cond_drop}, mesh)
        gens = shard_generators(generator, mesh, fold=fold_shard_rng)
        per_shard = []
        for i, dev in enumerate(mesh.devices):
            with on_device(dev):
                per_shard.append(parts[i].shard_grads(states[i], shards[i], gens[i],
                                                      **drawn[i]))
        dev0 = mesh.devices[0]
        loss, means, *grads = pmean([[s.loss, s.means, *s.grads] for s in per_shard])
        sg = ShardGrads(loss, grads, gather_batch([s.t for s in per_shard], dev0),
                        gather_batch([s.losses for s in per_shard], dev0), means,
                        per_shard[0].terms)
        host = parts[0].read_host(states[0], sg)
        sampler_state = parts[0].sampler_update(states[0], sg, host)
        for i, dev in enumerate(mesh.devices):
            g = grads if i == 0 else [x.to(dev) for x in grads]
            with on_device(dev):
                states[i] = parts[i].apply(states[i], g, host, sampler_state)
        return states[0], parts[0].metrics(sg, host)

    step.replicas = replicas
    step.states = lambda: list(states)
    return step
