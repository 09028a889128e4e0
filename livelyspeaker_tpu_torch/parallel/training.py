"""Data-parallel and fully sharded training over a mesh: the step runs on
every shard.

Port of ``livelyspeaker_tpu/parallel/training.py:40-77`` with the collectives
of ``training/trainer.py:245-270`` of the JAX package, and of its FSDP
placement (``parallel/mesh.py:115-246``, trained by the plain jitted step).

:func:`shard_train_step`: each shard holds a replica of the model and its
own optimizer state; a step computes each shard's loss and gradients on its
slice of the global batch (through K2 on each shard when the model has
``fused_train_backbone``), averages the gradients, the loss and its terms
over the shards (``mesh.pmean``), gathers the per-sample t and losses in
shard order, then takes the finite check and the global norms on the
averaged gradient in one host sync and applies the same update on every
replica. Every replica starts from the same bits and applies the same
averaged gradient with the same arithmetic, so the replicas stay
bit-identical (the JAX module's "TrainStates stay bitwise in sync"). On a
mesh that spans processes (``multihost.init_distributed``) each process
runs its local shards and the sums go through the process group: two
processes of one shard each take the bits of one process of two shards.

:func:`fsdp_train_step`: the same step over a state sliced by
``mesh.fsdp_shard_params`` (ZeRO-3). Before a shard's forward its replica's
sharded weights are all-gathered onto its device, after its backward they
are freed; the averaged gradients are cut to each shard's slice (the same
fixed-order sums as ``pmean``, then a scatter); the norms and the finite
check come from the slices' norms in one host sync; AdamW and the EMA
update the slices only.

The JAX package trains with the data-parallel step only for the fused
backbone on a multi-device mesh and otherwise lets GSPMD partition a plain
jitted step, over replicated parameters or the rules' tensor-parallel
shardings (``__graft_entry__.py:159-175``); the port has no GSPMD, so both
backbones train through these steps, which are the counterparts of both
JAX routes. On a model axis above 1 each data row trains its
tensor-parallel replica (``mesh.shard_params``): its state is keyed by the
replica's parameter names (slice j of a ruled leaf is ``name.j``, on the
row's j-th device), the averages and the update run slice by slice, and
``step.gathered_state()`` gives one whole state over the model's names.
The fused backbone is refused there with the JAX package's words
(``training.py:57-62``): K2 is a single-card design. ``backbone_factory``
(``parallel.pipeline``) runs each shard's mixer stack over its row of a
pipeline mesh.

Random streams: each shard draws t, the noise, the condition drop and the
style token from ``fold_in(generator, global shard index)``
(``jax.random.fold_in(rng, axis_index)``); ``fold_shard_rng=False`` gives
every shard the parent's stream, as the tests use it.
"""

from __future__ import annotations

import functools
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
from .mesh import DATA_AXIS, FSDP_MIN_SIZE, MODEL_AXIS, FSDPShards, Mesh, gather_batch, \
    gather_processes, on_device, pmean, shard_batch, shard_generators, shard_params
from .tensor_parallel import merge_values, split_values, tp_layout

__all__ = ["shard_train_step", "fsdp_train_step"]

_FIELDS = ("motion", "audio", "vid", "mask", "emo")

# the JAX script's refusal (scripts/train_rag.py:97-102), kept for the step
FSDP_FUSED_REFUSAL = (
    "--fsdp needs the GSPMD train step (params gathered at use "
    "sites), but --fused_train on a multi-device mesh runs the "
    "explicit shard_map DP step over replicated params; drop one.")


# the fused kernel on a model axis above 1 (parallel/training.py:57-62 of the JAX package)
TP_FUSED_REFUSAL = ("shard_map training is data-parallel only; got model axis of size {} (the "
                    "fused kernel is a single-chip design — a TP axis would silently replicate "
                    "work)")


def _copy_state(state: TrainState, replica: torch.nn.Module) -> TrainState:
    """``state`` (over the model's parameter names) for ``replica``: the
    values copied into its parameters, the moments and the EMA copied to
    their devices, each cut to the replica's slice of a split leaf."""
    params = dict(replica.named_parameters())
    layout, devs = tp_layout(replica), {k: p.device for k, p in params.items()}
    like = lambda d: None if d is None else split_values(d, layout, devs)
    with torch.no_grad():
        for k, v in like(state.params).items():
            params[k].copy_(v)
    opt = state.opt_state
    return TrainState(step=state.step, params=params,
                      opt_state=AdamWState(count=opt.count, mu=like(opt.mu), nu=like(opt.nu)),
                      sampler_state=state.sampler_state, ema_params=like(state.ema_params))


def _whole_state(state: TrainState, replica: torch.nn.Module, names, device) -> TrainState:
    """A replica's ``state`` over the model's parameter ``names``, whole on
    ``device`` (the slices of a split leaf concatenated)."""
    layout = tp_layout(replica)

    def whole(d):
        if d is None:
            return None
        merged = merge_values(d, layout, device)
        return {k: merged[k] for k in names}

    opt = state.opt_state
    return TrainState(step=state.step, params=whole(state.params),
                      opt_state=AdamWState(count=opt.count, mu=whole(opt.mu), nu=whole(opt.nu)),
                      sampler_state=state.sampler_state, ema_params=whole(state.ema_params))


def _step_parts(replicas, sched, tx, cfg, backbone_factory):
    """One StepParts a replica; shard i's backbone, if a factory is given,
    runs over row i of its mesh."""
    return [make_step_parts(r, sched, tx, cfg, backbone_factory=None if backbone_factory is None
                            else functools.partial(backbone_factory, row=i))
            for i, r in enumerate(replicas)]


def _local_shards(batch, mesh: Mesh, t, noise, style_eps, cond_drop):
    """(one batch a local shard, one dict of injected draws a local shard)."""
    n = mesh.size
    if isinstance(batch, (list, tuple)):
        if len(batch) != n:
            raise ValueError(f"{len(batch)} batch shards for a mesh of {n}")
        shards = [{k: v for k, v in b.items() if k in _FIELDS} for b in batch]
    else:
        shards = shard_batch({k: v for k, v in batch.items() if k in _FIELDS}, mesh)
    drawn = shard_batch({"t": t, "noise": noise, "style_eps": style_eps,
                         "cond_drop": cond_drop}, mesh)
    return shards, drawn


def _averaged(per_shard, mesh: Mesh) -> Tuple[ShardGrads, list]:
    """The shards' loss, terms and gradients averaged over the mesh, and the
    per-sample t and losses gathered in global shard order (shard 0's
    device)."""
    dev0 = mesh.devices[0]
    loss, means, *grads = pmean([[s.loss, s.means, *s.grads] for s in per_shard], mesh)
    gather = lambda xs: gather_processes(gather_batch(xs, dev0), mesh)
    sg = ShardGrads(loss, grads, gather([s.t for s in per_shard]),
                    gather([s.losses for s in per_shard]), means, per_shard[0].terms)
    return sg, grads


def _check_mesh(model, mesh: Mesh) -> None:
    k = mesh.shape.get(MODEL_AXIS, 1)
    if k != 1 and getattr(model.cfg, "fused_train_backbone", False):
        raise ValueError(TP_FUSED_REFUSAL.format(k))


def _norms(grads, params, device) -> torch.Tensor:
    """[3, m] on ``device``: the inf-norm and 2-norm of each gradient and
    the 2-norm of each parameter (each computed on its own device)."""
    on = lambda ns: torch.stack([n.to(device) for n in ns])
    return torch.stack([on(torch._foreach_norm(grads, float("inf"))),
                        on(torch._foreach_norm(grads)), on(torch._foreach_norm(params))])


def shard_train_step(
    model,
    sched,
    tx: AdamW,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    fold_shard_rng: bool = True,
    backbone_factory: Optional[Callable] = None,
) -> Callable[..., Tuple[TrainState, Dict]]:
    """The data-parallel train step over ``mesh``, called like the plain
    step: ``step(state, batch, generator=None, *, t=None, noise=None,
    style_eps=None, cond_drop=None) -> (state, metrics)``.

    ``model`` is shard 0's replica (moved to its device); ``state`` is
    shard 0's state, over ``model``'s parameters. When a call gets another
    state than the one the last call returned (the first call, a resumed
    checkpoint), that state is first copied to every replica. ``batch``
    (and the injected draws) carry this process's rows of the global batch,
    which the local shards must divide, or ``batch`` is a list of one batch
    a local shard (the loaders' form with a mesh). Returns shard 0's new
    state and the metrics of the global batch: the averaged loss and terms,
    the norms of the averaged gradient, and 't' and 'loss_per_sample' of
    the global batch in global shard order on shard 0's device.
    ``step.replicas`` are the local replica modules, ``step.states()``
    every local shard's state, ``step.gathered_state()`` shard 0's over
    the model's names (a copy). ``backbone_factory(params, row=i)`` runs
    shard i's backbone (``parallel.pipeline``).

    On a model axis above 1 the replicas are tensor-parallel
    (``mesh.shard_params``; ``model`` itself stays whole and is not
    trained): the first call's state over ``model``'s names is cut to
    each, and the states returned are keyed by replica 0's parameter
    names. The fused backbone raises there (``TP_FUSED_REFUSAL``)."""
    _check_mesh(model, mesh)
    replicas = shard_params(model, mesh)
    names = [name for name, _ in model.named_parameters()]
    parts = _step_parts(replicas, sched, tx, cfg, backbone_factory)
    states = [None] * mesh.size
    dev0 = mesh.devices[0]

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None, *,
             t=None, noise=None, style_eps=None, cond_drop=None):
        if state is not states[0]:
            own = [state] if replicas[0] is model else []
            states[:] = own + [_copy_state(state, r) for r in replicas[len(own):]]
        shards, drawn = _local_shards(batch, mesh, t, noise, style_eps, cond_drop)
        gens = shard_generators(generator, mesh, fold=fold_shard_rng)
        per_shard = []
        for i, dev in enumerate(mesh.devices):
            with on_device(dev):
                per_shard.append(parts[i].shard_grads(states[i], shards[i], gens[i],
                                                      **drawn[i]))
        sg, grads = _averaged(per_shard, mesh)
        host = parts[0].read_host(states[0], sg,
                                  norms=_norms(grads, list(states[0].params.values()), dev0))
        sampler_state = parts[0].sampler_update(states[0], sg, host)
        for i, dev in enumerate(mesh.devices):
            g = [x.to(p.device) for x, p in zip(grads, states[i].params.values())]
            with on_device(dev):
                states[i] = parts[i].apply(states[i], g, host, sampler_state)
        return states[0], parts[0].metrics(sg, host)

    step.replicas = replicas
    step.states = lambda: list(states)
    step.gathered_state = lambda: _whole_state(states[0], replicas[0], names, dev0)
    return step


def _fsdp_norms(shards: FSDPShards, grads_per_shard, mesh: Mesh) -> torch.Tensor:
    """[3, m] on shard 0's device: the inf-norm and 2-norm of each gradient
    and the 2-norm of each parameter over which the step's global norms
    run: every global shard's slice of a sharded leaf, and a replicated
    leaf once (global shard 0's)."""
    dev0 = mesh.devices[0]
    local = torch.stack([_norms(grads, list(shards.states[i].params.values()), dev0)
                         for i, grads in enumerate(grads_per_shard)])  # [local shards, 3, n]
    every = gather_processes(local, mesh)  # [global shards, 3, n]
    sharded = torch.tensor([k in shards.dims for k in shards.shapes], device=dev0)
    return torch.cat([every[:, :, sharded].permute(1, 0, 2).reshape(3, -1),
                      every[0][:, ~sharded]], dim=1)


def fsdp_train_step(
    model,
    sched,
    tx: AdamW,
    cfg: TrainConfig,
    mesh: Mesh,
    *,
    min_size: int = FSDP_MIN_SIZE,
    fold_shard_rng: bool = True,
    backbone_factory: Optional[Callable] = None,
) -> Callable[..., Tuple[TrainState, Dict]]:
    """The fully sharded train step over ``mesh``, called like
    :func:`shard_train_step`. A call with another state than the one the
    last call returned takes it as a full state (over ``model``'s
    parameters: the first call, a resumed checkpoint) and slices it over the
    shards first (``step.shard(state)`` does that alone and returns shard
    0's sliced state). Returns shard 0's sliced state and the metrics of the
    global batch. ``step.shards`` is the :class:`~.mesh.FSDPShards`,
    ``step.states()`` every local shard's state, ``step.gathered_state()``
    one full copy (a checkpoint's). On a model axis above 1 each shard's
    replica is tensor-parallel and its state holds each device's slice of
    every leaf sharded on either axis (:class:`~.mesh.FSDPShards`). The
    fused backbone is refused on more than one shard, as the JAX script
    refuses ``--fsdp`` with ``--fused_train``, and on a model axis above 1
    (``TP_FUSED_REFUSAL``)."""
    _check_mesh(model, mesh)
    if getattr(model.cfg, "fused_train_backbone", False) and mesh.shape[DATA_AXIS] > 1 \
            and backbone_factory is None:
        raise ValueError(FSDP_FUSED_REFUSAL)
    shards = FSDPShards(model, mesh, min_size)
    parts = _step_parts(shards.replicas, sched, tx, cfg, backbone_factory)

    def shard(state: TrainState) -> TrainState:
        return shards.load(state)[0]

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None, *,
             t=None, noise=None, style_eps=None, cond_drop=None):
        if state is not shards.states[0]:
            shard(state)
        states = shards.states
        local, drawn = _local_shards(batch, mesh, t, noise, style_eps, cond_drop)
        gens = shard_generators(generator, mesh, fold=fold_shard_rng)
        per_shard = []
        for i, (r, dev) in enumerate(zip(shards.replicas, mesh.devices)):
            with on_device(dev):
                shards.gather(i)
                full = TrainState(step=states[i].step, params=dict(r.named_parameters()),
                                  opt_state=states[i].opt_state,
                                  sampler_state=states[i].sampler_state)
                per_shard.append(parts[i].shard_grads(full, local[i], gens[i], **drawn[i]))
                shards.free(i)
        sg, grads = _averaged(per_shard, mesh)
        del per_shard
        mine = [shards.slice_grads(grads, i) for i in range(mesh.size)]
        host = parts[0].read_host(states[0], sg, norms=_fsdp_norms(shards, mine, mesh))
        sampler_state = parts[0].sampler_update(states[0], sg, host)
        for i, dev in enumerate(mesh.devices):
            norm = None
            if cfg.grad_clip > 0:
                norm = torch.tensor(host["grad_norm"], dtype=torch.float32, device=dev)
            with on_device(dev):
                states[i] = parts[i].apply(states[i], mine[i], host, sampler_state,
                                           clip_norm=norm)
        return states[0], parts[0].metrics(sg, host)

    step.shards = shards
    step.replicas = shards.replicas
    step.shard = shard
    step.states = lambda: list(shards.states)
    step.gathered_state = shards.gathered_state
    return step
