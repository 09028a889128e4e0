"""GPipe-style pipeline parallelism over the TransMLP mixer stack.

Port of ``livelyspeaker_tpu/parallel/pipeline.py``. The L identical mixer
blocks are stacked layer-major (:func:`stack_block_params`) and split over
a ``stage`` axis: stage s holds blocks s*L/S .. (s+1)*L/S - 1 on its
device. The JAX package runs the whole (M + S - 1)-tick schedule as one
``shard_map`` program that rotates microbatch activations with
``lax.ppermute``; here one process drives the schedule as a Python loop
(:func:`pipeline_forward`): at tick t stage s runs microbatch t - s, and the
activation moves to the next stage's device with ``.to()``. Every op is
differentiable, so autograd pipelines the backward in reverse, and the
stacking (``torch.stack``) lands the gradients on the per-block parameters:
the optimizer state and the checkpoint layout do not change.

Composable with data parallelism: a pipeline mesh is a grid of data rows
by stages (:func:`create_pipeline_mesh`). A row is one shard of the
data-parallel (or FSDP) step, its replica on the row's first device, and
its backbone runs over the row's stage devices
(:func:`make_pipeline_backbone_factory`). With a model axis above 1 each
stage is a model group of k devices, and the channel mix inside every
stage is column-parallel over it (``pipeline.py:103-144`` of the JAX
package): device j of the stage holds columns j of each block's ``ch_w``
and ``ch_b`` and computes its slice of the mix, and a tiled all-gather in
rank order re-forms the width on the stage's first device before the
residual (``tensor_parallel.column_parallel``). The rest of the model stays
whole on each row, as the JAX pipeline splits only the channel mix.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from ..models.mlp_backbone import (PE_MAX_LEN, get_activation, mlp_block, sinusoidal_table,
                                   timestep_embedding)
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh
from .tensor_parallel import Split

__all__ = ["STAGE_AXIS", "PipelineMesh", "create_pipeline_mesh", "stack_block_params",
           "pipeline_spec", "pipeline_forward", "make_pipeline_backbone_factory"]

STAGE_AXIS = "stage"


class PipelineMesh(Mesh):
    """Data rows by stages by model columns over this process's devices
    (repeats allowed): ``stage_groups[r][s]`` are the k devices of stage s
    of row r, ``grid[r][s]`` the first of them, which runs the stage's
    block arithmetic. As a :class:`Mesh` its shards are the rows, each on
    its first stage's first device, and a row's model group is that one
    device (the model axis splits only the channel mix inside the stages);
    ``shape`` is ``{"data": rows (times the processes), "stage": S}``, with
    ``"model": k`` where k is above 1, as the JAX mesh has its axes."""

    def __init__(self, grid: Sequence[Sequence], model_parallel: int = 1):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or len({len(row) for row in rows}) != 1:
            raise ValueError(f"a pipeline mesh is rows of equal length, got {grid}")
        k = model_parallel
        if len(rows[0]) % k:
            raise ValueError(f"{len(rows[0])} devices a row do not divide into model groups "
                             f"of model_parallel={k}")
        super().__init__([d for row in rows for d in row], len(rows[0]))  # checks the type
        n_stages = len(rows[0]) // k
        self.stage_groups = tuple(tuple(row[s * k:(s + 1) * k] for s in range(n_stages))
                                  for row in self.groups)
        self.grid = tuple(tuple(g[0] for g in row) for row in self.stage_groups)
        self.groups = tuple((row[0],) for row in self.grid)
        self.shape = {DATA_AXIS: self.process_count * len(rows), STAGE_AXIS: n_stages}
        if k > 1:
            self.shape[MODEL_AXIS] = k

    def __repr__(self) -> str:
        if MODEL_AXIS in self.shape:
            return f"PipelineMesh({[[[str(d) for d in g] for g in r] for r in self.stage_groups]})"
        return f"PipelineMesh({[[str(d) for d in row] for row in self.grid]})"


def create_pipeline_mesh(n_devices: Optional[int] = None, pipeline_parallel: int = 2,
                         model_parallel: int = 1,
                         devices: Optional[Sequence] = None) -> PipelineMesh:
    """A grid of ``n / (pipeline_parallel * model_parallel)`` data rows by
    ``pipeline_parallel`` stages by ``model_parallel`` model columns over
    ``devices`` (any list, repeats allowed), or else over the first
    ``n_devices`` local cards (all of them by default), row-major as the JAX
    mesh reshapes its device list (``pipeline.py:54-77``)."""
    devs = [d for g in create_mesh(n_devices=n_devices, devices=devices).groups for d in g]
    per_row = pipeline_parallel * model_parallel
    if len(devs) % per_row:
        raise ValueError(f"{len(devs)} devices do not divide into pipelines of "
                         f"{pipeline_parallel} stages of {model_parallel} model columns")
    return PipelineMesh([devs[r * per_row:(r + 1) * per_row] for r in range(len(devs) // per_row)],
                        model_parallel)


_STACKED = {  # stacked name (the JAX module's): the block parameter, in mlp_block's order
    "ln1_scale": "ln1.weight", "ln1_bias": "ln1.bias",
    "token_w": "token_mix_kernel", "token_b": "token_mix_bias",
    "ln2_scale": "ln2.weight", "ln2_bias": "ln2.bias",
    "ch_w": "channel_mix.weight", "ch_b": "channel_mix.bias",
}


def stack_block_params(backbone_params: Mapping[str, torch.Tensor],
                       num_layers: int) -> Dict[str, torch.Tensor]:
    """The per-block parameters of a TransMLP (state_dict keys
    ``block_{i}.ln1.weight``, ...) stacked layer-major: [L, D] LayerNorm
    vectors, [L, T, T] token mix and [L, T] its bias, [L, D_out, D_in]
    channel mix (torch's layout) and [L, D] its bias. ``torch.stack`` is
    differentiable, so gradients reach the per-block parameters."""
    return {name: torch.stack([backbone_params[f"block_{i}.{key}"] for i in range(num_layers)])
            for name, key in _STACKED.items()}


def pipeline_spec(stacked: Mapping[str, torch.Tensor],
                  tensor_parallel: bool = False) -> Dict[str, tuple]:
    """Each stacked leaf's split: its leading layer axis over ``stage``;
    with ``tensor_parallel`` the channel mix's output dim also over
    ``model``. That is JAX's ``ch_w`` ``(stage, None, model)`` of the Flax
    [L, D_in, D_out] layout carried to the port's [L, D_out, D_in]:
    ``(stage, model, None)``; ``ch_b`` is ``(stage, model)``."""
    spec = {k: (STAGE_AXIS,) + (None,) * (v.ndim - 1) for k, v in stacked.items()}
    if tensor_parallel:
        spec["ch_w"] = (STAGE_AXIS, MODEL_AXIS, None)
        spec["ch_b"] = (STAGE_AXIS, MODEL_AXIS)
    return spec


def _block(p: Mapping[str, Sequence], l: int, x: torch.Tensor, emb: torch.Tensor,
           act: Callable) -> torch.Tensor:
    """Block l of a stage's stacked parameters: ``MLPBlock``'s arithmetic
    (``models/mlp_backbone.py: mlp_block``) on those weights. Under tensor
    parallelism ``ch_w[l]`` and ``ch_b[l]`` are :class:`Split` s of the
    stage's model group, and the channel mix is column-parallel."""
    return mlp_block(x, emb, *(p[name][l] for name in _STACKED), act)


def _stage_params(stacked: Mapping[str, torch.Tensor], lo: int, hi: int,
                  group: Sequence[torch.device]) -> Dict[str, Sequence]:
    """Layers lo..hi-1 on a stage's devices: whole on its first; with a
    model group of k, ``ch_w`` and ``ch_b`` as one :class:`Split` a layer,
    output columns j on device j."""
    split = ("ch_w", "ch_b") if len(group) > 1 else ()
    out = {k: v[lo:hi].to(group[0]) for k, v in stacked.items() if k not in split}
    for name in split:
        parts = [c.to(dev) for c, dev in zip(stacked[name][lo:hi].chunk(len(group), 1), group)]
        out[name] = [Split([c[l] for c in parts], 0) for l in range(hi - lo)]
    return out


def _pipeline_row(stacked: Mapping[str, torch.Tensor], x: torch.Tensor, emb: torch.Tensor,
                  groups: Sequence[Sequence[torch.device]], m: int,
                  act: Callable) -> torch.Tensor:
    """One pipeline over ``groups`` (its stages' model groups), ``m``
    microbatches: the GPipe schedule of ``pipeline.py:200-225`` as a loop
    over M + S - 1 ticks. Returns the output on ``x``'s device."""
    s_count = len(groups)
    devices = [g[0] for g in groups]
    per = stacked["ch_w"].shape[0] // s_count
    stages = [_stage_params(stacked, s * per, (s + 1) * per, g) for s, g in enumerate(groups)]
    x_mb, emb_mb = x.chunk(m), emb.chunk(m)
    outputs: List[Optional[torch.Tensor]] = [None] * m
    leaving: List[Optional[torch.Tensor]] = [None] * s_count  # each stage's last output
    for tick in range(m + s_count - 1):
        arrived = list(leaving)
        for s, dev in enumerate(devices):
            mb = tick - s  # microbatch mb enters stage 0 at tick mb, stage s at tick mb + s
            if not 0 <= mb < m:
                continue
            h = (x_mb[mb] if s == 0 else arrived[s - 1]).to(dev)
            e = emb_mb[mb].to(dev)
            for l in range(per):
                h = _block(stages[s], l, h, e, act)
            leaving[s] = h
            if s == s_count - 1:
                outputs[mb] = h.to(x.device)
    return torch.cat(outputs)


def pipeline_forward(stacked: Mapping[str, torch.Tensor], x: torch.Tensor, emb: torch.Tensor,
                     mesh: PipelineMesh, *, num_microbatches: Optional[int] = None,
                     act: str = "silu", data_sharded: bool = True,
                     row: Optional[int] = None) -> torch.Tensor:
    """The whole mixer stack over the mesh's stages.

    stacked: layer-major parameters (:func:`stack_block_params`), L a
    multiple of the stages S. x: [B, T, D] activations (after the input
    projection, before block 0); emb: [B, 1, D], the timestep embedding
    added at every block. ``num_microbatches`` M defaults to S; the batch of
    each pipeline must divide M. With ``data_sharded`` the batch is split
    over the mesh's local data rows, each its own pipeline; else one row
    runs it all. ``row`` runs the whole batch on that row alone (a shard of
    a data-parallel step). On a mesh with a model axis above 1 the channel
    mix of every stage is column-parallel over its model group. Returns [B,
    T, D] on ``x``'s device, the sequential stack's numbers (same float ops
    a block; under tensor parallelism each column the same dot product).
    """
    n_stages = mesh.shape[STAGE_AXIS]
    n_layers = stacked["ch_w"].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"layers {n_layers} not divisible by stages {n_stages}")
    k = mesh.shape.get(MODEL_AXIS, 1)
    if stacked["ch_w"].shape[1] % k:
        raise ValueError(f"width {stacked['ch_w'].shape[1]} not divisible by the model axis {k}")
    m = num_microbatches if num_microbatches is not None else n_stages
    if row is not None:
        rows = [mesh.stage_groups[row]]
    else:
        rows = list(mesh.stage_groups) if data_sharded else [mesh.stage_groups[0]]
    if x.shape[0] % len(rows):
        raise ValueError(f"batch {x.shape[0]} must divide the mesh's {len(rows)} data rows")
    b = x.shape[0] // len(rows)
    if b % m:
        raise ValueError(f"per-pipeline batch {b} not divisible by M={m}")
    act_fn = get_activation(act)
    return torch.cat([_pipeline_row(stacked, xr, er, devs, m, act_fn)
                      for xr, er, devs in zip(x.chunk(len(rows)), emb.chunk(len(rows)), rows)])


def make_pipeline_backbone_factory(model_cfg, mesh: PipelineMesh, *,
                                   num_microbatches: Optional[int] = None) -> Callable:
    """The ``backbone_factory`` hook of ``training.trainer.make_train_step``
    (and of the parallel steps): ``factory(params, row=0)`` takes the live
    parameters by state_dict key and gives ``backbone_apply(h, t)``, which
    computes the timestep embedding with ``TimestepEmbedder``'s arithmetic
    on the ``backbone.embed_timestep`` weights, stacks the blocks layer-major
    and runs them GPipe-style over row ``row``'s stages
    (:func:`pipeline_forward`)."""
    if STAGE_AXIS not in mesh.shape:
        raise ValueError(f"mesh has no '{STAGE_AXIS}' axis: {mesh}")
    n_stages = mesh.shape[STAGE_AXIS]
    if model_cfg.num_layers % n_stages:
        raise ValueError(f"layers {model_cfg.num_layers} not divisible by {n_stages} stages")
    pe_on = {}  # TimestepEmbedder's PE table on each device

    def factory(params: Mapping[str, torch.Tensor], row: int = 0):
        bb = {k[len("backbone."):]: v for k, v in params.items() if k.startswith("backbone.")}
        stacked = stack_block_params(bb, model_cfg.num_layers)
        embed = [bb[f"embed_timestep.{k}"] for k in ("fc1.weight", "fc1.bias", "fc2.weight",
                                                     "fc2.bias")]

        def backbone_apply(h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            if h.device not in pe_on:
                pe_on[h.device] = sinusoidal_table(PE_MAX_LEN, model_cfg.latent_dim).to(h.device)
            emb = timestep_embedding(pe_on[h.device], t, *embed)
            return pipeline_forward(stacked, h, emb, mesh, num_microbatches=num_microbatches,
                                    act=model_cfg.mlpact, row=row)

        return backbone_apply

    return factory
