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
(:func:`make_pipeline_backbone_factory`). Tensor-parallel compute inside a
stage (a model axis above 1) is a later slice and raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from ..models.mlp_backbone import (PE_MAX_LEN, get_activation, mlp_block, sinusoidal_table,
                                   timestep_embedding)
from .mesh import DATA_AXIS, Mesh, create_mesh, refuse_tensor_parallel

__all__ = ["STAGE_AXIS", "PipelineMesh", "create_pipeline_mesh", "stack_block_params",
           "pipeline_spec", "pipeline_forward", "make_pipeline_backbone_factory"]

STAGE_AXIS = "stage"


class PipelineMesh(Mesh):
    """Data rows by stages over this process's devices (repeats allowed):
    ``grid[r][s]`` runs stage s of row r. As a :class:`Mesh` its shards are
    the rows, each on its first stage's device; ``shape`` is ``{"data":
    rows (times the processes), "stage": S}``, with no model axis."""

    def __init__(self, grid: Sequence[Sequence]):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or len({len(row) for row in rows}) != 1:
            raise ValueError(f"a pipeline mesh is rows of equal length, got {grid}")
        super().__init__([d for row in rows for d in row])  # checks the device type
        first = self.devices[::len(rows[0])]
        self.grid = tuple(self.devices[r * len(rows[0]):(r + 1) * len(rows[0])]
                          for r in range(len(rows)))
        self.devices = first
        self.shape = {DATA_AXIS: self.process_count * len(first), STAGE_AXIS: len(rows[0])}

    def __repr__(self) -> str:
        return f"PipelineMesh({[[str(d) for d in row] for row in self.grid]})"


def create_pipeline_mesh(n_devices: Optional[int] = None, pipeline_parallel: int = 2,
                         model_parallel: int = 1,
                         devices: Optional[Sequence] = None) -> PipelineMesh:
    """A grid of ``n / pipeline_parallel`` data rows by ``pipeline_parallel``
    stages over ``devices`` (any list, repeats allowed), or else over the
    first ``n_devices`` local cards (all of them by default), row-major as
    the JAX mesh reshapes its device list."""
    refuse_tensor_parallel("create_pipeline_mesh", model_parallel)
    devs = list(create_mesh(n_devices=n_devices, devices=devices).devices)
    if len(devs) % pipeline_parallel:
        raise ValueError(f"{len(devs)} devices do not divide into pipelines of "
                         f"{pipeline_parallel} stages")
    s = pipeline_parallel
    return PipelineMesh([devs[r * s:(r + 1) * s] for r in range(len(devs) // s)])


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
    """Each stacked leaf's split: its leading layer axis over ``stage``.
    The tensor-parallel split of the channel mix is a later slice."""
    if tensor_parallel:
        refuse_tensor_parallel("pipeline_spec(tensor_parallel=True)", 2)
    return {k: (STAGE_AXIS,) + (None,) * (v.ndim - 1) for k, v in stacked.items()}


def _block(p: Mapping[str, torch.Tensor], l: int, x: torch.Tensor, emb: torch.Tensor,
           act: Callable) -> torch.Tensor:
    """Block l of a stage's stacked parameters: ``MLPBlock``'s arithmetic
    (``models/mlp_backbone.py: mlp_block``) on those weights."""
    return mlp_block(x, emb, *(p[name][l] for name in _STACKED), act)


def _pipeline_row(stacked: Mapping[str, torch.Tensor], x: torch.Tensor, emb: torch.Tensor,
                  devices: Sequence[torch.device], m: int, act: Callable) -> torch.Tensor:
    """One pipeline over ``devices`` (its stages), ``m`` microbatches: the
    GPipe schedule of ``pipeline.py:200-225`` as a loop over M + S - 1
    ticks. Returns the output on ``x``'s device."""
    s_count = len(devices)
    per = stacked["ch_w"].shape[0] // s_count
    stages = [{k: v[s * per:(s + 1) * per].to(dev) for k, v in stacked.items()}
              for s, dev in enumerate(devices)]
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
    a data-parallel step). Returns [B, T, D] on ``x``'s device, the
    sequential stack's numbers (same float ops a block)."""
    n_stages = mesh.shape[STAGE_AXIS]
    n_layers = stacked["ch_w"].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"layers {n_layers} not divisible by stages {n_stages}")
    m = num_microbatches if num_microbatches is not None else n_stages
    if row is not None:
        rows = [mesh.grid[row]]
    else:
        rows = list(mesh.grid) if data_sharded else [mesh.grid[0]]
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
