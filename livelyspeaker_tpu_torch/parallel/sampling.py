"""Batch-parallel sampling over a mesh: each shard runs the whole chain.

Port of ``livelyspeaker_tpu/parallel/sampling.py:47-100``. The JAX package
has two routes: GSPMD for the XLA denoiser, whose draws equal the single
device program's because threefry is partitionable, and ``shard_map`` for
the fused Pallas denoiser, where each shard folds its index into the key.
The port has one route, the second, for both denoisers: a shard runs the
chain on its replica and its slice of every batched argument, with its own
generator (``mesh.fold_in``). torch's streams are not partitionable, so a
sharded chain draws other numbers than the unsharded one, on the eager
route too (same law; with the draws injected, e.g. DDIM at eta 0 from a
given ``noise``, the results agree).

A shard is a data row of the mesh. On a model axis above 1 its replica is
a tensor-parallel one (``mesh.shard_params``), which is the counterpart of
the GSPMD route under the rules' shardings; the fused denoiser is refused
there with the JAX package's words (``sampling.py:78-81``), as K1 is a
single-card design.

Each shard's launches are enqueued without a host sync, so shards on
different cards overlap; shards on one card run one after the other.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from .mesh import MODEL_AXIS, Mesh, gather_batch, on_device, shard_batch, shard_generators

__all__ = ["shard_sample_fn", "TP_FUSED_REFUSAL"]

# the fused denoiser on a model axis above 1 (parallel/sampling.py:78-81 of the JAX package)
TP_FUSED_REFUSAL = "shard_map sampling mode is data-parallel only; got model axis of size {}"


def shard_sample_fn(fn: Callable, mesh: Mesh, replicas: Sequence, batched: Sequence[bool],
                    *, rng_arg: Optional[int] = None, fused: bool = False) -> Callable:
    """Wrap ``fn(replica, *args, **kw) -> [B, ...]`` for the mesh.

    ``replicas[i]`` is what shard i's call receives first (its model, or a
    tuple of models). ``batched[i]`` marks ``args[i]`` as carrying a
    leading global-batch axis, split over the shards (dicts and dataclasses
    of tensors are split leaf by leaf; scalars in a batched slot are the
    same on every shard); the other arguments and the keyword arguments
    are passed unchanged. ``rng_arg`` names the argument that holds the
    ``torch.Generator`` (or None), replaced on each shard by its folded
    generator. The outputs are concatenated in shard order on shard 0's
    device. The global batch must divide the mesh size. A mesh that spans
    processes raises: nothing samples across processes; so does ``fused``
    (``fn`` runs the fused kernel) on a model axis above 1."""
    k = mesh.shape.get(MODEL_AXIS, 1)
    if fused and k != 1:
        raise ValueError(TP_FUSED_REFUSAL.format(k))
    if mesh.process_count > 1:
        raise ValueError("sampling runs within one process, as in the JAX package; the mesh "
                         f"{mesh} spans {mesh.process_count} processes")
    if rng_arg is not None and batched[rng_arg]:
        raise ValueError(f"argument {rng_arg} is the generator and cannot be batched")
    n = mesh.size

    def sharded(*args, **kw):
        if len(args) != len(batched):
            raise TypeError(f"expected {len(batched)} arguments, got {len(args)}")
        per_arg = [shard_batch(a, mesh) if b else [a] * n for a, b in zip(args, batched)]
        if rng_arg is not None:
            per_arg[rng_arg] = shard_generators(args[rng_arg], mesh)
        outs = []
        for i, dev in enumerate(mesh.devices):
            with on_device(dev):
                outs.append(fn(replicas[i], *(a[i] for a in per_arg), **kw))
        return gather_batch(outs, mesh.devices[0])

    return sharded
