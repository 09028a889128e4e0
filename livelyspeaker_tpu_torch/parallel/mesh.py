"""The device mesh, batch sharding, replicas and per-shard random streams.

Port of ``livelyspeaker_tpu/parallel/mesh.py:73-113``. The JAX package's
mesh is a 2-axis ``jax.sharding.Mesh`` (``data`` for the batch, ``model``
for tensor parallelism) over which GSPMD or ``shard_map`` place the work.
Here one process drives every shard, as one JAX process drives its local
devices: a :class:`Mesh` is an ordered list of ``torch.device``s on the
``data`` axis, and the ``model`` axis has size 1.

- Each shard holds its own replica of a module (:func:`replicate_module`:
  shard 0 is the module itself, the others ``copy.deepcopy`` of it on their
  devices), so a mesh may name one device twice: ``[cpu, cpu]`` on the
  CPU, ``[cuda:0, cuda:0]`` on one card. The code that runs is the same as
  on as many cards; only the device ids differ.
- Collectives are plain tensor ops in a fixed order: a mean over shards
  (:func:`pmean`) sums on shard 0's device in shard order and divides by
  N; a tiled all-gather (:func:`gather_batch`) concatenates in shard order
  there. Shards on one card therefore run one after the other.
- :func:`fold_in` is ``jax.random.fold_in(key, axis_index)``: one
  ``torch.Generator`` per shard, on that shard's device, derived from the
  parent's state and the shard index. torch's streams are not threefry's,
  so a sharded chain draws other numbers than an unsharded one (same law).

The JAX module's ``batch_sharding`` and ``replicated`` are
:func:`shard_batch` and :func:`replicate_module` here. Tensor parallelism
and FSDP (``mesh.py:115-223`` of the JAX package) are a later slice:
``model_parallel > 1`` and the JAX names of those rules raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "create_mesh", "data_parallel_mesh",
           "replicate_module",
           "sync_replicas", "shard_batch", "gather_batch", "check_divisible", "pmean",
           "fold_in", "shard_generators", "on_device", "later_slice", "param_spec",
           "param_shardings", "shard_params", "fsdp_param_shardings", "fsdp_shard_params",
           "preserve_state_shardings"]

DATA_AXIS = "data"
MODEL_AXIS = "model"

_LATER_SLICE = ("is a later slice of the port (ROADMAP.md, queue 1, item 9); the mesh "
                "is data-parallel only")


class Mesh:
    """An ordered list of devices of one type on the ``data`` axis; the
    ``model`` axis has size 1. A device may appear more than once."""

    def __init__(self, devices: Sequence):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {devs}")
        self.devices = tuple(torch.device(d.type, 0) if d.type == "cuda" and d.index is None
                             else d for d in devs)
        self.shape = {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def create_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (any list, repeats allowed), or else over the
    first ``n_devices`` local cards (all of them by default).

    There is no fallback: asking for more cards than the machine has raises,
    and so does the default where there is no card (name CPU devices, e.g.
    ``devices=["cpu", "cpu"]``, to run the plain versions on the CPU)."""
    if model_parallel != 1:
        raise NotImplementedError(f"model_parallel={model_parallel} (tensor parallelism) "
                                  + _LATER_SLICE)
    n_cards = torch.cuda.device_count()
    if devices is None:
        if n_cards == 0:
            raise RuntimeError(
                "create_mesh takes the local NVIDIA GPUs by default and "
                "torch.cuda.is_available() is False; name CPU devices "
                '(devices=["cpu", "cpu"]) to run the plain versions on the CPU')
        n = n_cards if n_devices is None else n_devices
        if n > n_cards:
            raise ValueError(f"a mesh of {n} cards needs {n} CUDA devices; this machine "
                             f"has {n_cards}")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"n_devices={n_devices} but {len(devices)} devices named")
            devices = devices[:n_devices]
        for d in devices:
            if d.type == "cuda" and (d.index or 0) >= n_cards:
                raise ValueError(f"the mesh names {d}, but this machine has {n_cards} "
                                 "CUDA devices")
    return Mesh(devices)


def data_parallel_mesh(n: int, device=None) -> Optional[Mesh]:
    """The mesh of an entry point's ``--data_parallel n``: None at 1; with
    ``device=None`` the first n cards (raising where there are fewer), with
    ``device="cpu"`` the CPU n times. Another single device raises."""
    if n <= 1:
        return None
    if device is None:
        return create_mesh(n_devices=n)
    if torch.device(device).type == "cpu":
        return create_mesh(devices=["cpu"] * n)
    raise ValueError(f"data parallelism over {n} devices takes the first {n} cards "
                     f"(no device) or the CPU; got device {device!r}")


def check_divisible(batch: int, mesh: Mesh) -> None:
    n = mesh.size
    if batch % n:
        raise ValueError(f"batch {batch} must divide the mesh data axis ({n}); pad the "
                         "batch (the serving batcher already pads to max_batch)")


def on_device(device: torch.device):
    """Make ``device`` current for the launches of one shard (its kernels go
    to that card's current stream); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate_module(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One replica a shard: ``module`` itself, moved to shard 0's device,
    then a deep copy of it on each other shard's device (bit-identical)."""
    module.to(mesh.devices[0])
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.devices[1:]]


@torch.no_grad()
def sync_replicas(replicas: Sequence[torch.nn.Module]) -> None:
    """Copy replica 0's parameters and buffers into every other replica."""
    src = replicas[0].state_dict()
    for r in replicas[1:]:
        for k, v in r.state_dict().items():
            v.copy_(src[k])


def _map(tree, leaf_fn):
    if isinstance(tree, dict):
        return {k: _map(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_map(v, leaf_fn) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), leaf_fn)
                                            for f in dataclasses.fields(tree) if f.init})
    return leaf_fn(tree)


def _rows(x) -> Optional[int]:
    """The batch length of a leaf that is split over shards, else None."""
    if isinstance(x, torch.Tensor):
        return x.shape[0] if x.ndim else None
    if isinstance(x, np.ndarray):
        return x.shape[0] if x.ndim else None
    if isinstance(x, list):
        return len(x)
    return None


def shard_batch(tree: Any, mesh: Mesh) -> List[Any]:
    """``tree`` (dicts, NamedTuples and dataclasses of tensors, arrays and
    lists) as one
    tree a shard: every leaf with a leading batch axis split into N equal
    chunks in shard order, each on its shard's device (numpy arrays become
    tensors; a pinned host tensor is copied with ``non_blocking``). Scalars,
    strings and None are the same on every shard; a 0-d tensor is copied to
    each shard's device. Raises if N does not divide a batch length."""
    n = mesh.size

    def leaf(i, dev):
        def split(x):
            rows = _rows(x)
            if rows is None:
                return x.to(dev) if isinstance(x, torch.Tensor) else x
            check_divisible(rows, mesh)
            lo, hi = i * rows // n, (i + 1) * rows // n
            if isinstance(x, list):
                return x[lo:hi]
            if isinstance(x, np.ndarray):
                if x.dtype == object:
                    return x[lo:hi]
                x = torch.from_numpy(x)
            return x[lo:hi].to(dev, non_blocking=x.is_pinned())
        return split

    return [_map(tree, leaf(i, d)) for i, d in enumerate(mesh.devices)]


def gather_batch(shards: Sequence[Any], device: Optional[torch.device] = None) -> Any:
    """The tiled all-gather: the shards' trees concatenated leaf by leaf in
    shard order, tensors on ``device`` (shard 0's by default). Leaves
    without a batch axis are taken from shard 0."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: gather_batch([s[k] for s in shards], device) for k in first}
    if isinstance(first, torch.Tensor) and first.ndim:
        dev = first.device if device is None else device
        return torch.cat([s.to(dev) for s in shards])
    if isinstance(first, list):
        return [x for s in shards for x in s]
    return first


def pmean(per_shard: Sequence[List[torch.Tensor]]) -> List[torch.Tensor]:
    """The mean over shards of lists of tensors: summed on shard 0's device
    in shard order, then divided by N (``jax.lax.pmean`` of one value a
    shard). The result lies on shard 0's device."""
    acc = list(per_shard[0])
    for shard in per_shard[1:]:
        acc = torch._foreach_add(acc, [x.to(a.device) for x, a in zip(shard, acc)])
    return torch._foreach_div(acc, float(len(per_shard)))


def fold_in(generator: torch.Generator, index: int,
            device: Optional[torch.device] = None) -> torch.Generator:
    """A new generator on ``device`` (the parent's by default) whose seed is
    a hash of the parent's current state and ``index``: deterministic in
    both, and the parent is not advanced (``jax.random.fold_in``)."""
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(index).to_bytes(8, "little"), digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & (2 ** 63 - 1)
    return torch.Generator(device=device or generator.device).manual_seed(seed)


def shard_generators(generator: Optional[torch.Generator], mesh: Mesh,
                     fold: bool = True) -> List[Optional[torch.Generator]]:
    """One generator a shard, on its device: ``fold_in(generator, i)``, or
    with ``fold=False`` a copy of the parent's state on every shard (every
    shard draws what the parent would). The parent then advances by one
    draw, so the next call derives other streams. None gives None a shard
    (each device's default generator)."""
    if generator is None:
        return [None] * mesh.size
    if fold:
        gens = [fold_in(generator, i, d) for i, d in enumerate(mesh.devices)]
    else:
        state = generator.get_state()
        gens = []
        for d in mesh.devices:
            if d.type != generator.device.type:
                raise ValueError(f"fold_shard_rng=False copies the generator's state: a "
                                 f"{generator.device.type} generator cannot drive shards "
                                 f"on {d}")
            g = torch.Generator(device=d)
            g.set_state(state)
            gens.append(g)
    torch.empty(1, device=generator.device).random_(generator=generator)
    return gens


def later_slice(name: str, what: str):
    """A stand-in for a JAX name of a later slice: calling it raises."""
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name} ({what}) " + _LATER_SLICE)
    refuse.__name__ = name
    return refuse


# tensor parallelism and FSDP, ``mesh.py:115-223`` of the JAX package
param_spec = later_slice("param_spec", "tensor parallelism")
param_shardings = later_slice("param_shardings", "tensor parallelism")
shard_params = later_slice("shard_params", "tensor parallelism")
fsdp_param_shardings = later_slice("fsdp_param_shardings", "FSDP")
fsdp_shard_params = later_slice("fsdp_shard_params", "FSDP")
preserve_state_shardings = later_slice("preserve_state_shardings", "FSDP")
