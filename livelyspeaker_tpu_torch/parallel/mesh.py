"""The device mesh, batch sharding, replicas, collectives, per-shard random
streams, and the parameter rules with FSDP.

Port of ``livelyspeaker_tpu/parallel/mesh.py``. The JAX package's mesh is
a 2-axis ``jax.sharding.Mesh`` (``data`` for the batch, ``model`` for
tensor parallelism) over which GSPMD or ``shard_map`` place the work. Here
one process drives each of its local shards, as one JAX process drives its
local devices: a :class:`Mesh` is an ordered list of ``torch.device``s laid
out as JAX lays them (``reshape(n // k, k)``): data rows by model columns.
A data row is a shard: its batch slice, activations and outputs live on
its first device (``mesh.devices``), and its model group
(:meth:`Mesh.model_group`, k devices) holds the slices of the weights the
rules split over the ``model`` axis.

- Each shard holds its own replica of a module (:func:`replicate_module`:
  shard 0 is the module itself, the others ``copy.deepcopy`` of it on their
  devices), so a mesh may name one device twice: ``[cpu, cpu]`` on the
  CPU, ``[cuda:0, cuda:0]`` on one card. The code that runs is the same as
  on as many cards; only the device ids differ.
- On a model axis above 1, :func:`shard_params` gives each data row a
  tensor-parallel replica (``tensor_parallel.tp_replica``): each parameter
  the rules split (the JAX divisibility rule applied: a ruled dim the axis
  does not divide leaves the whole leaf replicated) is held as k slices,
  slice j on the row's j-th device, and its products are the column-, row-
  parallel and embedding products of ``parallel/tensor_parallel.py``;
  every other parameter is whole on the row's first device. A model group
  never spans processes. The devices of a group share their row's random
  stream, as GSPMD shares one key over the model axis.
- When ``torch.distributed`` is initialised (``multihost.init_distributed``)
  the mesh also spans the process group: ``shape["data"]`` is the world
  size times the local devices, and local shard i of process r is global
  shard ``r * local + i``. Without a process group the mesh is the
  process's own.
- Collectives are tensor ops in a fixed order: a mean over shards
  (:func:`pmean`) sums the local shards on shard 0's device in shard order,
  then (across processes) all-reduces that sum, and divides by the global
  N; a tiled all-gather (:func:`gather_batch`) concatenates in shard order
  there, and :func:`gather_processes` places each process's rows at their
  offset in a zero buffer and all-reduces its bytes, which is exact
  (x + 0 = x, byte by byte) on both backends. Shards on one card run one
  after the other.
- :func:`fold_in` is ``jax.random.fold_in(key, axis_index)``: one
  ``torch.Generator`` per shard, on that shard's device, derived from the
  parent's state and the global shard index. torch's streams are not
  threefry's, so a sharded chain draws other numbers than an unsharded one
  (same law).
- The parameter rules (``mesh.py:100-222`` of the JAX package) match the
  Flax path of each torch parameter (``utils/convert.py``'s name map) and
  carry each dim through its transpose: the port's spec of a tensor names
  the dim the JAX spec names for its Flax counterpart. A spec is a tuple
  of one axis name or None a dim. :func:`fsdp_shard_params` slices a train
  state over the data axis (ZeRO-3: params, Adam moments and the EMA hold
  1/N of every sharded leaf on each shard); the step that trains it is
  ``parallel.training.fsdp_train_step``.

The JAX module's ``batch_sharding`` and ``replicated`` are
:func:`shard_batch` and :func:`replicate_module` here.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import convert
from .tensor_parallel import merge_values, split_values, tp_layout, tp_replica

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "create_mesh", "data_parallel_mesh",
           "replicate_module", "whole_state_dict",
           "sync_replicas", "shard_batch", "gather_batch", "check_divisible", "pmean",
           "gather_processes", "fold_in", "shard_generators", "on_device",
           "param_spec", "param_shardings", "shard_params", "FSDP_MIN_SIZE",
           "fsdp_param_shardings", "fsdp_shard_params", "FSDPShards",
           "preserve_state_shardings"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _process_group() -> Tuple[bool, int, int]:
    """(whether a process group is initialised, its world size, this
    process's rank): (False, 1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return True, dist.get_world_size(), dist.get_rank()
    return False, 1, 0


class Mesh:
    """This process's devices, of one type, as data rows of
    ``model_parallel`` devices each (``reshape(n // k, k)``, row-major). A
    device may appear more than once. ``devices`` holds each row's first
    device, where its shard lives; ``model_group(i)`` all of row i's.
    Under an initialised process group the data axis spans every process
    (``shape["data"]`` = world size x local rows); ``size`` is the number of
    local shards (rows); its collectives go through the group
    (``distributed``), even a group of one process."""

    def __init__(self, devices: Sequence, model_parallel: int = 1):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {devs}")
        devs = [torch.device(d.type, 0) if d.type == "cuda" and d.index is None else d
                for d in devs]
        k = model_parallel
        if k < 1 or len(devs) % k:
            raise ValueError(f"{len(devs)} devices do not divide into model groups of "
                             f"model_parallel={k} (a model group never spans processes)")
        self.groups = tuple(tuple(devs[r * k:(r + 1) * k]) for r in range(len(devs) // k))
        self.devices = tuple(g[0] for g in self.groups)
        self.distributed, self.process_count, self.process_index = _process_group()
        self.shape = {DATA_AXIS: self.process_count * len(self.devices), MODEL_AXIS: k}

    @property
    def size(self) -> int:
        return len(self.devices)

    def model_group(self, i: int) -> Tuple[torch.device, ...]:
        """Local row i's devices along the model axis, its shard's first."""
        return self.groups[i]

    def shard_index(self, i: int) -> int:
        """The global data index of local shard i."""
        return self.process_index * self.size + i

    def __repr__(self) -> str:
        span = f", process {self.process_index} of {self.process_count}" \
            if self.process_count > 1 else ""
        rows = [str(d) for d in self.devices] if self.shape[MODEL_AXIS] == 1 else \
            [[str(d) for d in g] for g in self.groups]
        return f"Mesh({rows}{span})"


def create_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (any list, repeats allowed), or else over the
    first ``n_devices`` local cards (all of them by default), laid out as
    data rows of ``model_parallel`` devices (``ValueError`` where that does
    not divide the count).

    There is no fallback: asking for more cards than the machine has raises,
    and so does the default where there is no card (name CPU devices, e.g.
    ``devices=["cpu", "cpu"]``, to run the plain versions on the CPU)."""
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
    return Mesh(devices, model_parallel)


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
    """One whole replica a shard: ``module`` itself, moved to shard 0's
    device, then a deep copy of it on each other shard's device
    (bit-identical). The model axis is not used: :func:`shard_params`
    splits the ruled weights over it."""
    module.to(mesh.devices[0])
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.devices[1:]]


def whole_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` under the model's names: the slices of a
    tensor-parallel replica concatenated on its first device."""
    sd = module.state_dict()
    layout = tp_layout(module)
    if all(dim is None for _, dim, _, _ in layout.values()):
        return sd
    dev = next(module.parameters()).device
    whole = {k: v for k, v in sd.items() if k not in layout}
    whole.update(merge_values({k: sd[k] for k in layout}, layout, dev))
    return whole


@torch.no_grad()
def sync_replicas(replicas: Sequence[torch.nn.Module],
                  source: Optional[torch.nn.Module] = None) -> None:
    """Copy the parameters and buffers of ``source`` (replica 0 by default;
    whole or tensor-parallel) into every replica; a tensor-parallel replica
    takes its slices (the re-slice of a hot-swapped checkpoint)."""
    src = replicas[0] if source is None else source
    whole = whole_state_dict(src)
    for r in replicas:
        if r is src:
            continue
        layout = tp_layout(r)
        for k, v in r.state_dict().items():
            name, dim, j, n = layout.get(k, (k, None, 0, 1))
            v.copy_(whole[name] if dim is None else whole[name].chunk(n, dim)[j])


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


def _exact_all_reduce(flat: torch.Tensor) -> None:
    """Sum ``flat`` over the process group in place, byte by byte: exact
    where at most one process holds a non-zero byte (an all-gather into a
    zero buffer), on gloo and NCCL alike."""
    dist.all_reduce(flat.view(torch.uint8))


def _all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sums over the process group, one flat all-reduce a
    dtype and device."""
    out = list(tensors)
    for key in dict.fromkeys((t.dtype, t.device) for t in tensors):
        idx = [i for i, t in enumerate(tensors) if (t.dtype, t.device) == key]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def pmean(per_shard: Sequence[List[torch.Tensor]], mesh: Optional[Mesh] = None
          ) -> List[torch.Tensor]:
    """The mean over shards of lists of tensors: summed on shard 0's device
    in shard order, then, on a mesh that spans processes, summed over the
    process group, then divided by the global N (``jax.lax.pmean`` of one
    value a shard). The result lies on shard 0's device."""
    acc = list(per_shard[0])
    for shard in per_shard[1:]:
        acc = torch._foreach_add(acc, [x.to(a.device) for x, a in zip(shard, acc)])
    n = len(per_shard)
    if mesh is not None and mesh.distributed:
        acc, n = _all_reduce_sum(acc), mesh.shape[DATA_AXIS]
    return torch._foreach_div(acc, float(n))


def gather_processes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The all-gather over the process group of this process's rows of a
    tiled batch (``x``, in local shard order): the global batch in global
    shard order, on ``x``'s device; ``x`` itself on a process's own mesh."""
    if not mesh.distributed:
        return x
    rows = x.shape[0]
    out = x.new_zeros((mesh.process_count * rows,) + tuple(x.shape[1:]))
    out[mesh.process_index * rows:(mesh.process_index + 1) * rows] = x
    _exact_all_reduce(out)
    return out


def fold_in(generator: torch.Generator, index: int,
            device: Optional[torch.device] = None) -> torch.Generator:
    """A new generator on ``device`` (the parent's by default) whose seed is
    a hash of the parent's current state and ``index`` (a global shard
    index: every process seeds the parent alike): deterministic in both,
    and the parent is not advanced (``jax.random.fold_in``)."""
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(index).to_bytes(8, "little"), digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & (2 ** 63 - 1)
    return torch.Generator(device=device or generator.device).manual_seed(seed)


def shard_generators(generator: Optional[torch.Generator], mesh: Mesh,
                     fold: bool = True) -> List[Optional[torch.Generator]]:
    """One generator a local shard, on its device: ``fold_in(generator,
    mesh.shard_index(i))``, or
    with ``fold=False`` a copy of the parent's state on every shard (every
    shard draws what the parent would). The parent then advances by one
    draw, so the next call derives other streams. None gives None a shard
    (each device's default generator)."""
    if generator is None:
        return [None] * mesh.size
    if fold:
        gens = [fold_in(generator, mesh.shard_index(i), d) for i, d in enumerate(mesh.devices)]
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


# --- the parameter rules (``mesh.py:100-113`` of the JAX package) -----------
#
# A regex over the Flax path of a parameter and the spec of its Flax layout.
# Only the wide (latent x latent or wider) matmuls carry a model-axis rule;
# everything small replicates.
_PARAM_RULES = (
    (re.compile(r"channel_mix/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"input_mapping/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"(linear1|mlp_c_fc)/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"(linear2|mlp_c_proj)/kernel$"), (MODEL_AXIS, None)),
    (re.compile(r"embed_timestep/fc[12]/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"(speaker_mu|speaker_logvar)/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"in_proj_weight$"), (MODEL_AXIS, None)),
    (re.compile(r"token_embedding$"), (None, MODEL_AXIS)),
    (re.compile(r"speaker_embedding/embedding$"), (None, MODEL_AXIS)),
)

Spec = Tuple[Optional[str], ...]


def _flax_layout(model: torch.nn.Module, name: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """(Flax path, perm) of ``model``'s parameter ``name``: torch dim i is
    Flax dim perm[i] (``utils/convert.py``)."""
    *parents, leaf = name.split(".")
    flax_leaf, perm = convert.jax_leaf_layout(model.get_submodule(".".join(parents)), leaf, ndim)
    return "/".join(parents + [flax_leaf]), perm


def _flax_spec(path: str, ndim: int) -> List[Optional[str]]:
    """The rule's spec of a Flax leaf, padded with None to its rank."""
    spec: List[Optional[str]] = []
    for rx, rule in _PARAM_RULES:
        if rx.search(path):
            spec = list(rule)
            break
    return (spec + [None] * ndim)[:ndim]


def param_spec(model: torch.nn.Module, name: str) -> Spec:
    """The rules' spec of ``model``'s parameter ``name``, in torch's dims:
    the JAX ``param_spec`` of its Flax path carried through the transpose."""
    ndim = model.get_parameter(name).ndim
    path, perm = _flax_layout(model, name, ndim)
    flax = _flax_spec(path, ndim)
    return tuple(flax[perm[i]] for i in range(ndim))


def _divides(spec: Sequence[Optional[str]], shape: Sequence[int], k: int) -> bool:
    """Whether the model axis of size k divides every dim ``spec`` puts on it
    (``mesh.py:136-155``: else the whole leaf replicates)."""
    return all(shape[i] % k == 0 for i, a in enumerate(spec) if a == MODEL_AXIS)


def param_shardings(model: torch.nn.Module, mesh) -> Dict[str, Spec]:
    """{name: spec} under the rules; every leaf replicates on a mesh without
    a model axis (a pipeline mesh of one model column), and so does a leaf
    with a ruled dim that the model axis does not divide."""
    k = mesh.shape.get(MODEL_AXIS, 0)
    out = {}
    for name, p in model.named_parameters():
        spec = param_spec(model, name) if k else (None,) * p.ndim
        out[name] = spec if _divides(spec, p.shape, k or 1) else (None,) * p.ndim
    return out


def shard_params(model: torch.nn.Module, mesh) -> List[torch.nn.Module]:
    """Place ``model`` on the mesh under the rules: one replica a data row.
    With one device a row (a model axis of 1, or a pipeline mesh, whose
    model axis splits only the channel mix inside its stages) these are
    :func:`replicate_module`'s. Otherwise each is a tensor-parallel replica
    (``tensor_parallel.tp_replica``) over the row's model group: every
    ruled parameter held as k slices, slice j on the group's j-th device,
    the rest whole on its first; ``model`` itself stays whole, on the first
    row's first device."""
    if len(mesh.model_group(0)) == 1:
        return replicate_module(model, mesh)
    dims = {name: spec.index(MODEL_AXIS) for name, spec in param_shardings(model, mesh).items()
            if MODEL_AXIS in spec}
    model.to(mesh.devices[0])
    return [tp_replica(model, mesh.model_group(i), dims) for i in range(mesh.size)]


# --- FSDP (ZeRO-style fully sharded data parallelism, ``mesh.py:115-222``) ---
#
# Every large leaf is also split over the data axis, so that params, Adam
# moments and the EMA hold 1/N of it on each shard; a step all-gathers the
# weights before its forward and keeps only its slice of the averaged
# gradient.

#: Leaves smaller than this stay replicated: gathering a tiny vector a step
#: costs more than holding N copies.
FSDP_MIN_SIZE = 2**13


def fsdp_param_shardings(model: torch.nn.Module, mesh,
                         min_size: int = FSDP_MIN_SIZE) -> Dict[str, Spec]:
    """{name: spec}: the rules (a ruled dim the model axis does not divide
    replicates the leaf), plus the data axis on the largest still free dim
    that it divides of every leaf of at least ``min_size`` elements. The
    dim is chosen in the Flax layout, as the JAX function chooses it (its
    ties go to the first Flax dim), then carried to torch's."""
    data_size = mesh.shape[DATA_AXIS]
    model_size = mesh.shape.get(MODEL_AXIS, 1)
    out = {}
    for name, p in model.named_parameters():
        path, perm = _flax_layout(model, name, p.ndim)
        spec = _flax_spec(path, p.ndim)
        shape = [p.shape[perm.index(j)] for j in range(p.ndim)]  # the Flax shape
        if MODEL_AXIS not in mesh.shape:  # drop the rule, keep the leaf for FSDP
            spec = [None if a == MODEL_AXIS else a for a in spec]
        if not _divides(spec, shape, model_size):
            spec = [None] * p.ndim
        if p.numel() >= min_size and data_size > 1:
            free = [j for j in range(p.ndim)
                    if spec[j] is None and shape[j] % data_size == 0 and shape[j] >= data_size]
            if free:
                spec[max(free, key=lambda j: shape[j])] = DATA_AXIS
        out[name] = tuple(spec[perm[i]] for i in range(p.ndim))
    return out


def _cut(x: torch.Tensor, dim: int, g: int, n: int, device) -> torch.Tensor:
    """Global shard g's slice (of n) of ``x`` along ``dim``: a contiguous
    copy on ``device``."""
    rows = x.shape[dim] // n
    return x.narrow(dim, g * rows, rows).contiguous().to(device, copy=True)


class FSDPShards:
    """A train state sliced over the data axis, and one replica a local
    shard to compute with.

    The replicas are :func:`shard_params`'s: on a model axis above 1, each
    a tensor-parallel replica whose parameter ``name.j`` is slice j of a
    ruled leaf, on the row's j-th device. The state of a shard is keyed by
    its replica's parameter names. ``states[i]`` is local shard i's
    ``TrainState``: for a leaf sliced over the data axis (``dims``: its
    split dim) its params, ``mu``, ``nu`` and EMA hold the shard's slice
    (of the model slice, on a model axis above 1: each device holds its
    slice of every leaf sharded on either axis); for the rest they are
    full, the params being the replica's own tensors. Between steps a
    replica's data-sharded parameters hold no storage; :meth:`gather` fills
    them with the weights whole over the data axis, :meth:`free` empties
    them again."""

    def __init__(self, model: torch.nn.Module, mesh, min_size: int = FSDP_MIN_SIZE):
        self.mesh = mesh
        specs = fsdp_param_shardings(model, mesh, min_size)
        self.names = [name for name, _ in model.named_parameters()]
        self.replicas = shard_params(model, mesh)
        self.layout = tp_layout(self.replicas[0])
        self.dims = {k: specs[name].index(DATA_AXIS) for k, (name, *_) in self.layout.items()
                     if DATA_AXIS in specs[name]}
        self.shapes = {k: p.shape for k, p in self.replicas[0].named_parameters()}
        self.states: List[Any] = [None] * mesh.size

    def _devices(self, i: int) -> Dict[str, torch.device]:
        return {k: p.device for k, p in self.replicas[i].named_parameters()}

    def load(self, state) -> List[Any]:
        """Slice a full ``state`` (one TrainState over the model's
        parameter names, any device) over the shards; the replicas' sharded
        parameters are then freed."""
        n = self.mesh.shape[DATA_AXIS]
        for i, r in enumerate(self.replicas):
            g, devs = self.mesh.shard_index(i), self._devices(i)

            def part(full: Dict[str, torch.Tensor], own=None):
                out = {}
                for k, v in split_values(full, self.layout, devs).items():
                    if k in self.dims:
                        out[k] = _cut(v, self.dims[k], g, n, devs[k])
                    elif own is not None:
                        own[k].copy_(v)
                        out[k] = own[k]
                    else:
                        out[k] = v
                return out

            with torch.no_grad():
                params = part(state.params, dict(r.named_parameters()))
            opt = dataclasses.replace(state.opt_state, mu=part(state.opt_state.mu),
                                      nu=part(state.opt_state.nu))
            ema = None if state.ema_params is None else part(state.ema_params)
            self.states[i] = dataclasses.replace(state, params=params, opt_state=opt,
                                                 ema_params=ema)
        for i in range(self.mesh.size):
            self.free(i)
        return list(self.states)

    def _gather(self, slices: Sequence[Dict[str, torch.Tensor]],
                devices: Dict[str, torch.device]) -> Dict[str, torch.Tensor]:
        """The tensors of the sharded leaves whole over the data axis, each
        on ``devices[key]``, from each local shard's slices: each slice
        copied to its global place in one zero buffer a device, then
        (across processes) an exact all-reduce of each buffer."""
        keys = list(self.dims)
        if not keys:
            return {}
        n, full = self.mesh.shape[DATA_AXIS], {}
        for dev in dict.fromkeys(devices[k] for k in keys):
            on = [k for k in keys if devices[k] == dev]
            sizes = [int(np.prod(self.shapes[k])) for k in on]
            flat = torch.zeros(sum(sizes), dtype=slices[0][on[0]].dtype, device=dev)
            full.update({k: t.view(self.shapes[k]) for k, t in zip(on, flat.split(sizes))})
            for i, part in enumerate(slices):
                g = self.mesh.shard_index(i)
                for k in on:
                    d = self.dims[k]
                    rows = self.shapes[k][d] // n
                    full[k].narrow(d, g * rows, rows).copy_(part[k])
            if self.mesh.distributed:
                _exact_all_reduce(flat)
        return full

    def gather(self, i: int) -> None:
        """Replica i's sharded parameters filled with the weights whole over
        the data axis."""
        full = self._gather([s.params for s in self.states], self._devices(i))
        for k, p in self.replicas[i].named_parameters():
            if k in full:
                p.data = full[k]

    def free(self, i: int) -> None:
        """Replica i's sharded parameters emptied (no storage)."""
        for k, p in self.replicas[i].named_parameters():
            if k in self.dims:
                p.data = p.data.new_empty(0)

    def slice_grads(self, grads: Sequence[torch.Tensor], i: int) -> List[torch.Tensor]:
        """Local shard i's part of the averaged gradients (in the order of
        its replica's parameters): its slice of a sharded leaf, all of the
        rest, each on its parameter's device."""
        n, g, devs = self.mesh.shape[DATA_AXIS], self.mesh.shard_index(i), self._devices(i)
        return [_cut(x, self.dims[k], g, n, devs[k]) if k in self.dims else x.to(devs[k])
                for k, x in zip(self.shapes, grads)]

    def gathered_state(self):
        """One full copy of the train state over the model's parameter
        names, on shard 0's device: what a checkpoint holds."""
        s0, dev0 = self.states[0], self.mesh.devices[0]

        def whole(parts):
            full = self._gather(parts, {k: dev0 for k in self.shapes})
            merged = merge_values({k: full.get(k, v) for k, v in parts[0].items()},
                                  self.layout, dev0)
            return {name: merged[name] for name in self.names}

        opt = dataclasses.replace(s0.opt_state, mu=whole([s.opt_state.mu for s in self.states]),
                                  nu=whole([s.opt_state.nu for s in self.states]))
        ema = None if s0.ema_params is None else whole([s.ema_params for s in self.states])
        return dataclasses.replace(s0, params=whole([s.params for s in self.states]),
                                   opt_state=opt, ema_params=ema)


def fsdp_shard_params(model: torch.nn.Module, state, mesh,
                      min_size: int = FSDP_MIN_SIZE) -> FSDPShards:
    """``state`` (a full TrainState over ``model``'s parameters) sliced over
    the mesh's data axis: one replica a local shard (:func:`shard_params`'s;
    on a model axis of 1, shard 0 is ``model``), and each shard's state
    holding its slice of every leaf that :func:`fsdp_param_shardings`
    shards (ZeRO-3 memory); the rest replicated."""
    shards = FSDPShards(model, mesh, min_size)
    shards.load(state)
    return shards


def _layout(state) -> Dict[str, Tuple]:
    """(shape, device) of every tensor leaf of a TrainState."""
    out = {}

    def walk(prefix, tree):
        if isinstance(tree, torch.Tensor):
            out[prefix] = (tuple(tree.shape), tree.device)
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            for f in dataclasses.fields(tree):
                walk(f"{prefix}/{f.name}", getattr(tree, f.name))

    walk("", state)
    return out


def preserve_state_shardings(step_fn, state):
    """Wrap a ``(state, batch, ...) -> (state, metrics)`` step so that the
    state it returns must have the placement of ``state``: every tensor leaf
    the same (slice) shape on the same device, else it raises. This pins an
    FSDP state's slices across steps (and the status quo of a replicated
    one). The wrapper carries the step's attributes (``replicas``,
    ``states``, ...)."""
    layout = _layout(state)

    def wrapped(st, batch, *args, **kw):
        new_state, metrics = step_fn(st, batch, *args, **kw)
        got = _layout(new_state)
        if got != layout:
            moved = sorted(k for k in set(got) | set(layout) if got.get(k) != layout.get(k))
            raise RuntimeError(f"the step changed the state's placement: {moved[:5]}")
        return new_state, metrics

    wrapped.__dict__.update(getattr(step_fn, "__dict__", {}))
    return wrapped
