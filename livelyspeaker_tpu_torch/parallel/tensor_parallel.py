"""Tensor-parallel products over a model group: what the parameter rules
imply for the compute, in Megatron's terms.

The JAX package has no module for this: on a mesh with a ``model`` axis
above 1, GSPMD splits every weight that ``_PARAM_RULES`` names and inserts
the collectives. Here one process drives the devices of a data row's model
group (``Mesh.model_group``), in turns on one card, and a weight that the
rules split is held as k slices, slice j on the group's j-th device
(:class:`Split`; :class:`TPWeight` when the slices are a module's
parameters). Three products use them; the activations, their inputs and
outputs, live on the group's first device:

- *column-parallel* (a weight split on its output dim: the channel mix,
  the input mapping, the timestep MLP, the speaker projections,
  ``linear1``, ``mlp_c_fc``, the packed ``in_proj_weight``): device j
  computes its slice of ``x @ W^T`` (plus its bias slice, where the bias
  is split too), and a tiled all-gather in rank order re-forms the full
  width on the first device, where a whole bias is added;
- *row-parallel* (split on its input dim: ``linear2``, ``mlp_c_proj``):
  device j multiplies its slice of the input's last dim by its columns of
  W; the partial products are summed on the first device in rank order,
  then the bias is added once;
- *embedding* (a table split on its embedding dim: ``token_embedding``,
  ``speaker_embedding``): device j looks up its columns, and the slices
  are gathered in rank order.

Every move is a ``.to()``, so autograd carries each gradient back to its
slice's device and the backward needs nothing more. On one device (a
group that names a device k times) the same code runs, in turns.

:func:`tp_replica` builds the copy of a module that a data row computes
with: a ruled ``nn.Linear`` or ``nn.Embedding`` becomes a
:class:`ParallelLinear` / :class:`ParallelEmbedding`, any other ruled
parameter a :class:`TPWeight` in its place; the models route their
functional uses through ``models/products.py``. Slice j of a parameter
``name`` is the replica's parameter ``name.j``; :func:`tp_layout`,
:func:`split_values` and :func:`merge_values` map a replica's parameters
to the model's and back.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Split", "TPWeight", "ParallelLinear", "ParallelEmbedding", "column_parallel",
           "row_parallel", "embedding_parallel", "tp_replica", "tp_layout", "split_values",
           "merge_values"]


def column_parallel(x: torch.Tensor, parts: Sequence[torch.Tensor],
                    bias: Union[None, torch.Tensor, "Split"] = None) -> torch.Tensor:
    """``x @ W^T + b`` for W [out, in] split on ``out`` (``parts[j]``
    [out / k, in] on device j): each device computes its slice, then a
    tiled all-gather in rank order on ``x``'s device. A split ``bias`` is
    added on each device, a whole one after the gather."""
    b_parts = bias.parts if isinstance(bias, Split) else [None] * len(parts)
    y = torch.cat([F.linear(x.to(w.device), w, b).to(x.device) for w, b in zip(parts, b_parts)],
                  dim=-1)
    return y + bias if isinstance(bias, torch.Tensor) else y


def row_parallel(x: torch.Tensor, parts: Sequence[torch.Tensor],
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W^T + b`` for W [out, in] split on ``in`` (``parts[j]`` [out,
    in / k] on device j): device j multiplies its slice of ``x``'s last dim,
    the partial products are summed on ``x``'s device in rank order, then
    the bias is added once."""
    xs = x.split([w.shape[1] for w in parts], dim=-1)
    y = None
    for xj, w in zip(xs, parts):
        part = F.linear(xj.to(w.device), w).to(x.device)
        y = part if y is None else y + part
    return y if bias is None else y + bias


def embedding_parallel(ids: torch.Tensor, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``table[ids]`` for a table [V, E] split on ``E``: each device looks
    up its columns, gathered in rank order on ``ids``' device."""
    return torch.cat([F.embedding(ids.to(t.device), t).to(ids.device) for t in parts], dim=-1)


class Split:
    """A tensor held as k equal slices along ``dim``, ``parts[j]`` on the
    j-th device of a model group. As a [out, in] weight, ``dim`` 0 makes
    its product column-parallel and 1 row-parallel; as an embedding table,
    ``dim`` must be 1."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int):
        self.parts, self.dim = list(parts), dim

    def linear(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        if self.dim == 0:
            return column_parallel(x, self.parts, bias)
        if isinstance(bias, Split):
            raise ValueError("a row-parallel product takes a whole bias")
        return row_parallel(x, self.parts, bias)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        if self.dim != 1:
            raise ValueError(f"an embedding table is split on its embedding dim, not {self.dim}")
        return embedding_parallel(ids, self.parts)


class TPWeight(nn.Module):
    """A module's parameter held in slices: its parameters ``0`` .. ``k-1``
    are the slices along ``dim``, each on its device. It computes as the
    :class:`Split` of its current parameters (also under
    ``torch.func.functional_call``)."""

    def __init__(self, full: torch.Tensor, dim: int, devices: Sequence[torch.device]):
        super().__init__()
        self.dim = dim
        for j, (part, dev) in enumerate(zip(full.detach().chunk(len(devices), dim), devices)):
            self.register_parameter(str(j), nn.Parameter(part.to(dev, copy=True)))

    def split(self) -> Split:
        return Split(list(self._parameters.values()), self.dim)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self._parameters.values())).dtype

    def linear(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        return self.split().linear(x, bias)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return self.split().lookup(ids)


class ParallelLinear(nn.Module):
    """An ``nn.Linear`` whose weight is a :class:`TPWeight` (the bias stays
    whole on the group's first device)."""

    def __init__(self, weight: TPWeight, bias: Optional[nn.Parameter]):
        super().__init__()
        self.weight, self.bias = weight, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight.linear(x, self.bias)


class ParallelEmbedding(nn.Module):
    """An ``nn.Embedding`` whose table is a :class:`TPWeight` split on its
    embedding dim."""

    def __init__(self, weight: TPWeight):
        super().__init__()
        self.weight = weight

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight.lookup(ids)


def tp_replica(module: nn.Module, devices: Sequence[torch.device],
               dims: Mapping[str, int]) -> nn.Module:
    """A deep copy of ``module`` on ``devices[0]`` in which each parameter
    named in ``dims`` is held as ``len(devices)`` slices along its dim,
    slice j on ``devices[j]`` (``module`` itself is left as it is)."""
    replica = copy.deepcopy(module).to(devices[0])
    for name, dim in dims.items():
        parent, _, leaf = name.rpartition(".")
        owner = replica.get_submodule(parent)
        weight = TPWeight(owner._parameters[leaf], dim, devices)
        if leaf == "weight" and type(owner) in (nn.Linear, nn.Embedding):
            grand, _, attr = parent.rpartition(".")
            new = (ParallelLinear(weight, owner.bias) if isinstance(owner, nn.Linear)
                   else ParallelEmbedding(weight))
            setattr(replica.get_submodule(grand), attr, new)
        else:
            del owner._parameters[leaf]
            setattr(owner, leaf, weight)
    return replica


# {replica parameter name: (model parameter name, split dim or None, slice index, slices)}
Layout = Dict[str, Tuple[str, Optional[int], int, int]]


def tp_layout(replica: nn.Module) -> Layout:
    """Where each parameter of a replica comes from in the model: a slice
    ``name.j`` of a :class:`TPWeight` is slice j (of k, along its dim) of
    the model's ``name``; any other parameter is the model's own."""
    out = {}
    for rname, _ in replica.named_parameters():
        parent, _, last = rname.rpartition(".")
        owner = replica.get_submodule(parent) if parent else replica
        if isinstance(owner, TPWeight):
            out[rname] = (parent, owner.dim, int(last), len(owner._parameters))
        else:
            out[rname] = (rname, None, 0, 1)
    return out


def split_values(full: Mapping[str, torch.Tensor], layout: Layout,
                 devices: Mapping[str, torch.device]) -> Dict[str, torch.Tensor]:
    """Values keyed by the model's parameter names, cut to a replica's
    parameters: {replica name: its slice, a contiguous copy on
    ``devices[replica name]``}."""
    out = {}
    for rname, (name, dim, j, k) in layout.items():
        v = full[name] if dim is None else full[name].chunk(k, dim)[j]
        out[rname] = v.contiguous().to(devices[rname], copy=True)
    return out


def merge_values(parts: Mapping[str, torch.Tensor], layout: Layout,
                 device) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`split_values`: {model name: whole tensor on
    ``device``}, the slices concatenated in rank order."""
    slices: Dict[str, List[torch.Tensor]] = {}
    dims: Dict[str, Optional[int]] = {}
    for rname, (name, dim, j, _) in layout.items():
        slices.setdefault(name, []).append(parts[rname].detach().to(device))
        dims[name] = dim
    return {name: (ps[0].clone() if dims[name] is None else torch.cat(ps, dim=dims[name]))
            for name, ps in slices.items()}
