"""Weight bridge between a JAX/Flax parameter tree (as numpy) and the
port's state_dict, both ways.

The port's modules carry the Flax tree's names, so the state_dict key of a
leaf is its tree path joined with dots, with the leaf renamed and re-laid
out where the two frameworks differ:

- Dense ``kernel`` [in, out]      -> Linear ``weight`` [out, in]
- Conv ``kernel`` [k, in, out]    -> Conv1d ``weight`` [out, in, k]
- LayerNorm ``scale``             -> ``weight``
- Embed ``embedding``             -> ``weight``
- everything else keeps its name and layout.

The tree is the one ``load_params_npz`` (or ``params_to_flat_numpy`` in the
JAX package) gives: nested dicts of numpy arrays.
:func:`state_dict_to_jax_params` is the inverse; it reads each leaf's module
type from the model, since a torch ``weight`` alone does not say which Flax
name it had.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["jax_params_to_state_dict", "state_dict_to_jax_params", "random_normal_params"]


def _flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a/b': x}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _convert_leaf(name: str, a: np.ndarray):
    if name == "kernel" and a.ndim == 2:
        return "weight", a.T
    if name == "kernel" and a.ndim == 3:
        return "weight", a.transpose(2, 1, 0)
    if name in ("scale", "embedding"):
        return "weight", a
    return name, a


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX ``params`` tree of numpy arrays."""
    out = {}
    for path, a in _flatten_tree(params).items():
        *parents, leaf = path.split("/")
        name, arr = _convert_leaf(leaf, a)
        out[".".join(parents + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32)
        )
    return out


def _jax_leaf(module: nn.Module, name: str, a: np.ndarray):
    if name == "weight":
        if isinstance(module, nn.Linear):
            return "kernel", a.T
        if isinstance(module, nn.Conv1d):
            return "kernel", a.transpose(2, 1, 0)
        if isinstance(module, nn.LayerNorm):
            return "scale", a
        if isinstance(module, nn.Embedding):
            return "embedding", a
    return name, a


def state_dict_to_jax_params(state_dict: Mapping[str, torch.Tensor],
                             model: nn.Module) -> Dict:
    """The JAX ``params`` tree (nested dicts of f32 numpy arrays) of a
    state_dict of ``model`` (its own, or one with its keys, such as an EMA);
    the inverse of :func:`jax_params_to_state_dict`."""
    tree: Dict = {}
    for key, value in state_dict.items():
        *parents, leaf = key.split(".")
        module = model.get_submodule(".".join(parents))
        name, arr = _jax_leaf(module, leaf, value.detach().to("cpu", torch.float32).numpy())
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def random_normal_params(tree: Mapping, rng: np.random.Generator) -> Dict:
    """The same tree with every leaf replaced by seeded normals of unit-fan-in
    scale (std 1/sqrt(fan_in) for a kernel, 1 for a vector or embedding).

    The initialisers leave the channel mix near 1e-8 and the embeddings at
    1e-6, which leaves those paths untested; random weights of this scale
    exercise every one of them."""
    def leaf(path: str, a: np.ndarray) -> np.ndarray:
        name = path.rsplit("/", 1)[-1]
        if name == "kernel" and a.ndim == 3:  # conv: fan_in = k * in
            std = 1.0 / np.sqrt(a.shape[0] * a.shape[1])
        elif a.ndim == 2 and name != "embedding":  # dense or token mix [in, out]
            std = 1.0 / np.sqrt(a.shape[0])
        elif name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        else:
            std = 0.1 if a.ndim == 1 else 1.0
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    def walk(node: Mapping, prefix: str) -> Dict:
        return {
            k: walk(v, f"{prefix}/{k}") if isinstance(v, Mapping)
            else leaf(f"{prefix}/{k}", np.asarray(v))
            for k, v in node.items()
        }

    return walk(tree, "")
