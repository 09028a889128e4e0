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

The released PyTorch checkpoints of the two-stage composition map onto the
port's modules by name alone (the layouts are torch's on both sides):
:func:`sag_state_dict_from_reference` for the SAG (MotionCLIP),
:func:`clip_text_state_dict_from_openai` for OpenAI CLIP's text tower and
:func:`pose_embedding_state_dict_from_torch` for the FGD evaluator's pose
encoder. The JAX package's evaluator parameters carry over through
:func:`jax_params_to_state_dict`, like every other tree.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["jax_params_to_state_dict", "state_dict_to_jax_params", "random_normal_params",
           "sag_state_dict_from_reference", "clip_text_state_dict_from_openai",
           "pose_embedding_state_dict_from_torch"]


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


def _f32(a) -> torch.Tensor:
    """An f32 CPU copy (OpenAI's CLIP checkpoint holds fp16 weights)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _renamed(sd: Mapping, names: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """{port key: f32 tensor of sd[reference key]} for each pair of ``names``."""
    return {ours: _f32(sd[theirs]) for ours, theirs in names.items()}


def _with_leaves(ours: str, theirs: str, leaves) -> Dict[str, str]:
    return {f"{ours}.{leaf}": f"{theirs}.{leaf}" for leaf in leaves}


_WB = ("weight", "bias")
_ATTN = ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias")


def sag_state_dict_from_reference(sd: Mapping, num_layers: int = 3) -> Dict[str, torch.Tensor]:
    """The port's ``models.sag.SAG`` state_dict from a released SAG
    (MotionCLIP) state_dict, such as ``ckpts/TED/SAG.pth``: its
    ``encoder.seqTransEncoder.layers.{i}`` and
    ``decoder.seqTransDecoder.layers.{i}`` are stock ``nn.Transformer*Layer``
    modules. Keys outside the SAG are ignored."""
    names = {"encoder.mu_query": "encoder.muQuery",
             "encoder.sigma_query": "encoder.sigmaQuery"}
    names.update(_with_leaves("encoder.skel_embedding", "encoder.skelEmbedding", _WB))
    names.update(_with_leaves("decoder.mapping", "decoder.mapping", _WB))
    names.update(_with_leaves("decoder.final_layer", "decoder.finallayer", _WB))
    for i in range(num_layers):
        for side, ref, attns, norms in (
                ("encoder", "encoder.seqTransEncoder", ("self_attn",), (1, 2)),
                ("decoder", "decoder.seqTransDecoder", ("self_attn", "multihead_attn"),
                 (1, 2, 3))):
            ours, theirs = f"{side}.{side}.layer_{i}", f"{ref}.layers.{i}"
            for a in attns:
                names.update(_with_leaves(f"{ours}.{a}", f"{theirs}.{a}", _ATTN))
            for m in ("linear1", "linear2") + tuple(f"norm{n}" for n in norms):
                names.update(_with_leaves(f"{ours}.{m}", f"{theirs}.{m}", _WB))
    return _renamed(sd, names)


def clip_text_state_dict_from_openai(sd: Mapping, layers: int = 12) -> Dict[str, torch.Tensor]:
    """The port's ``models.clip_text.CLIPTextEncoder`` state_dict from an
    OpenAI CLIP state_dict (the whole model or its text tower); the vision
    tower's keys are ignored."""
    names = {"token_embedding": "token_embedding.weight",
             "positional_embedding": "positional_embedding",
             "text_projection": "text_projection"}
    names.update(_with_leaves("ln_final", "ln_final", _WB))
    for i in range(layers):
        ours, theirs = f"block_{i}", f"transformer.resblocks.{i}"
        names[f"{ours}.attn_in_proj_weight"] = f"{theirs}.attn.in_proj_weight"
        names[f"{ours}.attn_in_proj_bias"] = f"{theirs}.attn.in_proj_bias"
        for m, ref in (("ln_1", "ln_1"), ("ln_2", "ln_2"), ("attn_out_proj", "attn.out_proj"),
                       ("mlp_c_fc", "mlp.c_fc"), ("mlp_c_proj", "mlp.c_proj")):
            names.update(_with_leaves(f"{ours}.{m}", f"{theirs}.{ref}", _WB))
    return _renamed(sd, names)


def pose_embedding_state_dict_from_torch(sd: Mapping, prefix: str = "pose_encoder."
                                         ) -> Dict[str, torch.Tensor]:
    """The port's ``models.embedding_net.PoseEmbeddingEncoder`` state_dict
    from a reference ``PoseEncoderConv`` state_dict (the TED TriModal
    autoencoder's ``gen_dict`` or BEAT's HalfEmbeddingNet): its convs are
    ``net.{0,1,2}.0`` with BatchNorms ``net.{0,1,2}.1`` and ``net.3``; its
    dense layers ``out_net.{0,3,6}`` with BatchNorms ``out_net.{1,4}``, and
    ``fc_mu``."""
    names = {}
    for ours, theirs in (("conv0", "net.0.0"), ("conv1", "net.1.0"), ("conv2", "net.2.0"),
                         ("conv3", "net.3"), ("fc0", "out_net.0"), ("fc1", "out_net.3"),
                         ("fc2", "out_net.6"), ("fc_mu", "fc_mu")):
        names.update(_with_leaves(ours, prefix + theirs, _WB))
    for ours, theirs in (("conv0", "net.0.1"), ("conv1", "net.1.1"), ("conv2", "net.2.1"),
                         ("fc0", "out_net.1"), ("fc1", "out_net.4")):
        for leaf, ref in (("mean", "running_mean"), ("var", "running_var"),
                          ("scale", "weight"), ("bias", "bias")):
            names[f"{ours}_bn_{leaf}"] = f"{prefix}{theirs}.{ref}"
    return _renamed(sd, names)
