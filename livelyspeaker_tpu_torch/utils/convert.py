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

Trees with BatchNorm statistics, ConvTranspose or GRU weights (the gesture
autoencoder and its decoders, ``models/embedding_net.py``) need the model to
tell their layouts apart: :func:`flax_variables_to_state_dict` maps a Flax
``{"params", "batch_stats"}`` pair onto a model's state_dict and
:func:`state_dict_to_flax_variables` back, with

- ConvTranspose ``kernel`` [k, in, out] -> ConvTranspose1d ``weight``
  [in, out, k] with the tap axis flipped (Flax's ``transpose_kernel=False``
  does not flip it; torch's transposed conv does);
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  -> the port's ``BatchNorm`` ``weight``/``bias`` and buffers;
- a bidirectional ``nn.GRU`` from Flax's cells ``GRUCell_{2i}`` (layer i,
  forward) and ``GRUCell_{2i+1}`` (backward), gates r, z, n stacked: the
  input kernels and biases of ``ir``, ``iz``, ``in``, the hidden kernels of
  ``hr``, ``hz``, ``hn`` and ``bias_hh`` = [0, 0, ``hn`` bias].

The released PyTorch checkpoints map onto the port's modules by name alone
(the layouts are torch's on both sides, but for the RAG's token mix and
LayerNorm vectors): :func:`rag_state_dict_from_reference` for the RAG,
:func:`sag_state_dict_from_reference` for the SAG (MotionCLIP),
:func:`clip_text_state_dict_from_openai` for OpenAI CLIP's text tower,
:func:`moe_text_state_dict_from_hf` for a DeepSeek-V3 checkpoint such as
Moonlight-16B-A3B's (the experts stacked, the output head dropped) and
:func:`pose_embedding_state_dict_from_torch` for the FGD evaluator's pose
encoder. The JAX package's evaluator parameters carry over through
:func:`jax_params_to_state_dict`, like every other tree.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["jax_params_to_state_dict", "state_dict_to_jax_params", "random_normal_params",
           "jax_leaf_layout",
           "rag_state_dict_from_reference", "sag_state_dict_from_reference",
           "clip_text_state_dict_from_openai", "moe_text_state_dict_from_hf",
           "pose_embedding_state_dict_from_torch", "flax_variables_to_state_dict",
           "state_dict_to_flax_variables", "flatten_tree"]


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a/b': x}: the JAX package's flat npz layout."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
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
    for path, a in flatten_tree(params).items():
        *parents, leaf = path.split("/")
        name, arr = _convert_leaf(leaf, a)
        out[".".join(parents + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32)
        )
    return out


def jax_leaf_layout(module: nn.Module, name: str, ndim: int):
    """(Flax leaf name, perm) of ``module``'s parameter ``name``: the torch
    tensor is the Flax array transposed by ``perm``, so torch dim i is Flax
    dim ``perm[i]``."""
    if name == "weight":
        if isinstance(module, nn.Linear):
            return "kernel", (1, 0)
        if isinstance(module, nn.Conv1d):
            return "kernel", (2, 1, 0)
        if isinstance(module, nn.LayerNorm):
            return "scale", tuple(range(ndim))
        if isinstance(module, nn.Embedding):
            return "embedding", tuple(range(ndim))
    return name, tuple(range(ndim))


def _jax_leaf(module: nn.Module, name: str, a: np.ndarray):
    name, perm = jax_leaf_layout(module, name, a.ndim)
    return name, a.transpose(np.argsort(perm))


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


_GATES = ("r", "z", "n")
_GRU_CELL = re.compile(r"GRUCell_(\d+)$")


def _set(tree: Dict, path, value: np.ndarray) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = np.ascontiguousarray(value, dtype=np.float32)


def flax_variables_to_state_dict(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict from a Flax ``{"params", "batch_stats"}`` tree
    of numpy arrays (as ``load_params_npz`` reads the npz the JAX package's
    gesture-autoencoder script writes). ``model`` says which leaves are
    transposed convs; GRU cells go to the ``gru`` module beside them."""
    out: Dict[str, torch.Tensor] = {}
    cells: Dict[tuple, Dict[str, np.ndarray]] = {}
    for path, a in flatten_tree(variables.get("params", {})).items():
        *parents, leaf = path.split("/")
        cell = next((i for i, p in enumerate(parents) if _GRU_CELL.match(p)), None)
        if cell is not None:
            key = (tuple(parents[:cell]), int(_GRU_CELL.match(parents[cell]).group(1)))
            cells.setdefault(key, {})["/".join(parents[cell + 1:] + [leaf])] = a
            continue
        module = model.get_submodule(".".join(parents))
        if isinstance(module, nn.ConvTranspose1d) and leaf == "kernel":
            name, a = "weight", np.ascontiguousarray(a[::-1].transpose(1, 2, 0))
        else:
            name, a = _convert_leaf(leaf, a)
        out[".".join(parents + [name])] = _f32(a)
    for path, a in flatten_tree(variables.get("batch_stats", {})).items():
        out[path.replace("/", ".")] = _f32(a)
    for (parents, j), leaves in cells.items():
        gru = ".".join(list(parents) + ["gru"])
        suffix = f"l{j // 2}" + ("_reverse" if j % 2 else "")
        hidden = leaves["hn/kernel"].shape[1]
        out[f"{gru}.weight_ih_{suffix}"] = _f32(np.concatenate(
            [leaves[f"i{g}/kernel"].T for g in _GATES]))
        out[f"{gru}.weight_hh_{suffix}"] = _f32(np.concatenate(
            [leaves[f"h{g}/kernel"].T for g in _GATES]))
        out[f"{gru}.bias_ih_{suffix}"] = _f32(np.concatenate(
            [leaves[f"i{g}/bias"] for g in _GATES]))
        out[f"{gru}.bias_hh_{suffix}"] = _f32(np.concatenate(
            [np.zeros(2 * hidden, np.float32), leaves["hn/bias"]]))
    return out


def state_dict_to_flax_variables(state_dict: Mapping[str, torch.Tensor],
                                 model: nn.Module) -> Dict:
    """The Flax ``{"params", "batch_stats"}`` tree of ``model``'s state_dict;
    the inverse of :func:`flax_variables_to_state_dict`. Raises if a GRU's
    hidden r or z bias is not zero: Flax's cell has none."""
    from ..models.embedding_net import BatchNorm

    params: Dict = {}
    stats: Dict = {}
    for key, value in state_dict.items():
        *parents, leaf = key.split(".")
        module = model.get_submodule(".".join(parents))
        a = value.detach().to("cpu", torch.float32).numpy()
        if isinstance(module, BatchNorm):
            if leaf in ("mean", "var"):
                _set(stats, parents + [leaf], a)
            else:
                _set(params, parents + ["scale" if leaf == "weight" else leaf], a)
        elif isinstance(module, nn.GRU):
            kind, layer = leaf.rsplit("_l", 1)
            j = 2 * int(layer.split("_")[0]) + layer.endswith("_reverse")
            cell = parents[:-1] + [f"GRUCell_{j}"]
            side = "i" if kind.endswith("ih") else "h"
            parts = np.split(a, 3)
            if kind == "bias_hh":
                if np.any(parts[0]) or np.any(parts[1]):
                    raise ValueError(f"{key}: the r and z thirds must be 0 for Flax's GRUCell")
                _set(params, cell + ["hn", "bias"], parts[2])
                continue
            for g, part in zip(_GATES, parts):
                _set(params, cell + [side + g, "kernel" if kind.startswith("weight") else "bias"],
                     part.T if kind.startswith("weight") else part)
        elif isinstance(module, nn.ConvTranspose1d) and leaf == "weight":
            _set(params, parents + ["kernel"], a.transpose(2, 0, 1)[::-1])
        else:
            name, a = _jax_leaf(module, leaf, a)
            _set(params, parents + [name], a)
    return {"params": params, "batch_stats": stats}


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


def rag_state_dict_from_reference(sd: Mapping, num_layers: int = 8,
                                  num_emotions: int = 0) -> Dict[str, torch.Tensor]:
    """The port's ``models.rag.RAG`` state_dict from a reference RAG
    state_dict (``ckpts/TED/RAG.pt``, BEAT's RAG checkpoints: a plain
    state_dict, CLIP stripped; module tree of the reference's
    ``scripts/model/RAG.py``, ``mlp_module.py`` and ``audio_enc.py``): the
    WavEncoder convs at ``feat_extractor`` indices 0/3/6/9, the speaker (and
    with ``num_emotions``, the emotion) tables, the timestep MLP and each
    block's ``block1``/``block2`` LayerNorm (``alpha``/``beta`` [1, 1, D]),
    token mix (a Conv1d(S, S, 1), weight [S, S, 1]) and channel mix. The
    sinusoid tables are left out: the port rebuilds them."""
    names = {}
    for i, idx in enumerate((0, 3, 6, 9)):
        names.update(_with_leaves(f"audio_encoder.conv{i}",
                                  f"audio_encoder.feat_extractor.{idx}", _WB))
    for ours, theirs in (("input_mapping", "input_mapping"), ("speaker_mu", "speaker_mu"),
                         ("speaker_logvar", "speaker_logvar"),
                         ("pose_final", "output_process.poseFinal"),
                         ("backbone.embed_timestep.fc1", "backbone.embed_timestep.time_embed.0"),
                         ("backbone.embed_timestep.fc2", "backbone.embed_timestep.time_embed.2")):
        names.update(_with_leaves(ours, theirs, _WB))
    names["speaker_embedding.weight"] = "speaker_embedding.weight"
    if num_emotions:
        names["emotion_embedding.weight"] = "emotion_embedding.weight"
    for i in range(num_layers):
        ours, theirs = f"backbone.block_{i}", f"backbone.mlps.{i}"
        names.update(_with_leaves(f"{ours}.channel_mix", f"{theirs}.block2.1", _WB))
        names[f"{ours}.token_mix_bias"] = f"{theirs}.block1.1.bias"
    out = _renamed(sd, names)
    for i in range(num_layers):
        ours, theirs = f"backbone.block_{i}", f"backbone.mlps.{i}"
        out[f"{ours}.token_mix_kernel"] = _f32(sd[f"{theirs}.block1.1.weight"])[:, :, 0].clone()
        for ln, blk in (("ln1", "block1"), ("ln2", "block2")):
            out[f"{ours}.{ln}.weight"] = _f32(sd[f"{theirs}.{blk}.0.alpha"]).reshape(-1)
            out[f"{ours}.{ln}.bias"] = _f32(sd[f"{theirs}.{blk}.0.beta"]).reshape(-1)
    return out


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


_HF_EXPERT = re.compile(r"layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight$")


def moe_text_state_dict_from_hf(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``models.moe_text.MoETextEncoder`` state_dict, but for its
    adapter (the port's own), from a DeepSeek-V3 checkpoint's
    (``model.layers.{i}.self_attn.q_proj.weight``, ...): the ``model.``
    prefix dropped, each layer's experts ``mlp.experts.{e}.{gate,up,down}
    _proj.weight`` stacked in order into ``mlp.experts.{gate,up,down}_proj``
    [E, ...], ``lm_head`` left out."""
    out: Dict[str, torch.Tensor] = {}
    experts: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, value in sd.items():
        if name.startswith("lm_head."):
            continue
        name = name[len("model."):] if name.startswith("model.") else name
        m = _HF_EXPERT.match(name)
        if m:
            key = f"layers.{m[1]}.mlp.experts.{m[3]}_proj"
            experts.setdefault(key, {})[int(m[2])] = value
        else:
            out[name] = _f32(value)
    for key, by_index in experts.items():
        if sorted(by_index) != list(range(len(by_index))):
            raise ValueError(f"{key}: experts {sorted(by_index)} are not 0..{len(by_index) - 1}")
        out[key] = torch.stack([_f32(by_index[e]) for e in range(len(by_index))])
    return out


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
