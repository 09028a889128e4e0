"""CLIP's text tower and the SAG's decoder in plain PyTorch, float32: the
benchmark's reference for the two-stage composition.

Written from the published models, independent of the port; functions
over dicts of tensors named as the port's state dicts.

- CLIP ViT-B/32's text tower (Radford et al. 2021): token and position
  embeddings, pre-LN residual blocks of causal multi-head self-attention
  and a QuickGELU MLP (4x), a final LayerNorm, the features read at each
  sequence's end-of-text token (its largest id) and projected.
- The SAG's decoder (MotionCLIP, Tevet et al. 2022): time queries from the
  seed frames and an indicator bit through a Linear plus the sinusoidal
  table, post-LN transformer decoder layers (self-attention,
  cross-attention to the latent as one memory token, a GELU
  feed-forward, tanh approximation), a Linear back to poses.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .rag import sinusoid_table

Params = Dict[str, torch.Tensor]


def _attend(q, k, v, heads, mask=None):
    b, lq, d = q.shape
    hd = d // heads
    split = lambda a: a.reshape(b, a.shape[1], heads, hd).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    logits = q @ k.transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask
    out = torch.softmax(logits, dim=-1) @ v
    return out.transpose(1, 2).reshape(b, lq, d)


def clip_text(p: Params, cfg: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, L] -> text features [B, embed_dim]."""
    tokens = tokens.long()
    n, w = tokens.shape[1], cfg["width"]
    x = p["token_embedding"][tokens] + p["positional_embedding"][:n]
    causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    for i in range(cfg["layers"]):
        b = f"block_{i}."
        y = F.layer_norm(x, (w,), p[b + "ln_1.weight"], p[b + "ln_1.bias"], 1e-5)
        q, k, v = F.linear(y, p[b + "attn_in_proj_weight"], p[b + "attn_in_proj_bias"]).chunk(3, -1)
        a = _attend(q, k, v, cfg["heads"], causal)
        x = x + F.linear(a, p[b + "attn_out_proj.weight"], p[b + "attn_out_proj.bias"])
        y = F.layer_norm(x, (w,), p[b + "ln_2.weight"], p[b + "ln_2.bias"], 1e-5)
        y = F.linear(y, p[b + "mlp_c_fc.weight"], p[b + "mlp_c_fc.bias"])
        y = y * torch.sigmoid(1.702 * y)
        x = x + F.linear(y, p[b + "mlp_c_proj.weight"], p[b + "mlp_c_proj.bias"])
    x = F.layer_norm(x, (w,), p["ln_final.weight"], p["ln_final.bias"], 1e-5)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
    return x @ p["text_projection"]


def _mha(p, pre, q_in, kv_in, heads):
    d = q_in.shape[-1]
    w, bias = p[pre + "in_proj_weight"], p[pre + "in_proj_bias"]
    q = F.linear(q_in, w[:d], bias[:d])
    k = F.linear(kv_in, w[d:2 * d], bias[d:2 * d])
    v = F.linear(kv_in, w[2 * d:], bias[2 * d:])
    return F.linear(_attend(q, k, v, heads), p[pre + "out_proj.weight"], p[pre + "out_proj.bias"])


def sag_decode(p: Params, cfg: Dict, z: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
    """The latent z [B, D] and seed frames of motion [B, J, F, T] -> motion
    [B, J, F, T]."""
    b, nj, nf, nt = motion.shape
    d = cfg["latent_dim"]
    x = motion.float().reshape(b, nj * nf, nt).transpose(1, 2)
    seed = (torch.arange(nt, device=x.device) < cfg["n_pre_poses"]).float()[None, :, None]
    h = F.linear(torch.cat([x * seed, seed.expand(b, nt, 1)], -1),
                 p["decoder.mapping.weight"], p["decoder.mapping.bias"])
    h = h + sinusoid_table(nt, d, x.device)[None]
    mem = z[:, None, :]
    ln = lambda v, name: F.layer_norm(v, (d,), p[name + ".weight"], p[name + ".bias"], 1e-5)
    for i in range(cfg["num_layers"]):
        pre = f"decoder.decoder.layer_{i}."
        h = ln(h + _mha(p, pre + "self_attn.", h, h, cfg["num_heads"]), pre + "norm1")
        h = ln(h + _mha(p, pre + "multihead_attn.", h, mem, cfg["num_heads"]), pre + "norm2")
        y = F.gelu(F.linear(h, p[pre + "linear1.weight"], p[pre + "linear1.bias"]),
                   approximate="tanh")
        h = ln(h + F.linear(y, p[pre + "linear2.weight"], p[pre + "linear2.bias"]), pre + "norm3")
    out = F.linear(h, p["decoder.final_layer.weight"], p["decoder.final_layer.bias"])
    return out.transpose(1, 2).reshape(b, nj, nf, nt)
