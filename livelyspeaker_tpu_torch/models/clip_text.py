"""CLIP ViT-B/32 text tower, in PyTorch.

Port of ``livelyspeaker_tpu/models/clip_text.py``: the text transformer only
(vocab 49,408, context 77, width 512, 12 layers, 8 heads, causal mask,
QuickGELU, ``ln_final`` and the text projection), in f32. The released
OpenAI state_dict maps onto it through
``utils.convert.clip_text_state_dict_from_openai``. Names follow the Flax
tree (``token_embedding``, ``block_0.attn_in_proj_weight``, ...).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .initializers import dense_default_
from .products import in_projection, lookup

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "quick_gelu"]


class CLIPTextConfig:
    """Hyperparameters of the text tower (defaults: ViT-B/32's)."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _normal(shape, std: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(shape, generator=generator))


class _ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width, self.heads = width, heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn_in_proj_weight = _normal((3 * width, width), 0.02, generator)
        self.attn_in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.attn_out_proj = dense_default_(nn.Linear(width, width), generator)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_c_fc = dense_default_(nn.Linear(width, 4 * width), generator)
        self.mlp_c_proj = dense_default_(nn.Linear(4 * width, width), generator)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        d, h = self.width, self.heads
        hd = d // h
        y = self.ln_1(x)
        q, k, v = in_projection(y, y, y, self.attn_in_proj_weight, self.attn_in_proj_bias, d)
        bsz, length, _ = y.shape
        sh = lambda a: a.reshape(bsz, length, h, hd).transpose(1, 2)
        q, k, v = sh(q), sh(k), sh(v)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        attn = torch.softmax(logits + attn_mask[None, None], dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        x = x + self.attn_out_proj(o.transpose(1, 2).reshape(bsz, length, d))
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    """tokens [B, L] (integer ids, L <= context_length) -> text features
    [B, embed_dim], read at each sequence's EOT token (its largest id)."""

    def __init__(self, cfg: Optional[CLIPTextConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg = cfg or CLIPTextConfig()
        self.token_embedding = _normal((cfg.vocab_size, cfg.width), 0.02, generator)
        self.positional_embedding = _normal((cfg.context_length, cfg.width), 0.01,
                                            generator)
        for i in range(cfg.layers):
            self.add_module(f"block_{i}",
                            _ResidualAttentionBlock(cfg.width, cfg.heads, generator))
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = _normal((cfg.width, cfg.embed_dim), cfg.width ** -0.5,
                                       generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        n = tokens.shape[1]
        x = lookup(self.token_embedding, tokens) + self.positional_embedding[None, :n]
        causal = torch.triu(
            torch.full((n, n), float("-inf"), dtype=x.dtype, device=x.device), diagonal=1)
        for i in range(self.cfg.layers):
            x = getattr(self, f"block_{i}")(x, causal)
        x = self.ln_final(x)
        eot = torch.argmax(tokens, dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection
