"""Post-LN transformer encoder and decoder layers, in PyTorch.

Port of ``livelyspeaker_tpu/models/transformer.py``, the SAG's towers: the
torch 1.7 ``nn.TransformerEncoder/Decoder`` computation (post-norm, packed
QKV projection) in the [B, S, D] layout. The attention is written out rather
than taken from ``nn.MultiheadAttention``: the logits are scaled after
``q k^T``, a key padding mask is True for the keys to keep and fills the
others with the dtype's most negative value (not -inf), and ``gelu`` is the
tanh approximation, as in the JAX modules. Module and parameter names follow
the Flax tree (``self_attn.in_proj_weight``, ``norm1``, ``layer_0``), so
``utils/convert.py`` maps JAX params one to one.

Dropout is ``nn.Dropout`` and is inactive in ``eval()``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .initializers import dense_default_, xavier_uniform_
from .mlp_backbone import get_activation
from .products import in_projection

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerDecoderLayer", "TransformerEncoder", "TransformerDecoder"]


class MultiHeadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s computation with the packed
    ``in_proj_weight`` [3D, D] and the JAX module's masking."""

    def __init__(self, d_model: int, num_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        xavier_uniform_(self.in_proj_weight, 1.0, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = dense_default_(nn.Linear(d_model, d_model), generator)

    def forward(
        self,
        query: torch.Tensor,  # [B, Lq, D]
        key: torch.Tensor,  # [B, Lk, D]
        value: torch.Tensor,  # [B, Lk, D]
        *,
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Lk] True = valid
        attn_mask: Optional[torch.Tensor] = None,  # [Lq, Lk] additive
    ) -> torch.Tensor:
        d, h = self.d_model, self.num_heads
        hd = d // h
        q, k, v = in_projection(query, key, value, self.in_proj_weight, self.in_proj_bias, d)

        def split_heads(x):
            bsz, length, _ = x.shape
            return x.reshape(bsz, length, h, hd).transpose(1, 2)  # [B, H, L, hd]

        q, k, v = map(split_heads, (q, k, v))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        if attn_mask is not None:
            logits = logits + attn_mask[None, None]
        if key_padding_mask is not None:
            logits = logits.masked_fill(~key_padding_mask.bool()[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        bsz, _, lq, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(bsz, lq, d))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch 1.7 ``nn.TransformerEncoderLayer``)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(activation)
        self.self_attn = MultiHeadAttention(d_model, num_heads, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = dense_default_(nn.Linear(d_model, dim_feedforward), generator)
        self.linear2 = dense_default_(nn.Linear(dim_feedforward, d_model), generator)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, src: torch.Tensor, *,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.self_attn(src, src, src, key_padding_mask=key_padding_mask)
        src = self.norm1(src + self.dropout(h))
        h = self.dropout(self.act(self.linear1(src)))
        h = self.dropout(self.linear2(h))
        return self.norm2(src + h)


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer (torch 1.7 ``nn.TransformerDecoderLayer``)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(activation)
        self.self_attn = MultiHeadAttention(d_model, num_heads, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, generator)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = dense_default_(nn.Linear(d_model, dim_feedforward), generator)
        self.linear2 = dense_default_(nn.Linear(dim_feedforward, d_model), generator)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, *,
                tgt_key_padding_mask: Optional[torch.Tensor] = None,
                memory_key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.self_attn(tgt, tgt, tgt, key_padding_mask=tgt_key_padding_mask)
        tgt = self.norm1(tgt + self.dropout(h))
        h = self.multihead_attn(tgt, memory, memory,
                                key_padding_mask=memory_key_padding_mask)
        tgt = self.norm2(tgt + self.dropout(h))
        h = self.dropout(self.act(self.linear1(tgt)))
        h = self.dropout(self.linear2(h))
        return self.norm3(tgt + h)


class TransformerEncoder(nn.Module):
    """``num_layers`` encoder layers, ``layer_0`` first."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 activation: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, num_heads, dim_feedforward, dropout, activation, generator))

    def forward(self, src: torch.Tensor, *,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, key_padding_mask=key_padding_mask)
        return src


class TransformerDecoder(nn.Module):
    """``num_layers`` decoder layers, ``layer_0`` first."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 activation: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                d_model, num_heads, dim_feedforward, dropout, activation, generator))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, *,
                tgt_key_padding_mask: Optional[torch.Tensor] = None,
                memory_key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer_{i}")(
                tgt, memory, tgt_key_padding_mask=tgt_key_padding_mask,
                memory_key_padding_mask=memory_key_padding_mask)
        return tgt
