"""A language model's decoder stack as the composition's text tower:
Moonlight-16B-A3B, DeepSeek-V3's layer, in PyTorch.

Token ids [B, L] (right-padded) and each sentence's length [B] -> features
[B, out_dim] for the SAG. The layer is that of DeepSeek-V3's modelling code,
which Moonlight's checkpoint (``model_type`` ``deepseek_v3``) uses; x is
[tokens, hidden]:

- ``rms(x, w) = w * x * rsqrt(mean(x^2) + eps)`` in f32; a layer is
  ``h = x + attn(rms(x))``, then ``h + ffn(rms(h))``; a final norm after
  the last layer.
- Multi-head latent attention with no query compression: ``q_proj`` gives
  each head ``qk_nope_head_dim + qk_rope_head_dim`` dims; the compressed
  key-value path ``kv_a_proj_with_mqa`` gives a latent ``c``
  (``kv_lora_rank``) and one rotary key ``k_pe`` for all heads;
  ``kv_b_proj(rms(c))`` gives each head's ``k_nope`` and ``v``. RoPE turns
  each pair (x_2i, x_2i+1) of ``q_pe`` and ``k_pe`` by position *
  ``rope_theta^(-2i/qk_rope_head_dim)`` (the released code de-interleaves
  the pairs first; the logits are the same). Causal softmax of
  ``[q_nope, q_pe] . [k_nope, k_pe] / sqrt(192)`` in f32, then ``o_proj``.
  No biases.
- Layers below ``first_k_dense_replace`` end in a dense SwiGLU
  (``intermediate_size``). The others route each token: ``s =
  sigmoid(y W_g^T)`` over ``n_routed_experts``, the top
  ``num_experts_per_tok`` of ``s + e_score_correction_bias`` chosen, each
  weighted ``s / (sum of the chosen s + 1e-20) * routed_scaling_factor``;
  ``out = sum_k w_k expert_k(y) + shared(y)``, every expert a SwiGLU of
  ``moe_intermediate_size``, ``shared`` one of ``n_shared_experts`` times
  that. No token is dropped and there is no capacity limit.

Departures from the released model: the output head is not held; each
sentence's feature is its final-norm state at position ``length - 1`` (the
causal mask keeps pad positions from reaching it), through an adapter
``Linear(hidden, out_dim)`` with a bias.

Only the real tokens are computed: the host knows the lengths, so it lays
out where they lie once (one copy, no wait on the card) and every layer
works on the packed [tokens, hidden] rows; attention alone scatters them
back into [B, L] for its products. A routed layer sorts its (token,
expert) pairs by expert, reads the experts' sizes back to the host (the
one wait a layer) and runs each expert's products on its slice of the
rows, from stacked expert weights ([E, width, hidden]) used in place.

Spans (``utils/profiling.annotate``): ``lm.attn`` (the norm and MLA),
``lm.route`` (the norm, the router, the sort and gather for dispatch),
``lm.ffn`` (layer 0's SwiGLU; the routed experts' products and weighted
combine, the shared experts). ``counters()`` gives the routed (token,
expert) pairs by layer and expert, added on the card at every call.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate, register_counters

__all__ = ["MoETextConfig", "MoETextEncoder"]


@dataclasses.dataclass
class MoETextConfig:
    """Hyperparameters, under the keys of a DeepSeek-V3 ``config.json``
    (defaults: Moonlight-16B-A3B's), and the adapter's width."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    out_dim: int = 512

    # settings of config.json that this tower computes in one way only
    FIXED = {"model_type": "deepseek_v3", "scoring_func": "sigmoid", "topk_method": "noaux_tc",
             "q_lora_rank": None, "norm_topk_prob": True, "hidden_act": "silu",
             "attention_bias": False, "moe_layer_freq": 1, "rope_scaling": None}

    @classmethod
    def from_hf(cls, cfg: Mapping, **kw) -> "MoETextConfig":
        """The fields of a DeepSeek-V3 ``config.json``; raises where one of
        its other settings is not the one this tower computes."""
        for k, v in cls.FIXED.items():
            if cfg.get(k, v) != v:
                raise ValueError(f"{k}={cfg[k]!r}: MoETextEncoder computes {k}={v!r} only")
        if cfg.get("topk_group", 1) != cfg.get("n_group", 1):
            raise ValueError("group-limited routing (topk_group < n_group) is not computed")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in names}, **kw)

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_inv_freq(dim: int, theta: float) -> torch.Tensor:
    """RoPE's frequencies, on the host in f32 as the released code makes
    them."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device="cpu") / dim))


class _RMSNorm(nn.Module):
    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False)


class _SwiGLU(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj, self.up_proj = _linear(d, width), _linear(d, width)
        self.down_proj = _linear(width, d)

    def forward(self, y):
        return self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))


class _Packing:
    """Where the real tokens of a right-padded [B, L] batch lie, laid out on
    the host from the lengths and sent to the card in one copy: each real
    token's row in the [B * L] layout (``flat``), its position, its id,
    and each sentence's last token among the packed rows (``last``)."""

    def __init__(self, ids: torch.Tensor, lengths: torch.Tensor, device):
        b, n = ids.shape
        pos = torch.arange(n)
        real = pos[None, :] < lengths[:, None]
        flat = real.reshape(-1).nonzero().squeeze(1)
        idx = torch.cat([flat, pos.expand(b, n)[real], lengths.cumsum(0) - 1,
                         ids.reshape(-1).long()[flat]])
        if device.type == "cuda":
            idx = idx.pin_memory().to(device, non_blocking=True)
        else:
            idx = idx.to(device)
        t = flat.numel()
        self.b, self.n = b, n
        self.flat, self.positions = idx[:t], idx[t:2 * t]
        self.last, self.ids = idx[2 * t:2 * t + b], idx[2 * t + b:]

    def pad(self, t: torch.Tensor) -> torch.Tensor:
        """Packed rows [T, ...] -> [B, L, ...], zeros at the pad positions."""
        out = t.new_zeros((self.b * self.n,) + t.shape[1:])
        return out.index_copy_(0, self.flat, t).view((self.b, self.n) + t.shape[1:])

    def unpad(self, t: torch.Tensor) -> torch.Tensor:
        """[B, L, ...] -> the packed rows [T, ...]."""
        return t.reshape((self.b * self.n,) + t.shape[2:]).index_select(0, self.flat)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Turn each pair (x_2i, x_2i+1) of the last axis by its angle."""
    a, b = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((a * cos - b * sin, b * cos + a * sin), -1).flatten(-2)


class _MLA(nn.Module):
    """Multi-head latent attention with no query compression."""

    def __init__(self, cfg: MoETextConfig):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.q_proj = _linear(d, h * qk)
        self.kv_a_proj_with_mqa = _linear(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = _RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = _linear(h * cfg.v_head_dim, d)
        self.scale = qk ** -0.5

    def forward(self, y, pack: _Packing, cos, sin, causal):
        c, t = self.cfg, y.shape[0]
        h, nope, rope = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q = self.q_proj(y).view(t, h, nope + rope)
        lat, k_pe = self.kv_a_proj_with_mqa(y).split([c.kv_lora_rank, rope], -1)
        k_nope, v = self.kv_b_proj(self.kv_a_layernorm(lat)).view(
            t, h, nope + c.v_head_dim).split([nope, c.v_head_dim], -1)
        q = torch.cat([q[..., :nope], _rotate(q[..., nope:], cos, sin)], -1)
        k_pe = _rotate(k_pe[:, None], cos, sin).expand(t, h, rope)
        heads = lambda a: pack.pad(a).transpose(1, 2)  # [B, H, L, dim]
        qb, kb, vb = heads(q), heads(torch.cat([k_nope, k_pe], -1)), heads(v)
        logits = torch.matmul(qb, kb.transpose(-1, -2)) * self.scale + causal
        o = torch.matmul(torch.softmax(logits, dim=-1, dtype=torch.float32), vb)
        return self.o_proj(pack.unpad(o.transpose(1, 2)).reshape(t, h * c.v_head_dim))


class _Router(nn.Module):
    def __init__(self, d: int, n_experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(n_experts, d) * d ** -0.5)
        self.e_score_correction_bias = nn.Parameter(torch.zeros(n_experts))


class _Experts(nn.Module):
    """The routed experts' weights, stacked: [E, width, hidden] for the gate
    and up projections, [E, hidden, width] for the down projection."""

    def __init__(self, n: int, d: int, width: int):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.randn(n, width, d) * d ** -0.5)
        self.up_proj = nn.Parameter(torch.randn(n, width, d) * d ** -0.5)
        self.down_proj = nn.Parameter(torch.randn(n, d, width) * width ** -0.5)


class _MoE(nn.Module):
    def __init__(self, cfg: MoETextConfig):
        super().__init__()
        d, width = cfg.hidden_size, cfg.moe_intermediate_size
        self.cfg = cfg
        self.gate = _Router(d, cfg.n_routed_experts)
        self.experts = _Experts(cfg.n_routed_experts, d, width)
        self.shared_experts = _SwiGLU(d, width * cfg.n_shared_experts)

    def route(self, y: torch.Tensor, load: torch.Tensor):
        """The top experts [T, k] of each row and their weights, the rows
        sorted by expert for dispatch, and each expert's row count (on the
        host). Adds the counts to ``load`` on the card."""
        c, k = self.cfg, self.cfg.num_experts_per_tok
        s = torch.sigmoid(F.linear(y, self.gate.weight))
        top = torch.topk(s + self.gate.e_score_correction_bias, k, dim=-1).indices
        w = s.gather(1, top)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * c.routed_scaling_factor
        pairs = top.reshape(-1)
        order = torch.argsort(pairs, stable=True)
        # counted by a scatter: bincount reads its input's range back to the host
        counts = torch.zeros_like(load).index_add_(0, pairs, torch.ones_like(pairs))
        load += counts
        return top, w, order, y.index_select(0, order // k), counts.tolist()

    def compute(self, y, w, order, rows, sizes) -> torch.Tensor:
        ex = self.experts
        outs = []
        for e, x in enumerate(rows.split(sizes)):
            if x.shape[0]:
                h = F.silu(F.linear(x, ex.gate_proj[e])) * F.linear(x, ex.up_proj[e])
                outs.append(F.linear(h, ex.down_proj[e]))
        routed = torch.empty_like(rows).index_copy_(0, order, torch.cat(outs))
        t, k = w.shape
        mixed = torch.bmm(w[:, None, :], routed.view(t, k, -1)).squeeze(1)
        return mixed + self.shared_experts(y)


class _Layer(nn.Module):
    def __init__(self, cfg: MoETextConfig, dense: bool):
        super().__init__()
        self.input_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = _MLA(cfg)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = _SwiGLU(cfg.hidden_size, cfg.intermediate_size) if dense else _MoE(cfg)
        self.dense = dense

    def forward(self, x, pack, cos, sin, causal, load):
        with annotate("lm.attn"):
            x = x + self.self_attn(self.input_layernorm(x), pack, cos, sin, causal)
        if self.dense:
            with annotate("lm.ffn"):
                return x + self.mlp(self.post_attention_layernorm(x)), None
        with annotate("lm.route"):
            y = self.post_attention_layernorm(x)
            top, w, order, rows, sizes = self.mlp.route(y, load)
        with annotate("lm.ffn"):
            return x + self.mlp.compute(y, w, order, rows, sizes), top


class MoETextEncoder(nn.Module):
    """ids [B, L] (right-padded) and lengths [B], on the host -> features
    [B, out_dim], read at each sentence's last real token. Ids or lengths
    on the card cost a wait to read them back.

    ``forward(..., return_routing=True)`` also gives the experts chosen,
    uint8 [routed layers, real tokens, k], tokens in sentence order.
    ``counters()`` gives ``expert_load``, the (token, expert) pairs routed
    by layer and expert since construction."""

    def __init__(self, cfg: Optional[MoETextConfig] = None):
        super().__init__()
        self.cfg = cfg = cfg or MoETextConfig()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(_Layer(cfg, i < cfg.first_k_dense_replace)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = _RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.adapter = nn.Linear(cfg.hidden_size, cfg.out_dim)
        # made at the first call on the weights' device: RoPE's frequencies,
        # and the counts [routed layers, E] int64
        self.inv_freq = self.load = None
        register_counters("moe_text", self)

    def counters(self):
        return {} if self.load is None else {"expert_load": self.load.tolist()}

    def forward(self, ids: torch.Tensor, lengths, return_routing: bool = False):
        c = self.cfg
        dev = self.embed_tokens.weight.device
        ids, lengths = ids.cpu(), torch.as_tensor(lengths, dtype=torch.long).cpu()
        if lengths.shape != ids.shape[:1] or int(lengths.min()) < 1 or \
                int(lengths.max()) > ids.shape[1]:
            raise ValueError(f"lengths {lengths.tolist()} do not fit ids of shape "
                             f"{tuple(ids.shape)}")
        if self.load is None or self.load.device != dev:
            self.load = torch.zeros(c.n_moe_layers, c.n_routed_experts, dtype=torch.long,
                                    device=dev)
            self.inv_freq = rope_inv_freq(c.qk_rope_head_dim, c.rope_theta).to(dev)
        pack = _Packing(ids, lengths, dev)
        x = self.embed_tokens(pack.ids)
        ang = pack.positions.float()[:, None] * self.inv_freq
        cos, sin = ang.cos()[:, None], ang.sin()[:, None]  # [T, 1, rope / 2]
        n = ids.shape[1]
        causal = torch.full((n, n), float("-inf"), device=dev).triu(1)
        routes = []
        for i, layer in enumerate(self.layers):
            x, top = layer(x, pack, cos, sin, causal,
                           None if layer.dense else self.load[i - c.first_k_dense_replace])
            if return_routing and top is not None:
                routes.append(top.to(torch.uint8))
        z = self.adapter(self.norm(x.index_select(0, pack.last)))
        return (z, torch.stack(routes)) if return_routing else z
