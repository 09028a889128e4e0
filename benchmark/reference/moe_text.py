"""Moonlight-16B-A3B's decoder stack (DeepSeek-V3's layer) in plain
PyTorch, float32: the benchmark's reference for the composition's language
model text tower.

Written from DeepSeek-V3's modelling code as Moonlight's ``config.json``
sets it (``model_type`` ``deepseek_v3``), independent of the port;
functions over a dict of tensors named as the port's state dict
(``layers.{i}.self_attn.q_proj.weight``, stacked experts
``layers.{i}.mlp.experts.gate_proj`` [E, width, hidden], ...). Token ids
[B, L] are right-padded; each sentence has its length. Sentences go
through in blocks of ``block``, padded to the block's longest, and every
position of a block is computed by attention; the feed-forward runs on the
real tokens (a pad position is never read by a real one under the causal
mask). Routed experts run one at a time on the tokens that chose them.

Departures from the released model, as in the port:

- the output head (``lm_head``) is not held: the stack is read as an
  encoder;
- each sentence's feature is its final-norm state at its last real token
  (position ``length - 1``);
- an adapter ``Linear(hidden, out_dim)`` with a bias maps it to the SAG's
  latent (``adapter.weight``, ``adapter.bias``).

:func:`forward` routes on its own scores, or, given a routing (the experts
each real token chose in each routed layer, in sentence order, as the
port returns it), follows those experts, weighted by its own scores; it
also reports the worst margin by which a followed choice falls outside its
own top k (0 where every choice agrees).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _rms(x, w, eps):
    x32 = x.float()
    return w * (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps))


def _rotary(n: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [n, dim] of positions 0..n-1, frequencies made on the
    host in f32 and repeated over the two halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freqs = torch.outer(torch.arange(n, dtype=torch.float32), inv_freq).to(device)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x):
    a, b = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-b, a), dim=-1)


def _apply_rotary(x, cos, sin):
    """The released layout: x's interleaved pairs gathered into halves,
    then x * cos + rotate_half(x) * sin."""
    *lead, d = x.shape
    x = x.view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    return x * cos + _rotate_half(x) * sin


def _attention(p: Params, pre: str, cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """Causal multi-head latent attention over x [b, n, hidden]."""
    b, n, _ = x.shape
    h = cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = F.linear(x, p[pre + "q_proj.weight"]).view(b, n, h, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    kv = F.linear(x, p[pre + "kv_a_proj_with_mqa.weight"])
    c, k_pe = kv.split([cfg["kv_lora_rank"], rope], dim=-1)
    k_pe = k_pe.view(b, 1, n, rope)
    kv = F.linear(_rms(c, p[pre + "kv_a_layernorm.weight"], cfg["rms_norm_eps"]),
                  p[pre + "kv_b_proj.weight"]).view(b, n, h, nope + vd).transpose(1, 2)
    k_nope, v = kv.split([nope, vd], dim=-1)
    cos, sin = _rotary(n, rope, cfg["rope_theta"], x.device)
    q_pe, k_pe = _apply_rotary(q_pe, cos, sin), _apply_rotary(k_pe, cos, sin)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, h, n, rope)], dim=-1)
    w = torch.matmul(q, k.transpose(2, 3)) * (nope + rope) ** -0.5
    w = w + torch.full((n, n), float("-inf"), device=x.device).triu(1)
    w = torch.softmax(w, dim=-1, dtype=torch.float32)
    o = torch.matmul(w, v).transpose(1, 2).reshape(b, n, h * vd)
    return F.linear(o, p[pre + "o_proj.weight"])


def _swiglu(y, gate, up, down):
    return F.linear(F.silu(F.linear(y, gate)) * F.linear(y, up), down)


def _moe(p: Params, pre: str, cfg: Dict, y: torch.Tensor,
         chosen: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """A routed layer on the real tokens y [t, hidden]: (output, the
    experts followed [t, k], the margin of the followed choices)."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(F.linear(y.float(), p[pre + "gate.weight"].float()))
    biased = scores + p[pre + "gate.e_score_correction_bias"]
    own = torch.topk(biased, k, dim=-1)
    chosen = own.indices if chosen is None else chosen.long()
    margin = float((own.values[:, -1] - biased.gather(1, chosen).min(-1).values).max())
    w = scores.gather(1, chosen)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    out = _swiglu(y, p[pre + "shared_experts.gate_proj.weight"],
                  p[pre + "shared_experts.up_proj.weight"],
                  p[pre + "shared_experts.down_proj.weight"])
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            ye = _swiglu(y[rows], p[pre + "experts.gate_proj"][e], p[pre + "experts.up_proj"][e],
                         p[pre + "experts.down_proj"][e])
            out.index_add_(0, rows, ye * w[rows, slot, None])
    return out, chosen, margin


def forward(p: Params, cfg: Dict, ids: torch.Tensor, lengths: Sequence[int],
            routing: Optional[torch.Tensor] = None,
            block: int = 16) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """ids [B, L], lengths [B] -> (features [B, out_dim], the experts
    followed, uint8 [routed layers, real tokens, k], the worst margin).
    ``cfg``: the DeepSeek-V3 ``config.json`` keys; ``routing``: experts to
    follow, in the same layout."""
    lengths = [int(n) for n in lengths]
    eps, dense = cfg["rms_norm_eps"], cfg["first_k_dense_replace"]
    feats, routes, margin = [], [], 0.0
    at = 0  # the block's first real token in sentence order
    for s0 in range(0, len(lengths), block):
        lens = lengths[s0:s0 + block]
        n = max(lens)
        real = torch.arange(n, device=ids.device)[None, :] < torch.tensor(lens, device=ids.device)[:, None]
        t = int(real.sum())
        x = p["embed_tokens.weight"][ids[s0:s0 + len(lens), :n].long()]
        used = []
        for i in range(cfg["num_hidden_layers"]):
            pre = f"layers.{i}."
            x = x + _attention(p, pre + "self_attn.", cfg, _rms(x, p[pre + "input_layernorm.weight"], eps))
            y = _rms(x[real], p[pre + "post_attention_layernorm.weight"], eps)
            if i < dense:
                f = _swiglu(y, p[pre + "mlp.gate_proj.weight"], p[pre + "mlp.up_proj.weight"],
                            p[pre + "mlp.down_proj.weight"])
            else:
                given = None if routing is None else routing[i - dense, at:at + t]
                f, chosen, m = _moe(p, pre + "mlp.", cfg, y, given)
                used.append(chosen)
                margin = max(margin, m)
            x = x.clone()
            x[real] = x[real] + f
        last = x[torch.arange(len(lens), device=x.device), torch.tensor(lens, device=x.device) - 1]
        feats.append(F.linear(_rms(last, p["norm.weight"], eps), p["adapter.weight"],
                              p["adapter.bias"]))
        routes.append(torch.stack(used))
        at += t
    return torch.cat(feats), torch.cat(routes, dim=1).to(torch.uint8), margin
