"""The yardstick of the language model text tower: its matmul FLOPs over a
batch's real tokens, from the configuration's DeepSeek-V3 keys and the
sentences' lengths (pad positions are not work, whatever a program
computes there).

By part, as the tower's spans split the work:

- ``attn``: per token and layer the four MLA projections (``q_proj``,
  ``kv_a_proj_with_mqa``, ``kv_b_proj``, ``o_proj``), and per sentence of
  n tokens the two attention products over its n (n + 1) / 2 causal
  (query, key) pairs;
- ``route``: the router's product in each routed layer;
- ``ffn``: layer 0's dense SwiGLU, the k routed experts' and the shared
  experts' SwiGLUs (three products each);
- ``adapter``: the product of each sentence's pooled state.
"""

from __future__ import annotations

from typing import Dict, Sequence


def tower_flops(cfg: Dict, lengths: Sequence[int]) -> Dict[str, float]:
    """FLOPs by part (and ``total``) over sentences of ``lengths``."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, n_layers = cfg["kv_lora_rank"], cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    routed = n_layers - dense
    tokens = float(sum(lengths))
    pairs = float(sum(n * (n + 1) // 2 for n in lengths))
    proj = 2.0 * d * (h * (nope + rope) + rank + rope) + 2.0 * rank * h * (nope + vd) \
        + 2.0 * h * vd * d
    attn = n_layers * (tokens * proj + pairs * 2.0 * h * (nope + rope + vd))
    route = routed * tokens * 2.0 * d * cfg["n_routed_experts"]
    swiglu = lambda width: 6.0 * d * width
    moe = cfg["moe_intermediate_size"]
    ffn = tokens * (dense * swiglu(cfg["intermediate_size"])
                    + routed * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
                    * swiglu(moe))
    adapter = len(lengths) * 2.0 * d * cfg["text_tower"]["out_dim"]
    return {"attn": attn, "route": route, "ffn": ffn, "adapter": adapter,
            "total": attn + route + ffn + adapter}
