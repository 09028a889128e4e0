"""Inference fast path: RAG forward with the fused TransMLP kernel.

Port of ``livelyspeaker_tpu/models/fast_rag.py``. Numerically the eval-mode
``RAG.forward``, but the mixer stack and the pose projection run as one
``fused_transmlp`` call and every t-invariant term is computed once per clip
batch (:func:`precompute_rag_static`):

- the audio encoding;
- the [origin_x | indicator bit | audio] share of the input projection, since
  ``Linear(concat(a, b)) == a @ W_a + b @ W_b`` and only x_t changes per step;
- the timestep-embedding MLP over all 5000 PE rows, so a step gathers a row.

One diffusion step is then a [B,T,IF] x [IF,D] product, the style token and
one kernel launch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .cfg import duplicate_cond, guidance_scale_tensor, scheduled_scale
from .rag import RAG, randn_like_on
from ..ops.fused_mlp import fused_transmlp, pack_out_proj, pack_transmlp_params

__all__ = ["RAGStatic", "precompute_rag_static", "fused_rag_forward",
           "make_fused_cfg_denoiser"]


class RAGStatic(NamedTuple):
    """Per-clip-batch precomputation shared by every diffusion step."""

    packed: Dict[str, torch.Tensor]  # kernel weight stack, LN2 folded
    out_proj: Dict[str, torch.Tensor]  # pose_final as [D, F] + [F]
    w_x: torch.Tensor  # input_mapping rows for the x_t block, [IF, D]
    static_h: torch.Tensor  # (origin | bit | audio) @ W_rest + bias, [B, T, D]
    emb_table: torch.Tensor  # timestep MLP over the whole PE table, [N, D]


@torch.no_grad()
def precompute_rag_static(
    model: RAG,
    cond: Dict[str, torch.Tensor],
    audio_feats: torch.Tensor,  # [B, T, 256]
) -> RAGStatic:
    c = model.cfg
    nt = c.nframes
    in_feats = c.input_feats
    drop = cond.get("cond_drop")
    audio_emb = audio_feats * (1.0 - drop)[:, None, None] if drop is not None else audio_feats
    b = audio_emb.shape[0]

    seed_mask = (torch.arange(nt, device=audio_emb.device) < c.n_pre_seq).to(audio_emb.dtype)
    origin_x = cond["origin_x"].to(audio_emb.dtype) * seed_mask
    rest = torch.cat(
        [origin_x.reshape(b, in_feats, nt).transpose(1, 2),
         seed_mask[None, :, None].expand(b, nt, 1), audio_emb],
        dim=-1,
    )
    w = model.input_mapping.weight.t()  # [in, D]
    w_x, w_rest = w[:in_feats].contiguous(), w[in_feats:]
    static_h = rest @ w_rest + model.input_mapping.bias

    te = model.backbone.embed_timestep
    emb_table = te.fc2(F.silu(te.fc1(te.pe))).contiguous()
    return RAGStatic(
        packed=pack_transmlp_params(model.backbone, fold_ln2=True),
        out_proj=pack_out_proj(model.pose_final),
        w_x=w_x,
        static_h=static_h,
        emb_table=emb_table,
    )


@torch.no_grad()
def _forward_from_static(
    model: RAG,
    static: RAGStatic,
    x: torch.Tensor,  # [B, J, F, T]
    t: torch.Tensor,  # [B]
    cond: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    c = model.cfg
    b, nj, nf, nt = x.shape
    h = x.reshape(b, nj * nf, nt).transpose(1, 2) @ static.w_x + static.static_h

    z_ctx = model.speaker_embedding(cond["vid"])[:, None]
    z_mu = model.speaker_mu(z_ctx)
    z_logvar = model.speaker_logvar(z_ctx)
    eps = cond.get("style_eps")
    if eps is None:
        eps = randn_like_on(z_mu, generator)
    prefix = [z_mu + eps * torch.exp(0.5 * z_logvar)]
    if c.num_emotions:
        prefix.append(model.emotion_embedding(cond["emo"])[:, None])
    h = torch.cat(prefix + [h], dim=1).contiguous()  # [B, S, D]

    out = fused_transmlp(
        h, static.emb_table[t], static.packed, act_name=c.mlpact,
        out_proj=static.out_proj,
    )  # [B, S, IF]
    return out[:, c.n_prefix:].transpose(1, 2).reshape(b, nj, nf, nt)


def fused_rag_forward(
    model: RAG,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: Dict[str, torch.Tensor],
    audio_feats: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Eval-mode RAG forward returning the x0 prediction [B, J, F, T]."""
    static = precompute_rag_static(model, cond, audio_feats)
    return _forward_from_static(model, static, x, t, cond, generator)


@torch.no_grad()
def make_fused_cfg_denoiser(
    model: RAG,
    cond: Dict[str, torch.Tensor],
    guidance_scale,
    *,
    guidance_schedule=None,
):
    """CFG denoiser closure ``(x, t, generator) -> x0_hat`` on the fused
    path; a drop-in for ``cfg.make_cfg_denoiser``. Every t-invariant term is
    computed here, once. Without ``style_eps`` in ``cond`` each step draws
    the style noise for all 2B rows, so the two halves draw independently.
    A sample that is not f32 raises: the kernel is f32 only."""
    b = cond["vid"].shape[0]
    device = cond["vid"].device
    audio_feats = model.encode_audio(cond["audio"])
    cond2 = duplicate_cond(cond, b, device)
    static = precompute_rag_static(model, cond2, torch.cat([audio_feats, audio_feats]))
    scale = guidance_scale_tensor(guidance_scale, b, device)

    def denoise_fn(x, t, generator=None):
        if x.dtype != torch.float32:  # K1 is f32 only: no silent cast
            raise TypeError(f"the fused denoiser takes f32 samples, not {x.dtype}")
        out = _forward_from_static(
            model, static, torch.cat([x, x]), torch.cat([t, t]), cond2, generator
        )
        out_c, out_u = out[:b], out[b:]
        s = scheduled_scale(scale, guidance_schedule, t, b)
        return out_u + s * (out_c - out_u)

    return denoise_fn
