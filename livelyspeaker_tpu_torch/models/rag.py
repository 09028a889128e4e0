"""RAG, the Rhythm-Aware diffusion Generator, in PyTorch.

Port of ``livelyspeaker_tpu/models/rag.py``: the model predicts x0. One
forward pass:
  1. WavEncoder(audio) -> per-frame 256-d features, dropped per sample by
     ``cond_drop`` (1 = the unconditional pass of classifier-free guidance);
  2. concat [x_t | seed-masked origin_x | indicator bit | audio] per frame,
     Linear -> latent;
  3. a VAE-style speaker token (Embedding -> mu / logvar -> sample) is
     prepended; BEAT also prepends an emotion token;
  4. the TransMLP backbone, then the prefix tokens are stripped and a Linear
     maps back to pose space.
Layouts are the JAX package's: x is [B, J, F, T], features are [B, T, C].
The forward computes in x's dtype (f32, or bf16 under the trainer's
``compute_dtype``, with bf16 copies of the parameters); the audio features
are always f32 and are cast to it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from .audio_encoder import WavEncoder
from .initializers import dense_default_
from .mlp_backbone import TransMLP

__all__ = ["RAG", "RAGConfig"]


class RAGConfig:
    """Static hyperparameters (defaults: the TED configuration)."""

    def __init__(
        self,
        njoints: int = 9,
        nfeats: int = 3,
        nframes: int = 34,
        latent_dim: int = 512,
        num_layers: int = 8,
        mlpact: str = "silu",
        n_pre_seq: int = 4,
        n_speakers: int = 1400,
        speaker_dim: int = 256,
        audio_feat_dim: int = 256,
        num_emotions: int = 0,  # 8 for BEAT
        cond_mask_prob: float = 0.1,
        fused_train_backbone: bool = False,
        audio_bf16: bool = False,
    ):
        self.njoints = njoints
        self.nfeats = nfeats
        self.nframes = nframes
        self.latent_dim = latent_dim
        self.num_layers = num_layers
        self.mlpact = mlpact
        self.n_pre_seq = n_pre_seq
        self.n_speakers = n_speakers
        self.speaker_dim = speaker_dim
        self.audio_feat_dim = audio_feat_dim
        self.num_emotions = num_emotions
        self.cond_mask_prob = cond_mask_prob
        # the mixer stack through the fused training kernel with the
        # hand-written backward (in f32, also under a bf16 compute dtype)
        self.fused_train_backbone = fused_train_backbone
        # bf16 activations for the WavEncoder's conv stack only; its
        # parameters and returned features stay f32
        self.audio_bf16 = audio_bf16

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats

    @property
    def n_prefix(self) -> int:
        """Prefix condition tokens: style (+ emotion for BEAT)."""
        return 1 + (1 if self.num_emotions else 0)

    @property
    def seq_len(self) -> int:
        return self.nframes + self.n_prefix

    @classmethod
    def ted(cls, **kw) -> "RAGConfig":
        return cls(**kw)

    @classmethod
    def beat(cls, njoints: int = 47, nfeats: int = 6, **kw) -> "RAGConfig":
        kw.setdefault("num_emotions", 8)
        return cls(njoints=njoints, nfeats=nfeats, **kw)


def _embedding(n: int, dim: int) -> nn.Embedding:
    emb = nn.Embedding(n, dim)
    nn.init.constant_(emb.weight, 1e-6)
    return emb


class RAG(nn.Module):
    """The denoiser; submodule names follow the Flax tree."""

    def __init__(self, cfg: RAGConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        self.audio_encoder = WavEncoder(
            generator=generator,
            dtype=torch.bfloat16 if c.audio_bf16 else torch.float32)
        self.input_mapping = dense_default_(
            nn.Linear(2 * c.input_feats + 1 + c.audio_feat_dim, c.latent_dim),
            generator,
        )
        self.speaker_embedding = _embedding(c.n_speakers, c.speaker_dim)
        self.speaker_mu = dense_default_(
            nn.Linear(c.speaker_dim, c.latent_dim), generator)
        self.speaker_logvar = dense_default_(
            nn.Linear(c.speaker_dim, c.latent_dim), generator)
        if c.num_emotions:
            self.emotion_embedding = _embedding(c.num_emotions, c.latent_dim)
        self.backbone = TransMLP(c.seq_len, c.num_layers, c.latent_dim,
                                 c.mlpact, generator=generator,
                                 fused_vjp=c.fused_train_backbone)
        self.pose_final = dense_default_(
            nn.Linear(c.latent_dim, c.input_feats), generator)

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """Hoistable audio frontend: [B, L] -> [B, T, 256]."""
        feats = self.audio_encoder(audio)
        if feats.shape[1] != self.cfg.nframes:
            raise ValueError(
                f"audio length maps to {feats.shape[1]} frames, "
                f"expected {self.cfg.nframes}"
            )
        return feats

    def _drop_mask(self, batch: int, cond_drop, train: bool,
                   generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
        """Per-sample conditioning drop: 1 -> null condition."""
        if cond_drop is not None:
            return cond_drop.to(torch.float32)
        if train and self.cfg.cond_mask_prob > 0.0:
            u = torch.rand((batch,), generator=generator,
                           device=_gen_device(generator, device))
            return (u < self.cfg.cond_mask_prob).to(device, torch.float32)
        return torch.zeros((batch,), device=device)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        cond: Dict[str, torch.Tensor],
        *,
        train: bool = False,
        audio_feats: Optional[torch.Tensor] = None,
        backbone_apply: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """x: [B, J, F, T] x_t; t: [B] original-process timesteps.
        cond: 'audio' [B, L] (or pass audio_feats), 'vid' [B] speaker ids,
        'origin_x' [B, J, F, T] seed motion, optional 'emo' [B], optional
        'cond_drop' [B] (1 = uncond), optional 'style_eps' [B, 1, D] (the
        deterministic style draw). backbone_apply: optional (h [B,S,D],
        t [B]) -> [B,S,D] stand-in for the backbone, numerically equal."""
        c = self.cfg
        b, nj, nf, nt = x.shape
        if (nj, nf, nt) != (c.njoints, c.nfeats, c.nframes):
            raise ValueError(f"x has shape {tuple(x.shape)}")

        if audio_feats is None:
            audio_feats = self.encode_audio(cond["audio"])
        drop = self._drop_mask(b, cond.get("cond_drop"), train, generator,
                               x.device)
        audio_emb = (audio_feats * (1.0 - drop)[:, None, None]).to(x.dtype)

        seed_mask = (torch.arange(nt, device=x.device) < c.n_pre_seq).to(x.dtype)
        origin_x = cond["origin_x"].to(x.dtype) * seed_mask

        to_btc = lambda a: a.reshape(b, nj * nf, nt).transpose(1, 2)
        h = torch.cat(
            [to_btc(x), to_btc(origin_x),
             seed_mask[None, :, None].expand(b, nt, 1), audio_emb],
            dim=-1,
        )
        h = self.input_mapping(h)  # [B, T, D]

        z_context = self.speaker_embedding(cond["vid"])[:, None]
        z_mu = self.speaker_mu(z_context)
        z_logvar = self.speaker_logvar(z_context)
        eps = cond.get("style_eps")
        if eps is None:
            eps = randn_like_on(z_mu, generator)
        eps = eps.to(z_mu.dtype)
        style = z_mu + eps * torch.exp(0.5 * z_logvar)

        prefix = [style]
        if c.num_emotions:
            prefix.append(self.emotion_embedding(cond["emo"])[:, None])
        h = torch.cat(prefix + [h], dim=1)  # [B, S, D]

        backbone = backbone_apply if backbone_apply is not None else self.backbone
        h = backbone(h, t)[:, c.n_prefix:]
        out = self.pose_final(h).transpose(1, 2).reshape(b, nj, nf, nt)
        return {"output": out, "z_mu": z_mu, "z_logvar": z_logvar}


def _gen_device(generator: Optional[torch.Generator], device):
    return generator.device if generator is not None else device


def randn_like_on(ref: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normals shaped like ``ref``, drawn on the generator's device
    and placed on ``ref``'s."""
    return torch.randn(
        ref.shape, generator=generator, dtype=ref.dtype,
        device=_gen_device(generator, ref.device),
    ).to(ref.device)
