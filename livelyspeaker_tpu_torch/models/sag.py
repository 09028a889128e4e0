"""SAG, the Semantic-Aware Generator (MotionCLIP-style), in PyTorch.

Port of ``livelyspeaker_tpu/models/sag.py``: a motion <-> CLIP-space
autoencoder. The encoder prepends learned mu/sigma query tokens to the
skeleton embedding and runs a transformer encoder; ``mu`` (the first output
token) is the motion latent. The decoder takes the latent as a 1-token
memory, builds time queries from the first ``n_pre_poses`` seed frames and an
indicator bit through a linear mapping plus the sinusoidal PE, and runs a
transformer decoder back to poses.

In the two-stage composition only the decoder runs, fed a frozen CLIP text
embedding as ``z`` (``pipeline.LivelySpeakerPipeline.semantic_sketch``).
Names follow the Flax tree (``encoder.mu_query``, ``decoder.mapping``, ...).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .initializers import dense_default_
from .mlp_backbone import sinusoidal_table
from .transformer import TransformerDecoder, TransformerEncoder

__all__ = ["SAGEncoder", "SAGDecoder", "SAG", "sag_losses"]

_PE_LEN = 5000  # rows of the sequence PE table, as in the JAX modules


def _valid_mask(mask: Optional[torch.Tensor], b: int, nt: int,
                device) -> torch.Tensor:
    if mask is None:
        return torch.ones((b, nt), dtype=torch.bool, device=device)
    return mask.bool()


class SAGEncoder(nn.Module):
    """motion [B, J, F, T] (+ mask [B, T], True = valid) -> {"mu": [B, D]}."""

    def __init__(self, njoints: int = 9, nfeats: int = 3, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 3, num_heads: int = 4,
                 dropout: float = 0.1, activation: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.skel_embedding = dense_default_(
            nn.Linear(njoints * nfeats, latent_dim), generator)
        self.mu_query = nn.Parameter(torch.randn(1, latent_dim, generator=generator))
        self.sigma_query = nn.Parameter(torch.randn(1, latent_dim, generator=generator))
        self.register_buffer("pe", sinusoidal_table(_PE_LEN, latent_dim), persistent=False)
        self.dropout = nn.Dropout(dropout)
        self.encoder = TransformerEncoder(num_layers, latent_dim, num_heads, ff_size,
                                          dropout, activation, generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        b, nj, nf, nt = x.shape
        mask = _valid_mask(mask, b, nt, x.device)
        h = self.skel_embedding(x.reshape(b, nj * nf, nt).transpose(1, 2))  # [B, T, D]
        prefix = torch.cat([self.mu_query, self.sigma_query])[None].expand(
            b, 2, self.latent_dim)
        h = torch.cat([prefix, h], dim=1)  # [B, 2+T, D]
        h = self.dropout(h + self.pe[None, :h.shape[1]])
        full_mask = torch.cat(
            [torch.ones((b, 2), dtype=torch.bool, device=x.device), mask], dim=1)
        h = self.encoder(h, key_padding_mask=full_mask)
        return {"mu": h[:, 0]}


class SAGDecoder(nn.Module):
    """latent z [B, D] + seed frames of x [B, J, F, T] -> motion [B, J, F, T]."""

    def __init__(self, njoints: int = 9, nfeats: int = 3, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 3, num_heads: int = 4,
                 dropout: float = 0.1, activation: str = "gelu",
                 n_pre_poses: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_pre_poses = n_pre_poses
        input_feats = njoints * nfeats
        self.mapping = dense_default_(nn.Linear(input_feats + 1, latent_dim), generator)
        self.register_buffer("pe", sinusoidal_table(_PE_LEN, latent_dim), persistent=False)
        self.dropout = nn.Dropout(dropout)
        self.decoder = TransformerDecoder(num_layers, latent_dim, num_heads, ff_size,
                                          dropout, activation, generator)
        self.final_layer = dense_default_(nn.Linear(latent_dim, input_feats), generator)

    def forward(self, z: torch.Tensor, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, nj, nf, nt = x.shape
        mask = _valid_mask(mask, b, nt, x.device)
        # seed conditioning: the first n_pre_poses frames of the motion and an
        # indicator bit, zero elsewhere
        motion = x.reshape(b, nj * nf, nt).transpose(1, 2)  # [B, T, IF]
        seed = (torch.arange(nt, device=x.device) < self.n_pre_poses).to(motion.dtype)
        pre_cond = torch.cat(
            [motion * seed[None, :, None], seed[None, :, None].expand(b, nt, 1)], dim=-1)
        tq = self.dropout(self.mapping(pre_cond) + self.pe[None, :nt])
        h = self.decoder(tq, z[:, None, :])  # the latent as a 1-token memory
        out = self.final_layer(h) * mask.to(h.dtype)[:, :, None]  # zero padded frames
        return out.transpose(1, 2).reshape(b, nj, nf, nt)


class SAG(nn.Module):
    """Encoder and decoder pair (MOTIONCLIP)."""

    def __init__(self, njoints: int = 9, nfeats: int = 3, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 3, num_heads: int = 4,
                 dropout: float = 0.1, n_pre_poses: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(njoints=njoints, nfeats=nfeats, latent_dim=latent_dim,
                  ff_size=ff_size, num_layers=num_layers, num_heads=num_heads,
                  dropout=dropout, generator=generator)
        self.encoder = SAGEncoder(**kw)
        self.decoder = SAGDecoder(n_pre_poses=n_pre_poses, **kw)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Auto-encode: motion -> z -> motion."""
        z = self.encoder(x, mask)["mu"]
        return {"z": z, "output": self.decoder(z, x, mask)}

    def encode(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(x, mask)["mu"]

    def decode(self, z: torch.Tensor, x: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(z, x, mask)


def sag_losses(x: torch.Tensor, output: torch.Tensor, z: torch.Tensor,
               text_features: torch.Tensor,
               lam_cos: float = 1.0) -> Dict[str, torch.Tensor]:
    """SAG training loss: recon MSE + velocity MSE + lam_cos * (1 - cos(z,
    clip_text))."""
    xyz_loss = torch.mean((x - output) ** 2)
    vel_loss = torch.mean(
        ((x[..., 1:] - x[..., :-1]) - (output[..., 1:] - output[..., :-1])) ** 2)
    fn = text_features / torch.linalg.norm(text_features, dim=-1, keepdim=True)
    zn = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    cos = torch.sum(fn * zn, dim=-1)
    cos_loss = torch.mean(1.0 - cos)
    return {
        "xyz_loss": xyz_loss,
        "vel_loss": vel_loss,
        "clip_loss": cos_loss,
        "cos_sim": torch.mean(cos),
        "sum": xyz_loss + vel_loss + lam_cos * cos_loss,
    }
