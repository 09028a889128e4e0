"""The RAG denoiser in plain PyTorch, float32: the benchmark's reference.

Written from the published model (zyhbili/LivelySpeaker,
``scripts/model/RAG.py``), independent of the port: functions over a dict
of tensors named as the port's state dict, no kernels, no caches. Callers
turn TF32 off (``reference.precision``) unless they run the control.

One forward, with x [B, J, F, T] the noised motion and t [B] the
original-process timesteps:

1. the WavEncoder: four strided convs (kernel 15, strides 5/6/6/6, the
   first padded 1600 a side), InstanceNorm and LeakyReLU(0.3) between them,
   to per-frame 256-d features, zeroed where the condition is dropped;
2. [x | seed frames | seed indicator | audio] per frame, one Linear to the
   latent width;
3. the style token, mu + eps * exp(logvar / 2) from the speaker embedding,
   prepended (and on BEAT the emotion embedding after it);
4. the mixer blocks, each: add the timestep embedding (an MLP over a
   sinusoidal table), then x + silu(token mix of LN(x)), then x + silu(channel
   mix of LN(x)); the prefix tokens dropped and a Linear back to poses.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

WAV_CONVS = ((5, 1600), (6, 0), (6, 0), (6, 0))  # stride, padding
PE_ROWS = 5000


def sinusoid_table(rows: int, dim: int, device) -> torch.Tensor:
    """The transformer's sinusoidal table [rows, dim], built in float64."""
    pos = np.arange(rows, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((rows, dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.tensor(pe, dtype=torch.float32, device=device)


def wav_encoder(p: Params, wav: torch.Tensor) -> torch.Tensor:
    """[B, L] waveform -> [B, T, 256] features."""
    x = wav.float()[:, None, :]
    for i, (stride, pad) in enumerate(WAV_CONVS):
        x = F.conv1d(x, p[f"audio_encoder.conv{i}.weight"], p[f"audio_encoder.conv{i}.bias"],
                     stride=stride, padding=pad)
        if i < 3:
            x = F.leaky_relu(F.instance_norm(x, eps=1e-5), 0.3)
    return x.transpose(1, 2)


def timestep_embedding(p: Params, pe: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    e = "backbone.embed_timestep."
    h = F.linear(pe[t], p[e + "fc1.weight"], p[e + "fc1.bias"])
    return F.linear(F.silu(h), p[e + "fc2.weight"], p[e + "fc2.bias"])[:, None]


def mixer(p: Params, cfg: Dict, h: torch.Tensor, t: torch.Tensor,
          pe: torch.Tensor) -> torch.Tensor:
    """The backbone over [B, S, D] at timesteps t [B]."""
    emb = timestep_embedding(p, pe, t)
    d = h.shape[-1]
    for i in range(cfg["num_layers"]):
        b = f"backbone.block_{i}."
        h = h + emb
        y = F.layer_norm(h, (d,), p[b + "ln1.weight"], p[b + "ln1.bias"], 1e-5)
        y = torch.einsum("ij,bjd->bid", p[b + "token_mix_kernel"], y)
        h = h + F.silu(y + p[b + "token_mix_bias"][None, :, None])
        y = F.layer_norm(h, (d,), p[b + "ln2.weight"], p[b + "ln2.bias"], 1e-5)
        h = h + F.silu(F.linear(y, p[b + "channel_mix.weight"], p[b + "channel_mix.bias"]))
    return h


def forward(p: Params, cfg: Dict, x: torch.Tensor, t: torch.Tensor, feats: torch.Tensor,
            vid: torch.Tensor, origin: torch.Tensor, drop: torch.Tensor,
            style_eps: torch.Tensor, emo: Optional[torch.Tensor] = None,
            pe: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x0 prediction [B, J, F, T], z_mu, z_logvar) of one forward.
    ``feats``: the WavEncoder's [B, T, 256]; ``drop`` [B]: 1 drops the
    condition; ``style_eps`` [B, 1, D]."""
    b, nj, nf, nt = x.shape
    if pe is None:
        pe = sinusoid_table(PE_ROWS, cfg["latent_dim"], x.device)
    seed = (torch.arange(nt, device=x.device) < cfg["n_pre_seq"]).float()
    btc = lambda a: a.reshape(b, nj * nf, nt).transpose(1, 2)
    h = torch.cat([btc(x), btc(origin.float()) * seed[None, :, None],
                   seed[None, :, None].expand(b, nt, 1),
                   feats * (1.0 - drop.float())[:, None, None]], dim=-1)
    h = F.linear(h, p["input_mapping.weight"], p["input_mapping.bias"])
    z = p["speaker_embedding.weight"][vid][:, None]
    mu = F.linear(z, p["speaker_mu.weight"], p["speaker_mu.bias"])
    logvar = F.linear(z, p["speaker_logvar.weight"], p["speaker_logvar.bias"])
    prefix = [mu + style_eps * torch.exp(0.5 * logvar)]
    if cfg["num_emotions"]:
        prefix.append(p["emotion_embedding.weight"][emo][:, None])
    h = mixer(p, cfg, torch.cat(prefix + [h], dim=1), t, pe)[:, len(prefix):]
    out = F.linear(h, p["pose_final.weight"], p["pose_final.bias"])
    return out.transpose(1, 2).reshape(b, nj, nf, nt), mu, logvar
