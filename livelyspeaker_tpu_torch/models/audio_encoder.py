"""Raw-waveform audio frontend (WavEncoder) in PyTorch.

Port of ``livelyspeaker_tpu/models/audio_encoder.py``: 16 kHz waveform ->
per-motion-frame 256-d features via four strided 1-D convs (kernel 15,
strides 5/6/6/6, the first padded 1600 per side) with InstanceNorm
(no affine, eps 1e-5) and LeakyReLU(0.3) between them. 36,266 samples
(34 frames at 15 fps) map to exactly 34 feature frames.

The public layout is the JAX package's: [B, L] in, [B, T, 256] out. Inside,
the convs run channels-first as ``torch.nn.Conv1d`` (cuDNN on the card);
``RAGSampler`` and the trainer pin ``torch.backends.cudnn.allow_tf32 = False``
so they run in f32, not TF32.

``dtype`` is the conv stack's activation and compute type: with bf16 the
parameters are cast per call (the cast is differentiable, so the f32
parameters get f32 gradients), the InstanceNorm statistics are still taken
in f32, and the returned features are f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import conv_default_

__all__ = ["WavEncoder", "audio_samples_for_frames"]


def audio_samples_for_frames(n_frames: int, fps: int = 15, sr: int = 16000) -> int:
    """Waveform length paired with ``n_frames`` of motion (n/fps s at sr)."""
    return int(round(n_frames / fps * sr))


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each (batch, channel) of [B, C, L] over time, two-pass, with
    the statistics in f32 whatever x's dtype; returned in x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class WavEncoder(nn.Module):
    """audio [B, L] (float, or int16 PCM) -> [B, T_out, 256] features."""

    def __init__(self, leak: float = 0.3,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.leak = leak
        self.dtype = dtype
        chans = [(1, 32, 5, 1600), (32, 64, 6, 0), (64, 128, 6, 0), (128, 256, 6, 0)]
        for i, (cin, cout, stride, pad) in enumerate(chans):
            self.add_module(
                f"conv{i}",
                conv_default_(nn.Conv1d(cin, cout, 15, stride=stride, padding=pad),
                              generator),
            )

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if not wav.is_floating_point():
            wav = wav.to(torch.float32) * (1.0 / 32768.0)
        x = wav.to(self.dtype)[:, None, :]  # [B, 1, L]
        for i in range(4):
            conv = getattr(self, f"conv{i}")
            x = F.conv1d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                         stride=conv.stride, padding=conv.padding)
            if i < 3:
                x = F.leaky_relu(_instance_norm(x), self.leak)
        return x.transpose(1, 2).to(torch.float32)  # [B, T, 256]
