"""Frozen evaluation embedding networks (TED FGD / BEAT FID), in PyTorch:
the encoder half.

Port of the encoder of ``livelyspeaker_tpu/models/embedding_net.py``:

- TED: the TriModal gesture-autoencoder's encoder the FGD evaluator uses
  (``PoseEncoderConv``); out_net widths 8x and 4x base;
- BEAT: HalfEmbeddingNet's ``PoseEncoderConv`` (base 300, 282 pose dims);
  out_net widths 4x and 2x base.

BatchNorm runs in inference mode on stored statistics, kept as buffers:
these nets are only evaluated. Names follow the Flax tree (``conv0``,
``conv0_bn_mean``, ``fc_mu``, ...), so ``utils.convert.jax_params_to_state_dict``
carries the JAX package's parameters over, and
``utils.convert.pose_embedding_state_dict_from_torch`` maps the reference's
checkpoint layout.

Kept from the reference: its ``nn.LeakyReLU(True)`` inside ``out_net``
passes ``True`` as ``negative_slope`` (1.0), so those activations are
identities and are left out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .initializers import conv_default_, dense_default_

__all__ = ["PoseEmbeddingEncoder", "TedEmbeddingEncoder", "BeatEmbeddingEncoder"]


def _frozen_bn(x: torch.Tensor, mean, var, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over the channel axis (dim 1) from stored stats."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = 1.0 / torch.sqrt(var + eps)
    return ((x - mean.view(shape)) * inv.view(shape) * scale.view(shape)
            + bias.view(shape))


class PoseEmbeddingEncoder(nn.Module):
    """poses [B, T, D] -> base-dim embedding (``PoseEncoderConv`` without the
    variational head: returns ``fc_mu(out)``)."""

    def __init__(self, pose_dim: int = 27, n_frames: int = 34, base: int = 32,
                 hidden_mults: Tuple[int, int] = (8, 4),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pose_dim, self.n_frames, self.base = pose_dim, n_frames, base
        b = base
        convs = ((pose_dim, b, 3, 1), (b, 2 * b, 3, 1), (2 * b, 2 * b, 4, 2), (2 * b, b, 3, 1))
        length = n_frames
        for i, (c_in, c_out, k, s) in enumerate(convs):
            setattr(self, f"conv{i}", conv_default_(nn.Conv1d(c_in, c_out, k, s), generator))
            length = (length - k) // s + 1
            if i < 3:
                self._add_bn(f"conv{i}", c_out)
        h0, h1 = b * hidden_mults[0], b * hidden_mults[1]
        self.fc0 = dense_default_(nn.Linear(b * length, h0), generator)
        self._add_bn("fc0", h0)
        self.fc1 = dense_default_(nn.Linear(h0, h1), generator)
        self._add_bn("fc1", h1)
        self.fc2 = dense_default_(nn.Linear(h1, b), generator)
        self.fc_mu = dense_default_(nn.Linear(b, b), generator)

    def _add_bn(self, name: str, feat: int) -> None:
        for leaf, fill in (("mean", 0.0), ("var", 1.0), ("scale", 1.0), ("bias", 0.0)):
            self.register_buffer(f"{name}_bn_{leaf}", torch.full((feat,), fill))

    def _bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return _frozen_bn(x, *(getattr(self, f"{name}_bn_{leaf}")
                               for leaf in ("mean", "var", "scale", "bias")))

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        x = poses.transpose(1, 2)  # [B, D, T]: the pose dims are the channels
        for i in range(3):
            x = nn.functional.leaky_relu(self._bn(getattr(self, f"conv{i}")(x), f"conv{i}"), 0.2)
        x = self.conv3(x).reshape(x.shape[0], -1)  # channel-major, as torch flattens
        x = self._bn(self.fc0(x), "fc0")  # LeakyReLU(True) is the identity
        x = self._bn(self.fc1(x), "fc1")
        return self.fc_mu(self.fc2(x))


class TedEmbeddingEncoder(PoseEmbeddingEncoder):
    def __init__(self, pose_dim: int = 27, n_frames: int = 34,
                 generator: Optional[torch.Generator] = None):
        super().__init__(pose_dim, n_frames, base=32, hidden_mults=(8, 4), generator=generator)


class BeatEmbeddingEncoder(PoseEmbeddingEncoder):
    def __init__(self, pose_dim: int = 282, n_frames: int = 34,
                 generator: Optional[torch.Generator] = None):
        super().__init__(pose_dim, n_frames, base=300, hidden_mults=(4, 2), generator=generator)
