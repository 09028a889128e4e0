"""Evaluation embedding networks (TED FGD / BEAT FID) and the gesture
autoencoder that trains one, in PyTorch.

Port of ``livelyspeaker_tpu/models/embedding_net.py``:

- TED: the TriModal gesture-autoencoder's encoder the FGD evaluator uses
  (``PoseEncoderConv``); out_net widths 8x and 4x base;
- BEAT: HalfEmbeddingNet's ``PoseEncoderConv`` (base 300, 282 pose dims);
  out_net widths 4x and 2x base;
- the decoders (``PoseEmbeddingDecoder``, the reference's
  ``PoseDecoderConv``; ``PoseDecoderFC``; ``PoseDecoderGRU``) and
  ``GestureAutoencoder``, the encoder with trainable BatchNorm and the conv
  decoder, which ``scripts/train_gesture_autoencoder.py`` trains into an
  FGD/FID fixture.

The frozen encoders run BatchNorm in inference mode on stored statistics,
kept as buffers. With ``trainable_bn=True`` (the autoencoder) each BatchNorm
is a :class:`BatchNorm`, which is Flax's ``nn.BatchNorm``: momentum 0.99 on
the running statistics, the biased batch variance E[x^2] - E[x]^2, the
running statistics in train mode's place in eval mode (``.eval()``).

Names follow the Flax tree (``conv0``, ``conv0_bn_mean``, ``fc_mu``,
``decoder.deconv0``, ...), so ``utils.convert.jax_params_to_state_dict``
carries the frozen encoders' parameters over and
``utils.convert.flax_variables_to_state_dict`` the autoencoder's and the
decoders' (params and batch_stats, ConvTranspose and GRU weights re-laid
out); ``utils.convert.pose_embedding_state_dict_from_torch`` maps the
reference's checkpoint layout.

Kept from the reference: its ``nn.LeakyReLU(True)`` inside ``out_net``
passes ``True`` as ``negative_slope`` (1.0), so those activations are
identities and are left out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .initializers import conv_default_, dense_default_, lecun_normal_

__all__ = ["BatchNorm", "PoseEmbeddingEncoder", "TedEmbeddingEncoder", "BeatEmbeddingEncoder",
           "PoseEmbeddingDecoder", "PoseDecoderFC", "PoseDecoderGRU", "GestureAutoencoder"]


def _frozen_bn(x: torch.Tensor, mean, var, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over the channel axis (dim 1) from stored stats."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = 1.0 / torch.sqrt(var + eps)
    return ((x - mean.view(shape)) * inv.view(shape) * scale.view(shape)
            + bias.view(shape))


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` (its defaults) over the channel axis, dim 1.

    In train mode it normalises with the batch's mean and biased variance,
    ``max(E[x^2] - E[x]^2, 0)`` over every axis but dim 1, and moves the
    running statistics as ``running = 0.99 * running + 0.01 * batch`` (the
    biased variance too); in eval mode it normalises with the running
    statistics. ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``, in
    Flax's order. ``weight`` is Flax's ``scale``; ``mean`` and ``var`` are
    its ``batch_stats``."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = [0] + list(range(2, x.ndim))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class PoseEmbeddingEncoder(nn.Module):
    """poses [B, T, D] -> base-dim embedding (``PoseEncoderConv`` without the
    variational head: returns ``fc_mu(out)``).

    ``trainable_bn=False``: BatchNorm on frozen statistics, stored as the
    buffers ``<name>_bn_{mean,var,scale,bias}`` (the converted evaluators).
    ``trainable_bn=True``: a :class:`BatchNorm` module ``<name>_bn`` each,
    trained with the autoencoder."""

    def __init__(self, pose_dim: int = 27, n_frames: int = 34, base: int = 32,
                 hidden_mults: Tuple[int, int] = (8, 4),
                 generator: Optional[torch.Generator] = None, trainable_bn: bool = False):
        super().__init__()
        self.pose_dim, self.n_frames, self.base = pose_dim, n_frames, base
        self.trainable_bn = trainable_bn
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
        if self.trainable_bn:
            setattr(self, f"{name}_bn", BatchNorm(feat))
            return
        for leaf, fill in (("mean", 0.0), ("var", 1.0), ("scale", 1.0), ("bias", 0.0)):
            self.register_buffer(f"{name}_bn_{leaf}", torch.full((feat,), fill))

    def _bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.trainable_bn:
            return getattr(self, f"{name}_bn")(x)
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


def _conv_transpose(c_in: int, c_out: int, k: int,
                    generator: Optional[torch.Generator]) -> nn.ConvTranspose1d:
    """Flax ``ConvTranspose`` defaults: lecun-normal over fan_in = k * in,
    zero bias."""
    layer = nn.ConvTranspose1d(c_in, c_out, k)
    lecun_normal_(layer.weight, c_in * k, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class PoseEmbeddingDecoder(nn.Module):
    """latent [B, base] -> poses [B, T, D] (``PoseDecoderConv``,
    embedding_net.py:164-216 / motion_autoencoder.py:76-131): the 34-frame
    pre-net (Linear, BatchNorm, Linear), two transposed convs each with
    BatchNorm and LeakyReLU(0.2), then two convs.

    The deconvs are torch's ``ConvTranspose1d``; Flax's ``ConvTranspose``
    (VALID, ``transpose_kernel=False``) does not flip its kernel, so its
    weights carry over with the tap axis flipped
    (``utils.convert.flax_variables_to_state_dict``)."""

    def __init__(self, pose_dim: int = 27, n_frames: int = 34, base: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pose_dim, self.n_frames, self.base = pose_dim, n_frames, base
        b = base
        self.decoder_size = max(b // 8, 4)
        self.pre0 = dense_default_(nn.Linear(b, 2 * b), generator)
        self.pre_bn = BatchNorm(2 * b)
        self.pre1 = dense_default_(nn.Linear(2 * b, self.decoder_size * n_frames), generator)
        self.deconv0 = _conv_transpose(self.decoder_size, b, 3, generator)
        self.bn0 = BatchNorm(b)
        self.deconv1 = _conv_transpose(b, b, 3, generator)
        self.bn1 = BatchNorm(b)
        self.conv0 = conv_default_(nn.Conv1d(b, 2 * b, 3), generator)
        self.conv1 = conv_default_(nn.Conv1d(2 * b, pose_dim, 3), generator)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        h = self.pre1(self.pre_bn(self.pre0(feat)))
        h = h.reshape(feat.shape[0], self.n_frames, self.decoder_size).transpose(1, 2)
        h = nn.functional.leaky_relu(self.bn0(self.deconv0(h)), 0.2)
        h = nn.functional.leaky_relu(self.bn1(self.deconv1(h)), 0.2)
        return self.conv1(self.conv0(h)).transpose(1, 2)


def _add_seed_pose_net(module: nn.Module, n_pre_poses: int, pose_dim: int,
                       generator: Optional[torch.Generator]) -> None:
    """The decoders' seed-pose pre-net, as ``pre0``, ``pre_bn``, ``pre1``:
    Linear, BatchNorm, ReLU, Linear, to 32 features."""
    module.pre0 = dense_default_(nn.Linear(n_pre_poses * pose_dim, 32), generator)
    module.pre_bn = BatchNorm(32)
    module.pre1 = dense_default_(nn.Linear(32, 32), generator)


def _seed_features(module: nn.Module, pre_poses: torch.Tensor) -> torch.Tensor:
    h = module.pre0(pre_poses.reshape(pre_poses.shape[0], -1))
    return module.pre1(torch.relu(module.pre_bn(h)))


class PoseDecoderFC(nn.Module):
    """Fully-connected decoder (embedding_net.py:84-126): the latent
    (optionally after 32 features of the seed poses) -> [B, T, D] through
    Linear, BatchNorm, ReLU at widths 128, 128, 256, 512. ``latent_dim`` and
    ``n_pre_poses`` fix the input widths Flax infers at init."""

    def __init__(self, gen_length: int = 34, pose_dim: int = 27, use_pre_poses: bool = False,
                 latent_dim: int = 32, n_pre_poses: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_pre_poses:
            _add_seed_pose_net(self, n_pre_poses, pose_dim, generator)
        self.gen_length, self.pose_dim, self.use_pre_poses = gen_length, pose_dim, use_pre_poses
        width = latent_dim + (32 if use_pre_poses else 0)
        for i, w in enumerate((128, 128, 256, 512)):
            setattr(self, f"fc{i}", dense_default_(nn.Linear(width, w), generator))
            setattr(self, f"bn{i}", BatchNorm(w))
            width = w
        self.out = dense_default_(nn.Linear(width, gen_length * pose_dim), generator)

    def forward(self, latent: torch.Tensor,
                pre_poses: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat = latent
        if self.use_pre_poses:
            feat = torch.cat([_seed_features(self, pre_poses), latent], dim=1)
        for i in range(4):
            feat = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(feat)))
        return self.out(feat).reshape(-1, self.gen_length, self.pose_dim)


class PoseDecoderGRU(nn.Module):
    """Bidirectional-GRU decoder (embedding_net.py:129-161): the seed poses'
    32 features and the latent, repeated over time, through a
    ``num_layers``-layer bidirectional GRU whose two directions are summed,
    then Linear, LeakyReLU(0.01), Linear.

    Flax's ``GRUCell`` has biases on the input side of r, z and n and on the
    hidden side of n only: here ``bias_hh``'s r and z thirds are zero and a
    gradient hook keeps them so (their gradient is masked to 0)."""

    def __init__(self, gen_length: int = 34, pose_dim: int = 27, hidden: int = 300,
                 num_layers: int = 4, latent_dim: int = 32, n_pre_poses: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _add_seed_pose_net(self, n_pre_poses, pose_dim, generator)
        self.gen_length, self.hidden = gen_length, hidden
        self.gru = nn.GRU(32 + latent_dim, hidden, num_layers, batch_first=True,
                          bidirectional=True)
        mask = torch.ones(3 * hidden)
        mask[: 2 * hidden] = 0.0
        self.register_buffer("_hh_bias_mask", mask, persistent=False)
        with torch.no_grad():
            for name, p in self.gru.named_parameters():
                if name.startswith("weight_ih"):  # Flax: lecun-normal input kernels
                    for gate in p.view(3, hidden, -1):
                        lecun_normal_(gate, gate.shape[1], generator)
                elif name.startswith("weight_hh"):  # Flax: orthogonal recurrent kernels
                    for gate in p.view(3, hidden, hidden):
                        nn.init.orthogonal_(gate, generator=generator)
                else:
                    p.zero_()
                if name.startswith("bias_hh"):
                    p.register_hook(lambda g: g * self._hh_bias_mask)
        self.out0 = dense_default_(nn.Linear(hidden, hidden // 2), generator)
        self.out1 = dense_default_(nn.Linear(hidden // 2, pose_dim), generator)

    def forward(self, latent: torch.Tensor, pre_poses: torch.Tensor) -> torch.Tensor:
        feat = torch.cat([_seed_features(self, pre_poses), latent], dim=1)
        x, _ = self.gru(feat[:, None, :].expand(-1, self.gen_length, -1).contiguous())
        x = x[..., : self.hidden] + x[..., self.hidden:]
        return self.out1(nn.functional.leaky_relu(self.out0(x), 0.01))


class GestureAutoencoder(nn.Module):
    """Trainable gesture autoencoder (EmbeddingNet, embedding_net.py:261-275)
    for making FGD/FID evaluation fixtures: ``forward(poses [B, T, D])``
    returns ``(feat [B, base], recon [B, T, D])``; BatchNorm follows the
    module's mode (``.train()`` / ``.eval()``)."""

    def __init__(self, pose_dim: int = 27, n_frames: int = 34, base: int = 32,
                 hidden_mults: Tuple[int, int] = (8, 4),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = PoseEmbeddingEncoder(pose_dim, n_frames, base, hidden_mults, generator,
                                            trainable_bn=True)
        self.decoder = PoseEmbeddingDecoder(pose_dim, n_frames, base, generator)

    def forward(self, poses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.encoder(poses)
        return feat, self.decoder(feat)

    def embed(self, poses: torch.Tensor) -> torch.Tensor:
        """The embedding on the running statistics, as Flax's ``embed``,
        whatever the module's mode."""
        mode = self.encoder.training
        self.encoder.eval()
        try:
            return self.encoder(poses)
        finally:
            self.encoder.train(mode)
