"""TransMLP denoiser backbone (MLP-Mixer style) in PyTorch.

Port of ``livelyspeaker_tpu/models/mlp_backbone.py``. A stack of blocks, each
    x <- x + t_emb
    x <- x + act(token_mix(LN(x)))      # [S, S] over the sequence axis
    x <- x + act(channel_mix(LN(x)))    # Linear over the feature axis
with the sinusoidal-PE-table timestep embedding added at the input of every
block. Parameter names follow the Flax tree (``block_0.ln1``, ...), so
``utils/convert.py`` maps JAX params one to one. This eager stack is the
reference that the fused kernel (``ops/fused_mlp.py``) is held against.
``TransMLP(fused_vjp=True)`` runs the stack through the training kernel
(``ops/fused_mlp_train.py``) with the same parameters.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .initializers import dense_default_, lecun_normal_, xavier_uniform_
from .products import linear

__all__ = ["sinusoidal_table", "get_activation", "timestep_embedding", "mlp_block",
           "TimestepEmbedder", "MLPBlock", "TransMLP"]


def sinusoidal_table(
    max_len: int, d_model: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The transformer PE table, built in float64 and cast. The timestep
    embedding is a lookup ``pe[t]`` into it."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.tensor(pe, dtype=dtype)


LN_EPS = 1e-5  # both LayerNorms of a block
PE_MAX_LEN = 5000  # rows of the timestep embedding's PE table


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation, torch's to the exact erf
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "relu": F.relu,
    "lrelu01": lambda x: F.leaky_relu(x, 0.1),
    "lrelu02": lambda x: F.leaky_relu(x, 0.2),
    "lrelu": lambda x: F.leaky_relu(x, 0.01),
    "silu": F.silu,
    "gelu": _gelu_tanh,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name: relu, lrelu, lrelu01, lrelu02, silu, gelu."""
    return _ACTIVATIONS[name]


def timestep_embedding(pe: torch.Tensor, t: torch.Tensor, fc1_w: torch.Tensor,
                       fc1_b: torch.Tensor, fc2_w: torch.Tensor,
                       fc2_b: torch.Tensor) -> torch.Tensor:
    """``TimestepEmbedder``'s arithmetic on given weights: [B, 1, D]."""
    h = linear(F.silu(linear(pe[t].to(fc1_w.dtype), fc1_w, fc1_b)), fc2_w, fc2_b)
    return h[:, None, :]


def mlp_block(x: torch.Tensor, emb: Optional[torch.Tensor], ln1_w: torch.Tensor,
              ln1_b: torch.Tensor, token_w: torch.Tensor, token_b: torch.Tensor,
              ln2_w: torch.Tensor, ln2_b: torch.Tensor, ch_w: torch.Tensor,
              ch_b: torch.Tensor, act: Callable) -> torch.Tensor:
    """``MLPBlock``'s arithmetic on given weights (the channel mix in
    torch's [out, in] layout); the pipeline stages run it on stacked
    weights."""
    if emb is not None:
        x = x + emb
    d = x.shape[-1:]
    h = torch.einsum("ij,bjd->bid", token_w, F.layer_norm(x, d, ln1_w, ln1_b, LN_EPS))
    x = x + act(h + token_b[None, :, None])
    return x + act(linear(F.layer_norm(x, d, ln2_w, ln2_b, LN_EPS), ch_w, ch_b))


class TimestepEmbedder(nn.Module):
    """t -> PE-table lookup -> Linear/SiLU/Linear, returned as [B, 1, D]."""

    def __init__(self, latent_dim: int, max_len: int = PE_MAX_LEN,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.register_buffer(
            "pe", sinusoidal_table(max_len, latent_dim), persistent=False
        )
        self.fc1 = dense_default_(nn.Linear(latent_dim, latent_dim), generator)
        self.fc2 = dense_default_(nn.Linear(latent_dim, latent_dim), generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return timestep_embedding(self.pe, t, self.fc1.weight, self.fc1.bias,
                                  self.fc2.weight, self.fc2.bias)


class MLPBlock(nn.Module):
    """One mixer block."""

    def __init__(self, seq_len: int, dim: int, act: str = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(act)
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.token_mix_kernel = nn.Parameter(torch.empty(seq_len, seq_len))
        lecun_normal_(self.token_mix_kernel, seq_len, generator)
        self.token_mix_bias = nn.Parameter(torch.zeros(seq_len))
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.channel_mix = nn.Linear(dim, dim)
        # xavier-uniform with gain 1e-8: every block starts near the identity
        xavier_uniform_(self.channel_mix.weight, 1e-8, generator)
        nn.init.zeros_(self.channel_mix.bias)

    def forward(self, x: torch.Tensor,
                emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        return mlp_block(x, emb, self.ln1.weight, self.ln1.bias, self.token_mix_kernel,
                         self.token_mix_bias, self.ln2.weight, self.ln2.bias,
                         self.channel_mix.weight, self.channel_mix.bias, self.act)


class TransMLP(nn.Module):
    """Timestep embedding + ``num_layers`` mixer blocks.

    ``fused_vjp=True`` routes the blocks through ``fused_transmlp_train``
    (the training fast path: fused forward, hand-written backward, in f32;
    a bf16 stack is cast to f32 around it, as the JAX kernel does).
    The parameters and the state_dict are the same either way."""

    def __init__(self, seq_len: int = 35, num_layers: int = 8, dim: int = 512,
                 act: str = "silu", generator: Optional[torch.Generator] = None,
                 fused_vjp: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.act_name = act
        self.fused_vjp = fused_vjp
        self.embed_timestep = TimestepEmbedder(dim, generator=generator)
        for i in range(num_layers):
            self.add_module(
                f"block_{i}", MLPBlock(seq_len, dim, act, generator=generator)
            )

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        emb = self.embed_timestep(t)
        if self.fused_vjp:
            from ..ops.fused_mlp_train import (
                fused_transmlp_train,
                pack_transmlp_train_params,
            )

            return fused_transmlp_train(
                x, emb[:, 0], pack_transmlp_train_params(self), self.act_name)
        for blk in self.blocks():
            x = blk(x, emb)
        return x
