"""The CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and skips
without a card. The file imports no JAX, so it also runs where JAX is
absent: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``.
"""

import pytest
import torch

from livelyspeaker_tpu_torch.models.initializers import random_normal_
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
from livelyspeaker_tpu_torch.ops import fused_mlp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stack(device, seq, dim, layers, act="silu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return random_normal_(TransMLP(seq, layers, dim, act), g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,feats", [(35, 27), (36, 282)])
@pytest.mark.parametrize("fold_ln2", [False, True])
@pytest.mark.parametrize("act", ["silu", "relu", "gelu"])
def test_kernel_matches_plain(cuda_device, seq, feats, fold_ln2, act):
    dim, layers, b = 512, 8, 16
    g = torch.Generator().manual_seed(1)
    packed = fused_mlp.pack_transmlp_params(_stack(cuda_device, seq, dim, layers, act),
                                            fold_ln2=fold_ln2)
    x = torch.randn(b, seq, dim, generator=g).to(cuda_device)
    emb = torch.randn(b, dim, generator=g).to(cuda_device)
    lin = random_normal_(torch.nn.Linear(dim, feats), g).to(cuda_device)
    for op in (None, fused_mlp.pack_out_proj(lin)):
        launches = fused_mlp.fused_transmlp.launches
        out = fused_mlp.fused_transmlp(x, emb, packed, act, out_proj=op)
        ref = fused_mlp.fused_transmlp_reference(x, emb, packed, act, out_proj=op)
        torch.cuda.synchronize()
        assert fused_mlp.fused_transmlp.launches == launches + 1
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-5, rel


@pytest.mark.cuda
def test_kernel_ragged_small_width(cuda_device):
    """An odd batch and a narrow stack (D=64, S=10)."""
    g = torch.Generator().manual_seed(2)
    packed = fused_mlp.pack_transmlp_params(_stack(cuda_device, 10, 64, 2), fold_ln2=True)
    x = torch.randn(3, 10, 64, generator=g).to(cuda_device)
    emb = torch.randn(3, 1, 64, generator=g).to(cuda_device)
    out = fused_mlp.fused_transmlp(x, emb, packed)
    ref = fused_mlp.fused_transmlp_reference(x, emb, packed)
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    packed = fused_mlp.pack_transmlp_params(_stack(cuda_device, 35, 64, 1))
    emb = torch.zeros(2, 64, device=cuda_device)
    calls = fused_mlp.fused_transmlp_reference.calls
    with pytest.raises(TypeError, match="f32"):
        fused_mlp.fused_transmlp(
            torch.zeros(2, 35, 64, device=cuda_device, dtype=torch.bfloat16), emb, packed)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.fused_transmlp(
            torch.zeros(2, 64, 35, device=cuda_device).transpose(1, 2), emb, packed)
    with pytest.raises(ValueError, match="lrelu"):
        fused_mlp.fused_transmlp(torch.zeros(2, 35, 64, device=cuda_device), emb, packed,
                                 "lrelu")
    with pytest.raises(RuntimeError, match="cudaError"):  # S above the kernel's 36
        big = fused_mlp.pack_transmlp_params(_stack(cuda_device, 40, 64, 1))
        fused_mlp.fused_transmlp(torch.zeros(2, 40, 64, device=cuda_device), emb, big)
    assert fused_mlp.fused_transmlp_reference.calls == calls  # never the plain version
