"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and skips
without a card. The file imports no JAX, so it also runs where JAX is
absent: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``.
"""

import pytest
import torch

from livelyspeaker_tpu_torch.models.initializers import random_normal_
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train


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


def _train_case(device, seq, dim, layers, b, act="silu", seed=3):
    """Packed weights, inputs and an output cotangent for the training kernels."""
    g = torch.Generator().manual_seed(seed)
    packed = {k: v.detach().contiguous() for k, v in
              fused_mlp_train.pack_transmlp_train_params(
                  _stack(device, seq, dim, layers, act, seed)).items()}
    x = torch.randn(b, seq, dim, generator=g).to(device)
    emb = torch.randn(b, dim, generator=g).to(device)
    cot = torch.randn(b, seq, dim, generator=g).to(device)
    return packed, x, emb, cot


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("seq,dim,layers,b,act", [
    (35, 512, 8, 64, "silu"),     # TED
    (36, 512, 8, 64, "silu"),     # BEAT
    (10, 64, 2, 5, "relu"),       # ragged batch, narrow width
    (35, 128, 2, 3, "lrelu02"),
])
def test_train_kernels_match_plain(cuda_device, seq, dim, layers, b, act):
    """Forward and stash within rel 1e-5, every gradient within rel 1e-4 of
    its max: f32 sums over B*S rows in another order."""
    packed, x, emb, cot = _train_case(cuda_device, seq, dim, layers, b, act)
    launches = dict(fused_mlp_train.LAUNCHES)
    out, stash = fused_mlp_train.fused_transmlp_train_forward(x, emb, packed, act)
    ref, ref_stash = fused_mlp_train.fused_transmlp_train_forward_reference(x, emb, packed, act)
    gx, gemb, grads = fused_mlp_train.fused_transmlp_train_backward(stash, emb, cot, packed, act)
    rgx, rgemb, rgrads = fused_mlp_train.fused_transmlp_train_backward_reference(
        ref_stash, emb, cot, packed, act)
    torch.cuda.synchronize()
    assert fused_mlp_train.LAUNCHES["fwd"] == launches["fwd"] + 1
    for k in ("bwd_block", "wgrad", "reduce"):
        assert fused_mlp_train.LAUNCHES[k] == launches[k] + layers
    assert _rel(out, ref) <= 1e-5
    assert _rel(stash, ref_stash) <= 1e-5
    assert _rel(gx, rgx) <= 1e-4
    assert _rel(gemb, rgemb) <= 1e-4
    for k in fused_mlp_train.PACKED_KEYS:
        assert _rel(grads[k], rgrads[k]) <= 1e-4, k


@pytest.mark.cuda
def test_train_function_routes_to_kernels(cuda_device):
    """Under autograd the Function launches the training kernels; under
    no_grad it launches K1 without a stash; the plain versions never run."""
    packed, x, emb, cot = _train_case(cuda_device, 35, 128, 2, 4)
    params = [v.clone().requires_grad_(True) for v in packed.values()]
    fwd_calls = fused_mlp_train.fused_transmlp_train_forward_reference.calls
    bwd_calls = fused_mlp_train.fused_transmlp_train_backward_reference.calls
    launches = dict(fused_mlp_train.LAUNCHES)
    k1 = fused_mlp.fused_transmlp.launches
    out = fused_mlp_train.fused_transmlp_train(
        x, emb, dict(zip(fused_mlp_train.PACKED_KEYS, params)))
    (out * cot).sum().backward()
    with torch.no_grad():
        out2 = fused_mlp_train.fused_transmlp_train(x, emb, packed)
    torch.cuda.synchronize()
    assert fused_mlp_train.LAUNCHES["fwd"] == launches["fwd"] + 1
    assert fused_mlp_train.LAUNCHES["reduce"] == launches["reduce"] + 2
    assert fused_mlp.fused_transmlp.launches == k1 + 1
    assert fused_mlp_train.fused_transmlp_train_forward_reference.calls == fwd_calls
    assert fused_mlp_train.fused_transmlp_train_backward_reference.calls == bwd_calls
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params)
    assert _rel(out2, out.detach()) <= 1e-5


@pytest.mark.cuda
def test_train_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    packed, x, emb, cot = _train_case(cuda_device, 35, 64, 1, 2)
    calls = fused_mlp_train.fused_transmlp_train_forward_reference.calls
    fwd = fused_mlp_train.fused_transmlp_train_forward
    with pytest.raises(TypeError, match="f32"):
        fused_mlp_train.fused_transmlp_train(x.to(torch.bfloat16), emb, packed)
    with pytest.raises(TypeError, match="f32"):
        fwd(x.to(torch.bfloat16), emb, packed)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(x.transpose(1, 2).contiguous().transpose(1, 2), emb, packed)
    with pytest.raises(ValueError, match="gelu"):
        fwd(x, emb, packed, "gelu")
    with pytest.raises(ValueError, match="gelu"):
        fused_mlp_train.fused_transmlp_train(x, emb, packed, "gelu")
    big, xb, eb, _ = _train_case(cuda_device, 40, 64, 1, 2)
    with pytest.raises(RuntimeError, match="cudaError"):  # S above the kernel's 36
        fwd(xb, eb, big)
    _, stash = fwd(x, emb, packed)
    with pytest.raises(RuntimeError, match="cudaError"):
        fused_mlp_train.fused_transmlp_train_backward(
            torch.zeros(1, 2, 40, 64, device=cuda_device), eb, xb.contiguous(), big)
    assert fused_mlp_train.fused_transmlp_train_forward_reference.calls == calls
