"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and skips
without a card. The file imports no JAX, so it also runs where JAX is
absent: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``.
"""

import ctypes

import pytest
import torch

from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
from livelyspeaker_tpu_torch.models.initializers import random_normal_
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train, fused_wav


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
    with pytest.raises(ValueError, match="S=40"):  # S above the kernel's 36
        big = fused_mlp.pack_transmlp_params(_stack(cuda_device, 40, 64, 1))
        fused_mlp.fused_transmlp(torch.zeros(2, 40, 64, device=cuda_device), emb, big)
    x = torch.zeros(2, 35, 64, device=cuda_device)
    # clusters the kernel refuses: not 1, 2, 4 or 8; D % 4N != 0; Dc > 128
    for cluster in (3, 16):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_mlp.launch_stack(x, emb, packed, 0, cluster=cluster)
    wide = fused_mlp.pack_transmlp_params(_stack(cuda_device, 35, 272, 1))
    with pytest.raises(RuntimeError, match="cudaError"):  # 272 % 32 != 0
        fused_mlp.launch_stack(torch.zeros(2, 35, 272, device=cuda_device),
                               torch.zeros(2, 272, device=cuda_device), wide, 0, cluster=8)
    with pytest.raises(RuntimeError, match="cudaError"):  # Dc = 272 > 128
        fused_mlp.launch_stack(torch.zeros(2, 35, 272, device=cuda_device),
                               torch.zeros(2, 272, device=cuda_device), wide, 0, cluster=1)
    assert fused_mlp.fused_transmlp_reference.calls == calls  # never the plain version


def _k1_case(device, b, seq, dim, layers, act="silu", fold=True, feats=27, seed=5):
    g = torch.Generator().manual_seed(seed)
    packed = fused_mlp.pack_transmlp_params(_stack(device, seq, dim, layers, act, seed),
                                            fold_ln2=fold)
    x = torch.randn(b, seq, dim, generator=g).to(device)
    emb = torch.randn(b, dim, generator=g).to(device)
    lin = random_normal_(torch.nn.Linear(dim, feats), g).to(device)
    return packed, x, emb, fused_mlp.pack_out_proj(lin)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 128, 512])
@pytest.mark.parametrize("seq", [10, 35, 36])
@pytest.mark.parametrize("b2", [1, 2, 3, 16, 17, 133, 512])
def test_kernel_cluster_batches(cuda_device, b2, seq, dim):
    """Ragged batches, clusters that do not fill the grid, every geometry
    transmlp_geometry picks at D in {64, 128, 512}; LN2 folded at odd
    batches and affine at even ones; with and without the pose
    projection. rel <= 1e-5 of max|plain|."""
    packed, x, emb, op = _k1_case(cuda_device, b2, seq, dim, 2, fold=b2 % 2 == 1)
    for proj in (None, op):
        launches = fused_mlp.fused_transmlp.launches
        out = fused_mlp.fused_transmlp(x, emb, packed, out_proj=proj)
        ref = fused_mlp.fused_transmlp_reference(x, emb, packed, out_proj=proj)
        torch.cuda.synchronize()
        assert fused_mlp.fused_transmlp.launches == launches + 1
        assert _rel(out, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dim,cluster", [
    (64, 8), (128, 8), (64, 2),                # Dc = 8, 16, 32: K-slices inside a warp
    (512, 1), (512, 2), (512, 4), (512, 8),    # Dc = 512, 256 refused below; 128, 64
    (48, 1), (208, 2),                         # Dc = 48, 104: K-slices with no rows
    (400, 4), (272, 4),                        # Dc = 100, 68: ring rows padded to 8s
])
def test_kernel_every_cluster_size(cuda_device, dim, cluster):
    """The kernel at clusters the geometry does not pick, as launch_stack
    takes them: each result within rel 1e-5 of the plain version, or a
    raise where the column slice exceeds the kernel's 128."""
    packed, x, emb, op = _k1_case(cuda_device, 5, 35, dim, 2, fold=False, feats=282)
    for proj in (None, op):
        if dim // cluster > 128:
            with pytest.raises(RuntimeError, match="cudaError"):
                fused_mlp.launch_stack(x, emb, packed, 0, proj, cluster=cluster)
            continue
        out = fused_mlp.launch_stack(x, emb, packed, 0, proj, cluster=cluster)
        ref = fused_mlp.fused_transmlp_reference(x, emb, packed, out_proj=proj)
        torch.cuda.synchronize()
        assert _rel(out, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["lrelu", "lrelu01", "lrelu02"])
def test_launch_stack_leaky_relu_unfolded(cuda_device, act):
    """The training route's no-grad calls: LN2 unfolded, no pose
    projection, the leaky-relu codes 3-5."""
    packed, x, emb, _ = _k1_case(cuda_device, 6, 35, 512, 3, act=act, fold=False)
    assert "ln2_scale" in packed
    out = fused_mlp.launch_stack(x, emb, packed, fused_mlp.KERNEL_ACT_CODES[act])
    ref = fused_mlp_train.fused_transmlp_train_forward_reference(x, emb, packed, act)[0]
    torch.cuda.synchronize()
    assert out.shape == x.shape
    assert _rel(out, ref) <= 1e-5


@pytest.mark.cuda
def test_kernel_repeat_gives_same_bits(cuda_device):
    """The K-split partials and the LN statistics are summed in a fixed
    order: two launches give the same bits."""
    packed, x, emb, op = _k1_case(cuda_device, 16, 35, 512, 8)
    for proj in (None, op):
        a = fused_mlp.fused_transmlp(x, emb, packed, out_proj=proj)
        b = fused_mlp.fused_transmlp(x, emb, packed, out_proj=proj)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_resident_clusters_from_the_card(cuda_device):
    """The wrapper asks the card how many clusters of each size it holds
    at once, and the geometry picks from those counts."""
    counts = fused_mlp.resident_clusters(512, cuda_device)
    assert set(counts) == {8, 4} and all(n > 0 for n in counts.values())
    assert counts[4] >= counts[8]
    geo = fused_mlp.transmlp_geometry(counts[8], 35, 512, counts)
    assert geo.cluster == 8
    assert fused_mlp.transmlp_geometry(counts[8] + 1, 35, 512, counts).cluster == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [16, 48, 64, 128, 272, 400, 512])
def test_geometry_shared_memory_matches_kernel(cuda_device, dim):
    """transmlp_geometry's shared-memory size is the kernel's own."""
    lib = fused_mlp.load_library("fused_transmlp")
    fn = lib.fused_transmlp_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    geo = fused_mlp.transmlp_geometry(16, 35, dim)
    assert fn(dim, geo.cluster) == geo.smem_bytes
    assert geo.smem_bytes <= fused_mlp.SMEM_LIMIT


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


def _wav_case(device, b, length, seed=4):
    """A seeded WavEncoder (random_normal_ weights), its packed parameters,
    a waveform and an output cotangent for the K3 kernels."""
    g = torch.Generator().manual_seed(seed)
    enc = random_normal_(WavEncoder(), g).to(device)
    wav = (0.1 * torch.randn(b, length, generator=g)).to(device)
    t4 = fused_wav.WavDims(length).T4
    cot = torch.randn(b, t4, 256, generator=g).to(device)
    return enc, fused_wav.pack_wav_params(enc, differentiable=False), wav, cot


@pytest.mark.cuda
@pytest.mark.parametrize("b,length", [
    (3, audio_samples_for_frames(2)),   # short clip, odd batch
    (5, 5000),                          # input times no window reaches
    (8, audio_samples_for_frames(34)),  # TED and BEAT: L = 36,267
])
def test_wav_kernels_match_plain(cuda_device, b, length):
    """Forward and residuals within rel 1e-5; d_wav and every weight and
    conv3 bias gradient within rel 1e-4 of its max; the pre-IN biases
    (0 in exact arithmetic) within 1e-4 of the largest gradient. The
    backward runs twice and gives the same bits."""
    _, packed, wav, cot = _wav_case(cuda_device, b, length)
    launches = dict(fused_wav.LAUNCHES)
    out, res = fused_wav.fused_wav_forward(wav, packed)
    ref, rres = fused_wav.fused_wav_forward_reference(wav, packed)
    d_wav, grads = fused_wav.fused_wav_backward(res, cot, packed)
    d_wav2, grads2 = fused_wav.fused_wav_backward(res, cot, packed)
    rd, rgrads = fused_wav.fused_wav_backward_reference(rres, cot, packed)
    torch.cuda.synchronize()
    for k, n in fused_wav.FORWARD_LAUNCHES.items():
        assert fused_wav.LAUNCHES[k] == launches[k] + n, k
    for k, n in fused_wav.BACKWARD_LAUNCHES.items():
        assert fused_wav.LAUNCHES[k] == launches[k] + 2 * n, k
    assert _rel(out, ref) <= 1e-5
    for name, a, r in zip(fused_wav.WavResiduals._fields, res, rres):
        assert _rel(a, r) <= 1e-5, name
    assert _rel(d_wav, rd) <= 1e-4
    assert torch.equal(d_wav, d_wav2)
    top = max(v.abs().max().item() for v in rgrads.values())
    for k in fused_wav.PACKED_KEYS:
        assert torch.equal(grads[k], grads2[k]), k
        if k in ("b0", "b1", "b2"):
            assert (grads[k] - rgrads[k]).abs().max().item() <= 1e-4 * top, k
        else:
            assert _rel(grads[k], rgrads[k]) <= 1e-4, k


@pytest.mark.cuda
def test_wav_function_routes_to_kernels(cuda_device):
    """Under autograd the drop-in launches the forward and backward kernels
    once each and no plain version; d_wav's kernel work is skipped unless
    the waveform needs a gradient; without autograd only the forward runs."""
    enc, _, wav, _ = _wav_case(cuda_device, 4, audio_samples_for_frames(34))
    drop_in = fused_wav.FusedWavEncoder(enc)
    calls = (fused_wav.fused_wav_forward_reference.calls,
             fused_wav.fused_wav_backward_reference.calls)
    launches = dict(fused_wav.LAUNCHES)
    out = drop_in(wav)
    out.square().sum().backward()
    x = wav.clone().requires_grad_(True)
    drop_in(x).square().sum().backward()
    with torch.no_grad():
        out2 = drop_in(wav)
    torch.cuda.synchronize()
    for k, n in fused_wav.FORWARD_LAUNCHES.items():
        assert fused_wav.LAUNCHES[k] == launches[k] + 3 * n, k
    for k, n in fused_wav.BACKWARD_LAUNCHES.items():
        assert fused_wav.LAUNCHES[k] == launches[k] + 2 * n, k
    assert (fused_wav.fused_wav_forward_reference.calls,
            fused_wav.fused_wav_backward_reference.calls) == calls
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in enc.parameters())
    assert torch.equal(out2, out.detach())
    eager = enc(wav)
    assert _rel(out2, eager) <= 1e-5


@pytest.mark.cuda
def test_wav_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    """A CPU/CUDA mix, a bf16 or float64 waveform, a waveform of no samples
    (the shortest real input: conv0's padding leaves T4 >= 1 for any length
    >= 0, so WavDims' own raise is held on the CPU) and a bf16 encoder."""
    enc, packed, wav, _ = _wav_case(cuda_device, 2, audio_samples_for_frames(2))
    calls = fused_wav.fused_wav_forward_reference.calls
    with pytest.raises(ValueError, match="cpu"):
        fused_wav.fused_wav_encoder(wav, {k: v.cpu() for k, v in packed.items()})
    with pytest.raises(TypeError, match="f32"):
        fused_wav.fused_wav_encoder(wav.to(torch.bfloat16), packed)
    with pytest.raises(TypeError, match="f32"):
        fused_wav.fused_wav_forward(wav.double(), packed)
    with pytest.raises(ValueError, match="at least one sample"):
        fused_wav.fused_wav_encoder(wav[:, :0], packed)
    with pytest.raises(ValueError, match="expected"):
        fused_wav.fused_wav_encoder(wav[None], packed)
    with pytest.raises(TypeError, match="f32"):
        fused_wav.FusedWavEncoder(WavEncoder(dtype=torch.bfloat16).to(cuda_device))
    assert fused_wav.fused_wav_forward_reference.calls == calls
