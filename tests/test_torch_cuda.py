"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and skips
without a card. The file imports no JAX, so it also runs where JAX is
absent: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.data import loader
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


BF16_TOL = 2.0 ** -6  # bf16 kernel against its plain version, relative to max|plain|


def _k1_bf16_case(device, b, seq, dim, layers, act="silu", fold=True, feats=27, seed=7):
    g = torch.Generator().manual_seed(seed)
    stack = _stack(device, seq, dim, layers, act, seed)
    lin = random_normal_(torch.nn.Linear(dim, feats), g).to(device)
    x = torch.randn(b, seq, dim, generator=g).to(device)
    emb = torch.randn(b, dim, generator=g).to(device)
    return (fused_mlp.pack_transmlp_params(stack, fold_ln2=fold, dtype=torch.bfloat16),
            x.bfloat16(), emb.bfloat16(), fused_mlp.pack_out_proj(lin, dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,seq,dim,layers,feats", [
    (16, 35, 512, 8, 27), (16, 36, 512, 8, 282), (3, 10, 64, 2, 5), (5, 20, 48, 2, 9),
    (2, 36, 16, 1, 3), (1, 1, 32, 1, 1), (133, 17, 272, 2, 512)])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bf16_kernel_matches_plain(cuda_device, b, seq, dim, layers, feats, fold, act):
    """The bf16 kernel against the plain bf16 version on the same inputs:
    max|kernel - plain| <= 2^-6 max|plain| (a few bf16 ulps of max|y|: sums
    taken in another order move single roundings, which later blocks carry);
    bf16 out, one launch counted, the plain version not run by the wrapper."""
    packed, x, emb, op = _k1_bf16_case(cuda_device, b, seq, dim, layers, act, fold, feats)
    for proj in (None, op):
        launches = fused_mlp.fused_transmlp.bf16_launches
        calls = fused_mlp.fused_transmlp_reference.calls
        out = fused_mlp.fused_transmlp(x, emb, packed, act, out_proj=proj)
        assert fused_mlp.fused_transmlp.bf16_launches == launches + 1
        assert fused_mlp.fused_transmlp_reference.calls == calls
        ref = fused_mlp.fused_transmlp_reference(x, emb, packed, act, out_proj=proj)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        assert _rel(out.float(), ref.float()) <= BF16_TOL


@pytest.mark.cuda
def test_bf16_kernel_repeat_gives_same_bits_and_launch_stack_routes(cuda_device):
    packed, x, emb, op = _k1_bf16_case(cuda_device, 16, 35, 512, 8)
    a = fused_mlp.fused_transmlp(x, emb, packed, out_proj=op)
    b = fused_mlp.launch_stack(x, emb, packed, 0, op)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    packed, x, emb, op = _k1_bf16_case(cuda_device, 2, 35, 64, 1)
    calls = fused_mlp.fused_transmlp_reference.calls
    launches = fused_mlp.fused_transmlp.bf16_launches
    with pytest.raises(TypeError, match="emb is torch.float32"):
        fused_mlp.fused_transmlp(x, emb.float(), packed)
    with pytest.raises(TypeError, match="x is torch.float16"):
        fused_mlp.fused_transmlp(x.half(), emb.half(), packed)
    with pytest.raises(TypeError, match="token_w is torch.bfloat16"):
        fused_mlp.fused_transmlp(x.float(), emb.float(), packed)
    with pytest.raises(TypeError, match="ch_b is torch.bfloat16"):
        fused_mlp.launch_stack(x, emb, {**packed, "ch_b": packed["ch_b"].bfloat16()}, 0)
    with pytest.raises(ValueError, match="cluster"):
        fused_mlp.launch_stack(x, emb, packed, 0, cluster=4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.fused_transmlp(x.transpose(0, 1).contiguous().transpose(0, 1), emb, packed)
    shifted = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mlp.fused_transmlp(shifted.view(x.shape), emb, packed)
    with pytest.raises(ValueError, match="S=40"):
        big, xb, eb, _ = _k1_bf16_case(cuda_device, 2, 40, 64, 1)
        fused_mlp.fused_transmlp(xb, eb, big)
    with pytest.raises(ValueError, match="D=520"):
        wide, xw, ew, _ = _k1_bf16_case(cuda_device, 2, 35, 520, 1)
        fused_mlp.fused_transmlp(xw, ew, wide)
    _, _, _, too_many = _k1_bf16_case(cuda_device, 2, 35, 64, 1, feats=513)
    with pytest.raises(ValueError, match="F=513"):
        fused_mlp.fused_transmlp(x, emb, packed, out_proj=too_many)
    assert fused_mlp.fused_transmlp_reference.calls == calls  # never the plain version
    assert fused_mlp.fused_transmlp.bf16_launches == launches


@pytest.mark.cuda
def test_train_kernels_refuse_bf16(cuda_device):
    """K2's and K3's kernel entries stay f32: the JAX package has no bf16
    training kernel."""
    packed, x, emb, _ = _k1_bf16_case(cuda_device, 2, 35, 64, 1, fold=False)
    with pytest.raises(TypeError, match="f32"):
        fused_mlp_train.fused_transmlp_train_forward(x, emb, packed, "silu")


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


def _clear_of_kinks(packed, x, emb, act, margin=1e-6):
    """Per sequence: whether every pre-activation of the plain forward lies
    farther from 0 than ``margin`` of the largest one."""
    fn, _ = fused_mlp_train._act_pair(act)
    b, _, d = x.shape
    ok = torch.ones(b, dtype=torch.bool, device=x.device)
    for l in range(packed["token_w"].shape[0]):
        rec = fused_mlp_train._block_recompute(x, emb.reshape(b, 1, d), l, packed, fn)
        r1, m1, m2 = rec[5], rec[4], rec[9]
        for m in (m1, m2):
            ok &= m.abs().flatten(1).min(1).values > margin * m.abs().max()
        x = r1 + fn(m2)
    return ok


def _train_case(device, seq, dim, layers, b, act="silu", seed=3):
    """Packed weights, inputs and an output cotangent for the training kernels.

    The derivative of relu and of the leaky relus jumps at 0, so two f32
    forwards that round a pre-activation next to 0 to different sides
    (the kernel's and the plain version's sums run in different orders)
    disagree on that sequence's whole gradient: on an H100, 1 to 4 sequences
    of 512 at D=512. For those activations every sequence with a
    pre-activation within 1e-6 of the largest is replaced by a copy of one
    that has none (its cotangent stays its own), so that the comparison is
    well-conditioned at the stated tolerance."""
    g = torch.Generator().manual_seed(seed)
    packed = {k: v.detach().contiguous() for k, v in
              fused_mlp_train.pack_transmlp_train_params(
                  _stack(device, seq, dim, layers, act, seed)).items()}
    while True:
        x = torch.randn(b, seq, dim, generator=g).to(device)
        emb = torch.randn(b, dim, generator=g).to(device)
        cot = torch.randn(b, seq, dim, generator=g).to(device)
        if act == "silu":
            break
        ok = _clear_of_kinks(packed, x, emb, act)
        if ok.any():  # else draw again
            good = int(ok.nonzero()[0])
            x[~ok], emb[~ok] = x[good].clone(), emb[good].clone()
            break
    return packed, x, emb, cot


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _train_kernels_against_plain(device, seq, dim, layers, b, act, cluster=None):
    """Forward and stash within rel 1e-5, every gradient within rel 1e-4 of
    its max (f32 sums over B*S rows in another order); the launch counts."""
    packed, x, emb, cot = _train_case(device, seq, dim, layers, b, act)
    launches = dict(fused_mlp_train.LAUNCHES)
    k1 = fused_mlp.fused_transmlp.launches
    out, stash = fused_mlp_train.fused_transmlp_train_forward(x, emb, packed, act, cluster)
    ref, ref_stash = fused_mlp_train.fused_transmlp_train_forward_reference(x, emb, packed, act)
    gx, gemb, grads = fused_mlp_train.fused_transmlp_train_backward(
        stash, emb, cot, packed, act, cluster)
    rgx, rgemb, rgrads = fused_mlp_train.fused_transmlp_train_backward_reference(
        ref_stash, emb, cot, packed, act)
    torch.cuda.synchronize()
    assert fused_mlp_train.LAUNCHES["fwd"] == launches["fwd"] + 1
    assert fused_mlp.fused_transmlp.launches == k1  # the stash forward is not a K1 call
    for k in ("bwd_block", "wgrad", "reduce"):
        assert fused_mlp_train.LAUNCHES[k] == launches[k] + layers
    assert _rel(out, ref) <= 1e-5
    assert _rel(stash, ref_stash) <= 1e-5
    assert _rel(gx, rgx) <= 1e-4
    assert _rel(gemb, rgemb) <= 1e-4
    for k in fused_mlp_train.PACKED_KEYS:
        assert _rel(grads[k], rgrads[k]) <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("seq,dim,layers,b,act", [
    (35, 512, 8, 64, "silu"),     # TED
    (36, 512, 8, 64, "silu"),     # BEAT
    (10, 64, 2, 5, "relu"),       # ragged batch, narrow width
    (35, 128, 2, 3, "lrelu02"),
])
def test_train_kernels_match_plain(cuda_device, seq, dim, layers, b, act):
    _train_kernels_against_plain(cuda_device, seq, dim, layers, b, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 128, 512])
@pytest.mark.parametrize("seq", [10, 35, 36])
@pytest.mark.parametrize("b", [1, 3, 17, 133, 512])
def test_train_kernels_cluster_batches(cuda_device, b, seq, dim):
    """Ragged batches and every geometry the forward's and the backward's
    geometry functions pick at D in {64, 128, 512}; the training
    activations take turns."""
    acts = fused_mlp_train.TRAIN_ACTIVATIONS
    act = acts[(b + seq + dim // 64) % len(acts)]
    _train_kernels_against_plain(cuda_device, seq, dim, 2, b, act)


@pytest.mark.cuda
@pytest.mark.parametrize("act", fused_mlp_train.TRAIN_ACTIVATIONS)
@pytest.mark.parametrize("dim,cluster", [
    (64, 1), (64, 2), (64, 8), (128, 1), (128, 2), (128, 8), (512, 4), (512, 8),
    (48, 1), (208, 2), (400, 4), (272, 4),  # K-slices with no rows; ring rows padded to 8s
])
def test_train_kernels_every_cluster_size(cuda_device, dim, cluster, act):
    """Both kernels at every cluster size they take, forced: those the
    geometry picks at some batch and those it does not."""
    _train_kernels_against_plain(cuda_device, 35, dim, 2, 5, act, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,dim,b", [(35, 512, 64), (36, 512, 7), (10, 64, 5), (35, 128, 20)])
def test_train_kernels_repeat_gives_same_bits(cuda_device, seq, dim, b):
    """No atomics: the exchanged row sums, the cluster's d token_w slices
    and the batch reductions are all added in a fixed order, so two runs
    give the same bits in the output, the stash and every gradient."""
    packed, x, emb, cot = _train_case(cuda_device, seq, dim, 3, b)
    runs = []
    for _ in range(2):
        out, stash = fused_mlp_train.fused_transmlp_train_forward(x, emb, packed)
        gx, gemb, grads = fused_mlp_train.fused_transmlp_train_backward(stash, emb, cot, packed)
        runs.append({"out": out, "stash": stash, "dx": gx, "d_emb": gemb, **grads})
    torch.cuda.synchronize()
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [16, 48, 64, 128, 272, 400, 512])
def test_backward_geometry_matches_kernel(cuda_device, dim):
    """backward_geometry's shared-memory size is the block kernel's own, and
    the card reports how many of its clusters it holds at once."""
    lib = fused_mlp_train.load_library("fused_transmlp_train")
    fn = lib.fused_transmlp_train_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    counts = fused_mlp_train.backward_resident_clusters(dim, cuda_device)
    assert set(counts) == set(fused_mlp.cluster_sizes(dim)) and all(n > 0 for n in counts.values())
    for b in (1, 16, 512):
        geo = fused_mlp_train.backward_geometry(b, 35, dim, counts)
        assert fn(dim, geo.cluster) == geo.smem_bytes
        assert geo.smem_bytes <= fused_mlp.SMEM_LIMIT


WGRAD_DIMS = [16, 48, 64, 128, 208, 272, 400, 512]
WGRAD_TOL = 2e-6  # 3xTF32 is f32-accurate: f32 sums over up to 18,432 rows


def _wgrad_operands(device, rows, dim, seed):
    g = torch.Generator().manual_seed(seed)
    h2 = torch.randn(rows, dim, generator=g).to(device)
    gm2 = torch.randn(rows, dim, generator=g).to(device)
    return h2, gm2, h2.double().t() @ gm2.double()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [10, 105, 2240, 17920, 18432])
@pytest.mark.parametrize("dim", WGRAD_DIMS)
def test_wgrad_kernel_matches_f64(cuda_device, dim, rows):
    """d ch_w = h2^T g_m2 on the tensor cores in 3xTF32, at every width the
    block kernel takes and row counts from a ragged handful to BEAT's
    B*S at B=512: within WGRAD_TOL of max|f64 product|, one launch, and the
    same bits on a second run (the cluster adds its partials in CTA order)."""
    h2, gm2, ref = _wgrad_operands(cuda_device, rows, dim, seed=dim + rows)
    launches = fused_mlp_train.LAUNCHES["wgrad"]
    out = fused_mlp_train.channel_mix_wgrad(h2, gm2)
    again = fused_mlp_train.channel_mix_wgrad(h2, gm2)
    torch.cuda.synchronize()
    assert fused_mlp_train.LAUNCHES["wgrad"] == launches + 2
    assert _rel(out.double(), ref) <= WGRAD_TOL
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, 9))
@pytest.mark.parametrize("rows,dim", [(105, 208), (2240, 512)])
def test_wgrad_kernel_every_cluster_size(cuda_device, rows, dim, cluster):
    """Every cluster size the kernel takes, forced: at 105 rows (four
    32-row steps) the larger clusters have CTAs with no rows."""
    h2, gm2, ref = _wgrad_operands(cuda_device, rows, dim, seed=cluster)
    out = fused_mlp_train.channel_mix_wgrad(h2, gm2, cluster=cluster)
    torch.cuda.synchronize()
    assert _rel(out.double(), ref) <= WGRAD_TOL


@pytest.mark.cuda
def test_wgrad_resident_clusters_from_the_card(cuda_device):
    """The card reports how many clusters of each size 1..8 of the kernel it
    holds at once; at TED's and BEAT's shapes the geometry's grid runs in
    one wave of them."""
    counts = fused_mlp_train.wgrad_resident_clusters(cuda_device)
    assert set(counts) == set(range(1, 9)) and all(n > 0 for n in counts.values())
    for rows in (64 * 35, 512 * 35, 512 * 36):
        geo = fused_mlp_train.wgrad_geometry(rows, 512, counts)
        assert geo.tiles <= counts[geo.cluster]


@pytest.mark.cuda
def test_wgrad_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    h2, gm2, _ = _wgrad_operands(cuda_device, 64, 64, seed=0)
    for cluster in (0, 9):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_mlp_train.channel_mix_wgrad(h2, gm2, cluster=cluster)
    wide, _, _ = _wgrad_operands(cuda_device, 64, 520, seed=0)
    with pytest.raises(ValueError, match="D=520"):
        fused_mlp_train.channel_mix_wgrad(wide, wide)
    with pytest.raises(RuntimeError, match="cudaError"):  # D=520 forced past the geometry
        fused_mlp_train.channel_mix_wgrad(wide, wide, cluster=1)
    with pytest.raises(TypeError, match="f32"):
        fused_mlp_train.channel_mix_wgrad(h2.double(), gm2.double())
    with pytest.raises(ValueError, match="shape"):
        fused_mlp_train.channel_mix_wgrad(h2, gm2[:, :32].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("b,seq,dim", [(1, 35, 512), (5, 10, 64), (7, 36, 16), (64, 35, 512),
                                       (512, 35, 512), (512, 36, 512), (333, 2, 48)])
def test_reduce_kernel_matches_sum(cuda_device, b, seq, dim):
    """The batch sum of part into the seven gradients, against part.sum(0)
    in f64 (within 1e-6 of each max: f32 sums of up to 512 terms in another
    order); the same bits on a second run."""
    g = torch.Generator().manual_seed(b + seq + dim)
    part = torch.randn(b, 5 * dim + seq + seq * seq, generator=g).to(cuda_device)
    launches = fused_mlp_train.LAUNCHES["reduce"]
    out = fused_mlp_train.reduce_partials(part, seq, dim)
    again = fused_mlp_train.reduce_partials(part, seq, dim)
    want = fused_mlp_train.reduce_partials(part.double().cpu(), seq, dim)
    torch.cuda.synchronize()
    assert fused_mlp_train.LAUNCHES["reduce"] == launches + 2
    for k, ref in want.items():
        assert out[k].shape == ref.shape, k
        assert _rel(out[k].double().cpu(), ref) <= 1e-6, k
        assert torch.equal(out[k], again[k]), k


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
    # the wrapper computes a bf16 x in f32 (the JAX kernel's semantics); the
    # kernel entry itself takes f32 only
    with torch.no_grad():
        out = fused_mlp_train.fused_transmlp_train(x.to(torch.bfloat16), emb, packed)
        want = fused_mlp_train.fused_transmlp_train(x.to(torch.bfloat16).float(), emb, packed)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want.to(torch.bfloat16))
    with pytest.raises(TypeError, match="f32"):
        fwd(x.to(torch.bfloat16), emb, packed)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(x.transpose(1, 2).contiguous().transpose(1, 2), emb, packed)
    with pytest.raises(ValueError, match="gelu"):
        fwd(x, emb, packed, "gelu")
    with pytest.raises(ValueError, match="gelu"):
        fused_mlp_train.fused_transmlp_train(x, emb, packed, "gelu")
    big, xb, eb, _ = _train_case(cuda_device, 40, 64, 1, 2)
    with pytest.raises(ValueError, match="S=40"):  # S above the kernels' 36
        fwd(xb, eb, big)
    _, stash = fwd(x, emb, packed)
    with pytest.raises(ValueError, match="S=40"):
        fused_mlp_train.fused_transmlp_train_backward(
            torch.zeros(1, 2, 40, 64, device=cuda_device), eb, xb.contiguous(), big)
    for cluster in (3, 16):  # clusters the kernels refuse
        with pytest.raises(RuntimeError, match="cudaError"):
            fwd(x, emb, packed, cluster=cluster)
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_mlp_train.fused_transmlp_train_backward(stash, emb, cot, packed,
                                                          cluster=cluster)
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


WAV_WGRAD_TOL = 1e-4  # GRAD_TOL of chip_smoke.py; 3xTF32 holds about 1e-6 against f64


def _wav_wgrad_case(device, b, length, i, seed=5):
    """Residuals of a seeded forward, a cotangent of conv i's output, and
    conv i's plain weight gradient in f64 on the same activation."""
    _, packed, wav, _ = _wav_case(device, b, length, seed=seed)
    _, res = fused_wav.fused_wav_forward(wav, packed)
    d = fused_wav.WavDims(length)
    t_out = (d.T1, d.T2, d.T3, d.T4)[i]
    g = torch.Generator().manual_seed(seed + i)
    cot = torch.randn(b, t_out, fused_wav.CHANNELS[i + 1], generator=g).to(device)
    a = torch.nn.functional.leaky_relu(fused_wav.lrelu_inputs(res, packed)[i - 1], 0.3)
    ref = fused_wav._conv_weight_grad(a.double(), cot.transpose(1, 2).double(), 6)
    return res, packed, cot, ref


@pytest.mark.cuda
@pytest.mark.parametrize("i", [1, 2, 3])
@pytest.mark.parametrize("b,length", [
    (1, audio_samples_for_frames(34)),  # T_out 1313 / 217 / 34
    (8, audio_samples_for_frames(34)),
    (512, audio_samples_for_frames(34)),
    (3, audio_samples_for_frames(2)),   # T_out 175 / 27 / 3: stages of many sequences
    (5, 5000),                          # T_out 305 / 49 / 6
])
def test_wav_wgrad_kernel_matches_plain(cuda_device, b, length, i):
    """Conv i's weight and bias gradient from the tensor-core kernel (one
    launch, its partials summed by the reduce kernel) within WAV_WGRAD_TOL
    of the plain weight gradient in f64, and the same bits on a second
    run."""
    res, packed, cot, (rw, rb) = _wav_wgrad_case(cuda_device, b, length, i)
    launches = fused_wav.LAUNCHES["wgrad"]
    part = fused_wav.wgrad_partials(i, res, cot, packed)
    again = fused_wav.wgrad_partials(i, res, cot, packed)
    dw, db = fused_wav.reduce_partials(part, i)
    torch.cuda.synchronize()
    assert fused_wav.LAUNCHES["wgrad"] == launches + 2
    geo = fused_wav.wgrad_geometry(b, cot.shape[1], fused_wav.CHANNELS[i], fused_wav.CHANNELS[i + 1])
    assert part.shape[0] == geo.nsplit
    assert torch.equal(part, again)
    assert _rel(dw.double(), rw) <= WAV_WGRAD_TOL
    assert _rel(db.double(), rb) <= WAV_WGRAD_TOL


@pytest.mark.cuda
def test_wav_wgrad_launch_refuses_other_chunks(cuda_device):
    """The launch refuses chunks that are not whole 32-row stages or that
    do not end at B*T, and a C_out that is not a multiple of 64."""
    res, packed, cot, _ = _wav_wgrad_case(cuda_device, 2, audio_samples_for_frames(2), 2)
    b, t_out = cot.shape[:2]  # 54 rows
    src = fused_wav._src(False, res.m1, res.st1, res.m1.shape[1], 64, res.wav, packed)
    part = torch.empty(64, 128 * 64 * 15 + 128, device=cuda_device)
    for nsplit, per, cout in ((2, 48, 128), (1, 32, 128), (3, 32, 128), (2, 32, 100)):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("wgrad", cuda_device, *src, cot.data_ptr(), b, t_out, cout, 0.3,
                              part.data_ptr(), nsplit, per, what="test")


def _wav_bwd_data_case(device, b, length, i, seed=6):
    """Residuals of a seeded forward, a cotangent of conv i's output, the
    xhat of conv i's input as the plain version recomputes it, and the
    plain data gradient in f64: gy [B, T_in, C_in] and the per-time terms
    of the sums, [B, 2, C_in, T_in]."""
    _, packed, wav, _ = _wav_case(device, b, length, seed=seed)
    _, res = fused_wav.fused_wav_forward(wav, packed)
    d = fused_wav.WavDims(length)
    t_out = (d.T1, d.T2, d.T3, d.T4)[i]
    g = torch.Generator().manual_seed(seed + i)
    cot = torch.randn(b, t_out, fused_wav.CHANNELS[i + 1], generator=g).to(device)
    xh = fused_wav.lrelu_inputs(res, packed)[i - 1].double()
    rgy, _ = fused_wav._plain_data_grad(cot.double(), packed[f"w{i}"].double(), xh,
                                        xh.shape[2], 0.3)
    terms = torch.stack([rgy.transpose(1, 2), rgy.transpose(1, 2) * xh], dim=1)
    return res, packed, cot, rgy, terms


@pytest.mark.cuda
@pytest.mark.parametrize("i", [1, 2, 3])
@pytest.mark.parametrize("b,length", [
    (1, audio_samples_for_frames(34)),  # T_in 7891 / 1313 / 217: tiles of 64, 64, 48 q rows
    (8, audio_samples_for_frames(34)),
    (512, audio_samples_for_frames(34)),
    (3, audio_samples_for_frames(2)),   # T_in 1064 / 175 / 27: conv2 and conv3 in tiles of 48
    (5, 5000),                          # T_in 1638 / 271 / 43: input times no window reaches
])
def test_wav_bwd_data_kernel_matches_plain(cuda_device, b, length, i):
    """Conv i's data gradient from the tensor-core kernel (the weight split,
    then one launch) within WAV_WGRAD_TOL of the plain data gradient in
    f64: gy, and each tile's sums of gy and gy * xhat over its input times;
    the same bits on a second launch."""
    res, packed, cot, rgy, terms = _wav_bwd_data_case(cuda_device, b, length, i)
    launches = dict(fused_wav.LAUNCHES)
    gy, sums = fused_wav.data_grad(i, res, cot, packed)
    gy2, sums2 = fused_wav.data_grad(i, res, cot, packed)
    torch.cuda.synchronize()
    assert fused_wav.LAUNCHES["bwd_data"] == launches["bwd_data"] + 2
    assert fused_wav.LAUNCHES["wsplit"] == launches["wsplit"] + 2
    assert torch.equal(gy, gy2) and torch.equal(sums, sums2)
    t_in = gy.shape[1]
    span = 6 * fused_wav.bwd_data_rows(t_in, i == 1)  # input times of a tile
    assert sums.shape == (b, -(-t_in // span), 2, fused_wav.CHANNELS[i])
    assert _rel(gy.double(), rgy) <= WAV_WGRAD_TOL
    want = torch.stack([terms[..., j:j + span].sum(-1) for j in range(0, t_in, span)], dim=1)
    assert _rel(sums.double(), want) <= WAV_WGRAD_TOL


@pytest.mark.cuda
def test_wav_bwd_data_launch_refuses_what_it_does_not_take(cuda_device):
    """The launches refuse a C_out that is not a multiple of 8, a T_out
    whose windows pass the input, no sequence, and a misaligned cotangent."""
    res, packed, cot, _, _ = _wav_bwd_data_case(cuda_device, 2, audio_samples_for_frames(2), 2)
    b, t_out = cot.shape[:2]
    t_in = res.m1.shape[1]
    src = fused_wav._src(False, res.m1, res.st1, t_in, 64, res.wav, packed)
    wsp = torch.empty(2 * 128 * 64 * 15 + 4, device=cuda_device)
    gy = torch.empty(b, t_in, 64, device=cuda_device)
    part = torch.empty(b, 4, 2, 64, device=cuda_device)
    flat = cot.reshape(-1)
    for bb, tt, cout, g in ((b, t_out, 100, cot), (b, t_out + 1, 128, cot), (0, t_out, 128, cot),
                            (b, t_out, 128, flat[1:])):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("bwd_data", cuda_device, *src, wsp.data_ptr(), g.data_ptr(), bb, tt,
                              cout, 0.3, gy.data_ptr(), part.data_ptr(), what="test")
    with pytest.raises(RuntimeError, match="cudaError"):
        fused_wav._launch("wsplit", cuda_device, packed["w2"].data_ptr(), 64, 100, wsp.data_ptr(),
                          what="test")
    with pytest.raises(RuntimeError, match="cudaError"):
        fused_wav._launch("wsplit", cuda_device, packed["w2"].data_ptr(), 64, 128,
                          wsp[1:].data_ptr(), what="test")


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


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda_device):
    """With no ``device=`` an entry point moves a CPU model to the card and
    leaves a model that is on a CUDA device where it is; ``device="cpu"``
    is taken as given."""
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig
    from livelyspeaker_tpu_torch.pipeline import RAGSampler
    from livelyspeaker_tpu_torch.utils.device import place_model

    model = RAG(RAGConfig(latent_dim=32, num_layers=1, n_speakers=4),
                generator=torch.Generator().manual_seed(0))
    assert RAGSampler(model, steps=20, timestep_respacing="ddim2").device.type == "cuda"
    where = next(model.parameters()).device
    assert where.type == "cuda"
    assert place_model(model, None, "x") == where
    assert RAGSampler(model, steps=20, timestep_respacing="ddim2", device="cpu").device.type == "cpu"
    assert next(model.parameters()).device.type == "cpu"


def _wav_conv_fwd_case(device, b, length, i, seed=7):
    """Residuals of a seeded forward and conv i's plain output in f64 over
    the same input lrelu(xhat), [B, T_i, C_out]."""
    _, packed, wav, _ = _wav_case(device, b, length, seed=seed)
    _, res = fused_wav.fused_wav_forward(wav, packed)
    a = torch.nn.functional.leaky_relu(fused_wav.lrelu_inputs(res, packed)[i - 1], 0.3)
    ref = torch.nn.functional.conv1d(a.double(), packed[f"w{i}"].double(),
                                     packed[f"b{i}"].double(), stride=6)
    return res, packed, ref.transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("i", [1, 2, 3])
@pytest.mark.parametrize("b,length", [
    (1, audio_samples_for_frames(34)),  # T_out 1313 / 217 / 34
    (8, audio_samples_for_frames(34)),
    (512, audio_samples_for_frames(34)),
    (3, audio_samples_for_frames(2)),   # T_out 175 / 27 / 3: conv3 in tiles of one sequence
    (5, 5000),                          # T_out 305 / 49 / 6: input times no window reaches
])
def test_wav_conv_fwd_kernel_matches_plain(cuda_device, b, length, i):
    """Conv i's output from the tensor-core kernel (the weight split, then
    one launch) within KERNEL_TOL (1e-5) of the plain conv in f64 on the
    same input, and the same bits on a second launch."""
    res, packed, ref = _wav_conv_fwd_case(cuda_device, b, length, i)
    launches = dict(fused_wav.LAUNCHES)
    y = fused_wav.conv_forward(i, res, packed)
    y2 = fused_wav.conv_forward(i, res, packed)
    torch.cuda.synchronize()
    assert fused_wav.LAUNCHES["conv_fwd"] == launches["conv_fwd"] + 2
    assert fused_wav.LAUNCHES["wsplit_fwd"] == launches["wsplit_fwd"] + 2
    assert y.shape == ref.shape
    assert torch.equal(y, y2)
    assert _rel(y.double(), ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("i", [1, 2, 3])
def test_wav_forward_weight_split_matches_plain(cuda_device, i):
    """The forward weight split on the card gives the plain version's bits."""
    _, packed, _, _ = _wav_case(cuda_device, 1, 5000)
    w = packed[f"w{i}"]
    assert torch.equal(fused_wav.forward_weight_split(w).cpu(),
                       fused_wav.forward_weight_split(w.cpu()))


@pytest.mark.cuda
def test_wav_conv_fwd_launch_refuses_what_it_does_not_take(cuda_device):
    """The launches refuse a C_out that is not a multiple of 64, a T_out
    whose windows pass the input, no sequence, misaligned split weights,
    and a split of weights whose C_out or alignment they do not take."""
    res, packed, _ = _wav_conv_fwd_case(cuda_device, 2, audio_samples_for_frames(2), 2)
    t_in, t_out = res.m1.shape[1], res.m2.shape[1]
    src = fused_wav._src(False, res.m1, res.st1, t_in, 64, res.wav, packed)
    wsp = fused_wav.forward_weight_split(packed["w2"])
    y = torch.empty(2, t_out + 1, 128, device=cuda_device)
    for bb, tt, cout, w in ((2, t_out, 100, wsp), (2, t_out + 1, 128, wsp), (0, t_out, 128, wsp),
                            (2, t_out, 128, wsp[1:])):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("conv_fwd", cuda_device, *src, w.data_ptr(),
                              packed["b2"].data_ptr(), y.data_ptr(), bb, tt, cout, 0.3,
                              what="test")
    for cin, cout, out in ((64, 100, wsp), (64, 128, wsp[1:]), (60, 128, wsp)):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("wsplit_fwd", cuda_device, packed["w2"].data_ptr(), cin, cout,
                              out.data_ptr(), what="test")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 512])
def test_wav_stats_kernel_matches_f64_and_emulation(cuda_device, b):
    """The statistics kernel on the m1 and m2 of a forward at TED's and
    BEAT's waveform length (36,267 samples), and on a case whose channel
    means are 1e3 times their std: within 1e-5 of the two-pass statistics
    in f64 (the mean relative to the largest mean, 1/std relative), the
    bits of the CPU emulation of its arithmetic, the same bits on a second
    launch; one launch a call."""
    from wav_stats_emulation import emulate_stats, offset_case

    _, packed, wav, _ = _wav_case(cuda_device, b, audio_samples_for_frames(34))
    _, res = fused_wav.fused_wav_forward(wav, packed)
    offset = offset_case(b, 217, 128, 1e3, seed=b).to(cuda_device)
    for m in (res.m1, res.m2, offset):
        launches = fused_wav.LAUNCHES["stats"]
        st = fused_wav.norm_stats(m)
        again = fused_wav.norm_stats(m)
        torch.cuda.synchronize()
        assert fused_wav.LAUNCHES["stats"] == launches + 2
        assert torch.equal(st, again)
        ref = fused_wav._norm_stats(m.double().transpose(1, 2))
        assert _rel(st[:, 0].double(), ref[:, 0]) <= 1e-5
        assert _rel(st[:, 1].double(), ref[:, 1]) <= 1e-5
        assert torch.equal(st.cpu(), emulate_stats(m.cpu()))


def _reduce_kernel(part, width):
    out = torch.empty(width, device=part.device)
    fused_wav._launch("reduce", part.device, part.data_ptr(), part.shape[0], width,
                      out.data_ptr(), what="test")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 512])
@pytest.mark.parametrize("i", [3, 2, 1, 0])
def test_wav_reduce_kernel_matches_cpu_bits(cuda_device, b, i):
    """The reduce kernel on conv i's TED partials (``wgrad_geometry``'s
    chunks; conv0's one row a sequence) equals the CPU plain version bit for
    bit, twice."""
    d = fused_wav.WavDims(audio_samples_for_frames(34))
    t, ch = (d.T1, d.T2, d.T3, d.T4), fused_wav.CHANNELS
    n = b if i == 0 else fused_wav.wgrad_geometry(b, t[i], ch[i], ch[i + 1]).nsplit
    g = torch.Generator().manual_seed(b + i)
    part = torch.randn(n, ch[i + 1] * ch[i] * 15 + ch[i + 1], generator=g)
    want = torch.cat([x.reshape(-1) for x in fused_wav.reduce_partials(part, i)])
    launches = fused_wav.LAUNCHES["reduce"]
    for _ in range(2):
        got = torch.cat([x.reshape(-1) for x in fused_wav.reduce_partials(part.to(cuda_device), i)])
        assert torch.equal(got.cpu(), want)
    assert fused_wav.LAUNCHES["reduce"] == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,width", [(1, 491_776), (1, 1001), (7, 1001), (200, 3), (66, 30_785),
                                     (513, 12)])
def test_wav_reduce_kernel_other_shapes(cuda_device, n, width):
    """One row, and widths that are not multiples of 4 (single columns):
    the CPU plain version's bits."""
    part = torch.randn(n, width, generator=torch.Generator().manual_seed(n + width))
    got = _reduce_kernel(part.to(cuda_device), width)
    assert torch.equal(got.cpu(), fused_wav._plain_reduce(part))


@pytest.mark.cuda
def test_wav_stats_and_reduce_launches_refuse_what_they_do_not_take(cuda_device):
    """The statistics launch refuses C outside {32, 64, 128}, no rows, no
    sequence and a misaligned tensor; the reduce launch no rows, no columns
    and misaligned float4 rows; the wrappers raise before launching."""
    m = torch.randn(2, 40, 128, device=cuda_device)
    st = torch.empty(2, 2, 128, device=cuda_device)
    for b, t, c, x in ((2, 40, 96, m), (2, 0, 128, m), (0, 40, 128, m),
                       (2, 39, 128, m.reshape(-1)[1:])):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("stats", cuda_device, x.data_ptr(), b, t, c, st.data_ptr(),
                              what="test")
    part = torch.randn(4, 1024, device=cuda_device)
    out = torch.empty(1024, device=cuda_device)
    for n, width, p in ((0, 1024, part), (4, 0, part), (3, 1020, part.reshape(-1)[1:])):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("reduce", cuda_device, p.data_ptr(), n, width, out.data_ptr(),
                              what="test")
    launches = dict(fused_wav.LAUNCHES)
    with pytest.raises(ValueError, match="stats_geometry"):
        fused_wav.norm_stats(torch.randn(2, 40, 96, device=cuda_device))
    with pytest.raises(ValueError, match="expected"):
        fused_wav.reduce_partials(part, 2)
    assert fused_wav.LAUNCHES == launches


def _conv0_case(device, b, length, seed=8):
    """Residuals of a seeded forward, and gy1 and its tile sums from the
    backward's conv1 data gradient on a seeded cotangent."""
    _, packed, wav, cot = _wav_case(device, b, length, seed=seed)
    _, res = fused_wav.fused_wav_forward(wav, packed)
    d = fused_wav.WavDims(length)
    _, gy1, sums = fused_wav._stack_backward(res, cot, packed, 0.3, d)
    return res, packed, gy1, sums


CONV0_CASES = [
    (1, audio_samples_for_frames(34)),  # TED's and BEAT's waveform: clusters of 8, 247 warps
    (8, audio_samples_for_frames(34)),
    (512, audio_samples_for_frames(34)),  # one CTA a sequence; 4 warps a sequence
    (3, audio_samples_for_frames(2)),   # a short clip: partial batches and clusters
    (5, 5000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,length", CONV0_CASES)
def test_wav_stats0_kernel_matches_emulation_and_f64(cuda_device, b, length):
    """The conv0 statistics kernel gives the CPU emulation's bits
    (``wav_stats_emulation.emulate_stats0``), the same bits on a second
    launch, one launch a call, and within 1e-5 of the two-pass statistics in
    f64 of the same conv0 (the mean relative to the largest mean, 1/std
    relative); also with b0 1e3 times conv0's spread."""
    from wav_stats_emulation import emulate_stats0

    _, packed, wav, _ = _wav_case(cuda_device, b, length, seed=9)
    spread = (fused_wav._conv0(wav[:1], packed) - packed["b0"][:, None]).std().item()
    offset = dict(packed, b0=(1e3 * spread * torch.sign(packed["b0"])).contiguous())
    for p in (packed, offset):
        launches = fused_wav.LAUNCHES["stats0"]
        st = fused_wav.conv0_stats(wav, p)
        again = fused_wav.conv0_stats(wav, p)
        torch.cuda.synchronize()
        assert fused_wav.LAUNCHES["stats0"] == launches + 2
        assert torch.equal(st, again)
        cpu = {k: v.cpu() for k, v in p.items()}
        assert torch.equal(st.cpu(), emulate_stats0(wav.cpu(), cpu))
        ref = fused_wav._norm_stats(fused_wav._conv0(wav, p).double())
        assert _rel(st[:, 0].double(), ref[:, 0]) <= 1e-5
        assert ((st[:, 1].double() - ref[:, 1]) / ref[:, 1]).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,length", CONV0_CASES)
def test_wav_wgrad0_kernel_matches_f64(cuda_device, b, length):
    """The conv0 backward kernel (one launch; its partial rows, one a CTA,
    summed by the reduce kernel) within WAV_WGRAD_TOL of the plain version in
    f64 on the same st0, gy1 and sums: dW0 and d_wav relative, db0 (0 in
    exact arithmetic) of the largest dW0; with and without d_wav, the same
    bits on a second launch."""
    res, packed, gy1, sums = _conv0_case(cuda_device, b, length)
    p64 = {k: v.double() for k, v in packed.items()}
    st64 = res.st0.double()
    t1 = gy1.shape[1]
    xh = fused_wav._xhat(fused_wav._conv0(res.wav.double(), p64), st64)
    tot = sums.double().sum(1) / t1
    g_m0 = fused_wav._in_backward(gy1.double().transpose(1, 2), xh, st64, tot[:, 0], tot[:, 1])
    rwav, rw, rb = fused_wav._conv0_grads(res.wav.double(), g_m0, p64, True)
    for need in (False, True):
        launches = fused_wav.LAUNCHES["wgrad0"]
        d_wav, part = fused_wav.conv0_partials(res, gy1, sums, packed, need)
        d_wav2, part2 = fused_wav.conv0_partials(res, gy1, sums, packed, need)
        torch.cuda.synchronize()
        assert fused_wav.LAUNCHES["wgrad0"] == launches + 2
        assert part.shape == (fused_wav.wgrad0_geometry(b, length).ctas, 512)
        assert torch.equal(part, part2)
        dw, db = fused_wav.reduce_partials(part, 0)
        assert _rel(dw.double(), rw) <= WAV_WGRAD_TOL
        assert (db.double() - rb).abs().max().item() <= WAV_WGRAD_TOL * rw.abs().max().item()
        if need:
            assert torch.equal(d_wav, d_wav2)
            assert _rel(d_wav.double(), rwav) <= WAV_WGRAD_TOL
        else:
            assert d_wav is None


@pytest.mark.cuda
def test_wav_conv0_launches_refuse_what_they_do_not_take(cuda_device):
    """The statistics launch refuses a T1 that is not conv0's length for L,
    no sequence, a null pointer and a split of the live times that is not
    ``stats0_geometry``'s kind (one that misses times, leaves a CTA none,
    has more than 8 CTAs or a part of a CTA step); the backward launch a T1
    that is not conv0's length, another count of partial rows, a misaligned
    gy1, no tile sums, a null pointer and a split of the times that misses
    some, leaves a warp none or is not in groups of 4."""
    res, packed, gy1, sums = _conv0_case(cuda_device, 2, audio_samples_for_frames(2))
    wav, st0 = res.wav, res.st0
    b, length = wav.shape
    t1 = gy1.shape[1]
    w0, b0 = packed["w0"].data_ptr(), packed["b0"].data_ptr()
    st = torch.empty(b, 2, 32, device=cuda_device)
    n, per = fused_wav.stats0_geometry(b, length)
    assert n > 1
    for tt, bb, nn, pp, out in ((t1 + 1, b, n, per, st), (t1, 0, n, per, st),
                                (t1, b, n, per, None), (t1, b, n - 1, per, st),
                                (t1, b, n + 1, per, st), (t1, b, 9, 256, st),
                                (t1, b, n, per + 32, st)):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("stats0", cuda_device, wav.data_ptr(), w0, b0, length, tt, bb, nn,
                              pp, None if out is None else out.data_ptr(), what="test")
    splits, per, rows = fused_wav.wgrad0_geometry(b, length)
    assert splits > 1
    part = torch.empty(rows + 1, 512, device=cuda_device)
    flat = gy1.reshape(-1)
    for tt, sp, pp, nr, g, ntq, out in (
            (t1 + 1, splits, per, rows, gy1, 1, part), (t1, splits, per, rows + 1, gy1, 1, part),
            (t1, splits, per, rows, flat[1:], 1, part), (t1, splits, per, rows, gy1, 0, part),
            (t1, splits, per, rows, gy1, 1, None), (t1, splits - 1, per, rows, gy1, 1, part),
            (t1, splits + 1, per, rows, gy1, 1, part), (t1, splits, per + 2, rows, gy1, 1, part)):
        with pytest.raises(RuntimeError, match="cudaError"):
            fused_wav._launch("wgrad0", cuda_device, wav.data_ptr(), w0, b0, length,
                              st0.data_ptr(), g.data_ptr(), sums.data_ptr(), ntq, b, tt, sp, pp,
                              None if out is None else out.data_ptr(), nr, None, what="test")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["ted", "beat"])
def test_composition_runs_k1_on_the_card(cuda_device, variant):
    """LivelySpeakerPipeline with its default device (the card), narrow
    widths: the refinement's 20 steps launch K1 20 times and never its
    plain version, and agree with the eager modules within rel 1e-4."""
    from livelyspeaker_tpu_torch.data import HashTokenizer
    from livelyspeaker_tpu_torch.models import SAG, CLIPTextConfig, CLIPTextEncoder, RAG, RAGConfig
    from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline

    kw = dict(latent_dim=64, num_layers=2, n_speakers=6)
    cfg = RAGConfig.beat(**kw) if variant == "beat" else RAGConfig.ted(**kw)
    g = torch.Generator().manual_seed(3)
    rag = random_normal_(RAG(cfg, generator=g), g)
    sag = random_normal_(SAG(njoints=cfg.njoints, nfeats=cfg.nfeats, latent_dim=64, ff_size=128,
                             num_layers=2, generator=g), g)
    clip = random_normal_(CLIPTextEncoder(CLIPTextConfig(width=64, layers=2, heads=4,
                                                         embed_dim=64), generator=g), g)
    b = 3
    cond = {"audio": 0.1 * torch.randn(b, audio_samples_for_frames(34), generator=g),
            "vid": torch.randint(0, 6, (b,), generator=g),
            "origin_x": torch.randn(b, cfg.njoints, cfg.nfeats, 34, generator=g)}
    if cfg.num_emotions:
        cond["emo"] = torch.randint(0, cfg.num_emotions, (b,), generator=g)
    cond = {k: v.to(cuda_device) for k, v in cond.items()}
    sentences = ["so we went down to the river", "no", "and then everyone started clapping"]
    outs = []
    for use_fused in (True, False):
        pipe = LivelySpeakerPipeline(rag, sag, clip, HashTokenizer(), use_fused=use_fused)
        assert pipe.device.type == "cuda"
        launches = fused_mlp.fused_transmlp.launches
        plain = fused_mlp.fused_transmlp_reference.calls
        outs.append(pipe(sentences, cond, torch.Generator(device="cuda").manual_seed(5)))
        torch.cuda.synchronize()
        assert fused_mlp.fused_transmlp.launches - launches == (20 if use_fused else 0)
        assert fused_mlp.fused_transmlp_reference.calls == plain
    fused, eager = outs
    assert fused.shape == (b, cfg.njoints, cfg.nfeats, 34) and torch.isfinite(fused).all()
    rel = ((fused - eager).abs().max() / eager.abs().max()).item()
    assert rel <= 1e-4, rel


def _narrow_rag(cuda_device, b=3, seed=6):
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig

    cfg = RAGConfig.ted(latent_dim=64, num_layers=2, n_speakers=6)
    g = torch.Generator().manual_seed(seed)
    rag = random_normal_(RAG(cfg, generator=g), g).to(cuda_device).eval()
    cond = {"audio": 0.1 * torch.randn(b, audio_samples_for_frames(34), generator=g),
            "vid": torch.randint(0, 6, (b,), generator=g),
            "origin_x": torch.randn(b, cfg.njoints, cfg.nfeats, 34, generator=g)}
    return rag, {k: v.to(cuda_device) for k, v in cond.items()}


def _fused_and_eager(run, launches_fused):
    """``run(use_fused)`` twice: K1 launched ``launches_fused`` times by the
    fused run, never by the eager one, its plain version never."""
    outs = []
    for use_fused in (True, False):
        launches = fused_mlp.fused_transmlp.launches
        plain = fused_mlp.fused_transmlp_reference.calls
        outs.append(torch.as_tensor(run(use_fused)))
        torch.cuda.synchronize()
        assert fused_mlp.fused_transmlp.launches - launches == (
            launches_fused if use_fused else 0)
        assert fused_mlp.fused_transmlp_reference.calls == plain
    fused, eager = outs
    assert torch.isfinite(fused).all()
    assert ((fused - eager).abs().max() / eager.abs().max()).item() <= 1e-4
    return fused


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 4])
def test_plms_runs_k1_on_the_card(cuda_device, order):
    """PLMS over ddim20: at order > 1 the first step calls the denoiser
    twice, so K1 launches 21 times a batch; fused within rel 1e-4 of the
    eager modules from the same generator (order 2, RAGSampler's, through
    RAGSampler; the others through sample_loop)."""
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule, sample_loop
    from livelyspeaker_tpu_torch.models.cfg import make_cfg_denoiser
    from livelyspeaker_tpu_torch.models.fast_rag import make_fused_cfg_denoiser
    from livelyspeaker_tpu_torch.pipeline import RAGSampler

    rag, cond = _narrow_rag(cuda_device)
    sched = DiffusionSchedule.create(timestep_respacing="ddim20").to(cuda_device)

    def run(use_fused):
        gen = torch.Generator(device="cuda").manual_seed(5)
        if order == 2:
            return RAGSampler(rag, timestep_respacing="ddim20", method="plms",
                              use_fused=use_fused)(cond, gen)
        make = make_fused_cfg_denoiser if use_fused else make_cfg_denoiser
        return sample_loop(make(rag, cond, 1.5), sched, (3, 9, 3, 34), gen, method="plms",
                           order=order)

    _fused_and_eager(run, 20 + (order > 1))


@pytest.mark.cuda
@pytest.mark.parametrize("noised", [True, False], ids=["noised", "clean"])
def test_inpainting_runs_k1_on_the_card(cuda_device, noised):
    """RAGSampler(inpainting=) at the serving default (dpmpp over ddim20):
    20 K1 launches, fused within rel 1e-4 of eager, and the held frames
    are the constraint at the last step."""
    from livelyspeaker_tpu_torch.diffusion import Inpainting
    from livelyspeaker_tpu_torch.pipeline import RAGSampler

    rag, cond = _narrow_rag(cuda_device)
    mask = torch.zeros(3, 9, 3, 34, dtype=torch.bool, device=cuda_device)
    mask[..., :4] = True
    inpaint = Inpainting(mask, torch.randn(3, 9, 3, 34, device=cuda_device), noised)

    def run(use_fused):
        sampler = RAGSampler(rag, timestep_respacing="ddim20", method="dpmpp",
                             use_fused=use_fused)
        return sampler(cond, torch.Generator(device="cuda").manual_seed(5), inpainting=inpaint)

    fused = _fused_and_eager(run, 20)
    assert torch.equal(fused[mask], inpaint.motion[mask])


@pytest.mark.cuda
def test_long_form_runs_k1_on_the_card(cuda_device):
    """generate_long_form over 5 windows (10 s of audio): 20 K1 launches a
    window, fused within rel 1e-4 of eager from the same generator."""
    import numpy as np

    from livelyspeaker_tpu_torch.pipeline import RAGSampler, generate_long_form

    rag, _ = _narrow_rag(cuda_device)
    audio = (0.1 * np.random.default_rng(3).normal(size=160000)).astype(np.float32)

    def run(use_fused):
        sampler = RAGSampler(rag, timestep_respacing="ddim20", method="dpmpp",
                             use_fused=use_fused)
        return generate_long_form(sampler, audio, 2, torch.Generator(device="cuda").manual_seed(5))

    fused = _fused_and_eager(run, 5 * 20)
    assert fused.shape == (9, 3, 150)


class _LoaderRows:
    """Rows of seeded arrays, wide enough that a copy takes a while."""

    def __init__(self, n=640, width=36267, seed=0):
        rng = np.random.default_rng(seed)
        self.audio = rng.normal(size=(n, width)).astype(np.float32)
        self.vid = np.arange(n, dtype=np.int32)
        self.pcm = rng.integers(-2 ** 15, 2 ** 15, size=(n, 1000)).astype(np.int16)

    def __len__(self):
        return len(self.vid)

    def batch(self, idx, fields=None):
        return {"audio": self.audio[idx], "vid": self.vid[idx], "pcm": self.pcm[idx],
                "sentence": [f"row {i}" for i in idx]}


@pytest.mark.cuda
def test_pinned_loader_delivers_the_cpu_bits(cuda_device):
    """50 batches through pinned buffers and the copy stream, prefetch 2,
    with the consumer's stream kept busy so that copies and refills
    overlap it: every batch has the bits of the CPU route."""
    ds = _LoaderRows()
    kw = dict(batch_size=64, seed=3, prefetch=2)
    gpu = loader.DataLoader(ds, device="cuda", **kw)
    cpu = loader.DataLoader(ds, device="cpu", **kw)
    busy = torch.randn(2048, 2048, device="cuda")
    n = 0
    while n < 50:
        for a, b in zip(gpu, cpu, strict=True):
            for _ in range(4):  # work queued ahead of the batch's use
                busy = torch.tanh(busy @ busy * 1e-3)
            assert a["audio"].device.type == "cuda"
            assert a["sentence"] == b["sentence"]
            for k in ("audio", "vid", "pcm"):
                assert a[k].dtype == b[k].dtype
                assert torch.equal(a[k].cpu(), b[k]), (n, k)
            n += 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
def test_two_shard_loader_delivers_the_cpu_bits(cuda_device, resident):
    """A mesh that names the card twice: each batch leaves the host as two
    shards (pinned slots, one copy stream and one event for the card) or is
    gathered twice from one resident copy; the shards, in order, are the
    CPU route's batch, with the consumer's stream kept busy."""
    from livelyspeaker_tpu_torch.parallel import create_mesh

    ds = _LoaderRows()
    mesh = create_mesh(devices=["cuda:0", "cuda:0"])
    kw = dict(batch_size=64, seed=3)
    if resident:
        gpu = loader.DeviceDataLoader(ds, mesh=mesh, fields=("audio", "vid", "pcm"), **kw)
        assert list(gpu._dev) == [torch.device("cuda", 0)]  # held once
    else:
        gpu = loader.DataLoader(ds, mesh=mesh, prefetch=2, **kw)
    cpu = loader.DataLoader(ds, device="cpu", **kw)
    busy = torch.randn(2048, 2048, device="cuda")
    n = 0
    while n < 20:
        for shards, b in zip(gpu, cpu, strict=True):
            for _ in range(4):
                busy = torch.tanh(busy @ busy * 1e-3)
            assert len(shards) == 2 and all(s["audio"].shape[0] == 32 for s in shards)
            for k in ("audio", "vid", "pcm"):
                whole = torch.cat([s[k] for s in shards])
                assert whole.device.type == "cuda" and whole.dtype == b[k].dtype
                assert torch.equal(whole.cpu(), b[k]), (n, k)
            if not resident:
                assert shards[0]["sentence"] + shards[1]["sentence"] == b["sentence"]
            n += 1
    torch.cuda.synchronize()
