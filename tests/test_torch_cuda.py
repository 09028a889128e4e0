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
