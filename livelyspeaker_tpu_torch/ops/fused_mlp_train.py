"""The fused TransMLP stack for training: a differentiable packing, the
plain PyTorch forward and backward, the CUDA wrappers and the autograd
Function that joins them.

Port of ``livelyspeaker_tpu/ops/pallas/fused_mlp_train.py``. The forward
runs the K1 stack and stashes every block input, ``[L, B, S, D]``; the
backward walks the blocks in reverse, recomputes each from its stash and
returns dx, d(emb) and the gradient of every packed weight. On a CUDA tensor
the kernels run or the wrapper raises: the forward is one launch of the
cluster kernel of ``csrc/fused_transmlp.cu`` with a stash pointer; the
backward is a block, a weight-gradient and a reduce launch per layer
(``csrc/fused_transmlp_train.cu``). The block kernel spreads each sequence
over a thread-block cluster as the forward does; :func:`backward_geometry`
picks the cluster from the shapes and the clusters the card holds at once.
The weight-gradient kernel computes ``d ch_w = h2^T g_m2`` on the tensor
cores in 3xTF32, each output tile's rows split over a cluster that sums its
partials on chip; :func:`wgrad_geometry` picks that cluster.
On a CPU tensor the plain versions run. A call without autograd launches K1
without a stash, as the JAX package's does.

Nothing is padded: the token-mix gradient is ``[L, S, S]``, where the JAX
VJP returns ``[L, S_pad, S_pad]`` and discards the padding.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import fused_mlp
from ._build import load_library

__all__ = [
    "TRAIN_ACTIVATIONS",
    "PACKED_KEYS",
    "LAUNCHES",
    "pack_transmlp_train_params",
    "fused_transmlp_train_forward_reference",
    "fused_transmlp_train_backward_reference",
    "fused_transmlp_train_forward",
    "fused_transmlp_train_backward",
    "fused_transmlp_train",
    "BackwardGeometry",
    "backward_geometry",
    "backward_resident_clusters",
    "WgradGeometry",
    "wgrad_geometry",
    "wgrad_resident_clusters",
    "channel_mix_wgrad",
    "reduce_partials",
]

# what the training kernels take, as the JAX kernel's _act_pair does
TRAIN_ACTIVATIONS = ("silu", "relu", "lrelu", "lrelu01", "lrelu02")
_SLOPES = {"lrelu": 0.01, "lrelu01": 0.1, "lrelu02": 0.2}
PACKED_KEYS = ("ln1_scale", "ln1_bias", "token_w", "token_b",
               "ln2_scale", "ln2_bias", "ch_w", "ch_b")
# launches of each CUDA kernel: one "fwd" per training forward, and
# "bwd_block", "wgrad" and "reduce" once per layer of each backward
LAUNCHES = {"fwd": 0, "bwd_block": 0, "wgrad": 0, "reduce": 0}


def _act_pair(name: str):
    """(act, d act) for the activations the training kernels support."""
    if name == "silu":
        def dact(x):
            s = torch.sigmoid(x)
            return s * (1.0 + x * (1.0 - s))
        return F.silu, dact
    if name == "relu":
        return F.relu, lambda x: (x > 0.0).to(x.dtype)
    if name in _SLOPES:
        slope = _SLOPES[name]
        return (lambda x: torch.where(x > 0.0, x, slope * x),
                lambda x: torch.where(x > 0.0, 1.0, slope).to(x.dtype))
    raise ValueError(
        f"fused_transmlp_train supports {list(TRAIN_ACTIVATIONS)}, not {name!r}")


def pack_transmlp_train_params(backbone) -> Dict[str, torch.Tensor]:
    """A ``TransMLP``'s per-block weights stacked layer-major, as
    ``fused_mlp.pack_transmlp_params`` stacks them (unfolded), but through
    autograd: the gradients of the packed tensors reach every ``block_i``
    parameter. The sampler's packing stays no-grad."""
    blocks = backbone.blocks()
    stack = lambda f: torch.stack([f(b) for b in blocks])
    return {
        "ln1_scale": stack(lambda b: b.ln1.weight),
        "ln1_bias": stack(lambda b: b.ln1.bias),
        "token_w": stack(lambda b: b.token_mix_kernel),
        "token_b": stack(lambda b: b.token_mix_bias),
        "ln2_scale": stack(lambda b: b.ln2.weight),
        "ln2_bias": stack(lambda b: b.ln2.bias),
        "ch_w": stack(lambda b: b.channel_mix.weight.t()),
        "ch_b": stack(lambda b: b.channel_mix.bias),
    }


def _ln_fwd(x, scale, bias, eps=1e-5):
    """LayerNorm returning (y, xhat, 1/std) for the backward."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x - mean) * inv
    return xhat * scale + bias, xhat, inv


def _ln_bwd(g_y, xhat, inv, scale):
    """d/dx of LayerNorm for the upstream g_y, and (d scale, d bias) summed
    over the batch and sequence axes."""
    g_xhat = g_y * scale
    m1 = g_xhat.mean(-1, keepdim=True)
    m2 = (g_xhat * xhat).mean(-1, keepdim=True)
    g_x = inv * (g_xhat - m1 - xhat * m2)
    return g_x, (g_y * xhat).sum((0, 1)), g_y.sum((0, 1))


def _block_recompute(x, emb, l, packed, act):
    """Block ``l`` from its input, returning every intermediate the backward
    needs. x [B, S, D], emb [B, 1, D]."""
    a = x + emb
    h1, xhat1, inv1 = _ln_fwd(a, packed["ln1_scale"][l], packed["ln1_bias"][l])
    m1 = (torch.einsum("ij,bjd->bid", packed["token_w"][l], h1)
          + packed["token_b"][l][None, :, None])
    r1 = a + act(m1)
    h2, xhat2, inv2 = _ln_fwd(r1, packed["ln2_scale"][l], packed["ln2_bias"][l])
    m2 = h2 @ packed["ch_w"][l] + packed["ch_b"][l]
    return a, h1, xhat1, inv1, m1, r1, h2, xhat2, inv2, m2


def fused_transmlp_train_forward_reference(
    x: torch.Tensor, emb: torch.Tensor, packed: Dict[str, torch.Tensor],
    act_name: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out [B, S, D], stash
    [L, B, S, D]), on any device and in any float dtype."""
    fused_transmlp_train_forward_reference.calls += 1
    act, _ = _act_pair(act_name)
    b, _, d = x.shape
    emb = emb.reshape(b, 1, d)
    stash = []
    for l in range(packed["token_w"].shape[0]):
        stash.append(x)
        _, _, _, _, _, r1, _, _, _, m2 = _block_recompute(x, emb, l, packed, act)
        x = r1 + act(m2)
    return x, torch.stack(stash)


fused_transmlp_train_forward_reference.calls = 0


def fused_transmlp_train_backward_reference(
    stash: torch.Tensor, emb: torch.Tensor, g: torch.Tensor,
    packed: Dict[str, torch.Tensor], act_name: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of the backward kernels, ``_bwd_kernel`` of the JAX
    package line for line: (dx [B, S, D], d emb [B, D], packed gradients)."""
    fused_transmlp_train_backward_reference.calls += 1
    act, dact = _act_pair(act_name)
    num_layers = packed["token_w"].shape[0]
    b, _, d = g.shape
    emb = emb.reshape(b, 1, d)
    grads = {k: [None] * num_layers for k in PACKED_KEYS}
    gemb = torch.zeros((b, d), dtype=g.dtype, device=g.device)
    for l in reversed(range(num_layers)):
        a, h1, xhat1, inv1, m1, r1, h2, xhat2, inv2, m2 = _block_recompute(
            stash[l], emb, l, packed, act)
        # x_out = r1 + act(m2)
        g_m2 = g * dact(m2)
        grads["ch_w"][l] = torch.einsum("bsk,bsn->kn", h2, g_m2)
        grads["ch_b"][l] = g_m2.sum((0, 1))
        g_h2 = g_m2 @ packed["ch_w"][l].t()
        g_r1_ln, grads["ln2_scale"][l], grads["ln2_bias"][l] = _ln_bwd(
            g_h2, xhat2, inv2, packed["ln2_scale"][l])
        g_r1 = g + g_r1_ln
        # r1 = a + act(m1)
        g_m1 = g_r1 * dact(m1)
        grads["token_w"][l] = torch.einsum("bid,bjd->ij", g_m1, h1)
        grads["token_b"][l] = g_m1.sum((0, 2))
        g_h1 = torch.einsum("ji,bjd->bid", packed["token_w"][l], g_m1)
        g_a_ln, grads["ln1_scale"][l], grads["ln1_bias"][l] = _ln_bwd(
            g_h1, xhat1, inv1, packed["ln1_scale"][l])
        g_a = g_r1 + g_a_ln
        # a = x_in + emb
        gemb = gemb + g_a.sum(1)
        g = g_a
    return g, gemb, {k: torch.stack(v) for k, v in grads.items()}


fused_transmlp_train_backward_reference.calls = 0


_bound: Dict[str, object] = {}
_resident: Dict[tuple, Dict[int, int]] = {}

# The block kernel's shared-memory layout (BwdSmem in csrc/fused_transmlp_train.cu)
_BWD_RING_FLOATS, _BWD_BAR_BYTES = 12288, 512
_TWP = fused_mlp.MAX_SEQ * fused_mlp.MAX_SEQ + fused_mlp.MAX_SEQ  # d token_w, d token_b


def _bwd_smem_bytes(d: int, cluster: int) -> int:
    """Mirror of ``BwdSmem::bytes`` in the kernel."""
    dp, dc, spad = d + 4, d // cluster, fused_mlp.MAX_SEQ
    floats = (_BWD_RING_FLOATS + max(spad * dp, 256 * 76)  # ring; full rows / partial tiles
              + 4 * spad * dc + 2 * spad * spad  # four tiles; token mix and its transpose
              + spad + 5 * dc  # token_b; LN affines, ch_b
              + 2 * 8 * spad * 2 + 6 * spad  # exchange buffers; row statistics
              + _TWP + 4 * 8)  # the gathered d token_w / d token_b slices
    return _BWD_BAR_BYTES + 4 * floats


class BackwardGeometry(NamedTuple):
    cluster: int  # CTAs a sequence is spread over
    cols: int  # columns each CTA owns, D / cluster
    smem_bytes: int  # dynamic shared memory of one CTA


def backward_geometry(b: int, s: int, d: int,
                      resident: Optional[Dict[int, int]] = None) -> BackwardGeometry:
    """The backward block kernel's launch geometry for B sequences of
    [S, D]: the forward's rule (``fused_mlp.pick_cluster``: the largest
    cluster whose batch runs in one wave, else the widest column slices) on
    the block kernel's resident counts and its own shared memory; raises
    ``ValueError`` on what the kernel does not take."""
    fused_mlp.check_limits(b, s, d)
    n = fused_mlp.pick_cluster(b, d, resident, fused_mlp.cluster_sizes(d))
    return BackwardGeometry(n, d // n, _bwd_smem_bytes(d, n))


def _launcher(kernel: str):
    """The C function of ``kernel``, bound on first use: the forward is the
    cluster kernel of ``fused_transmlp.cu`` with a stash; the backward's
    three kernels and the cluster counts of the block and weight-gradient
    kernels are in ``fused_transmlp_train.cu``."""
    if kernel == "fwd":
        return fused_mlp._launcher()[2]
    if kernel not in _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        name, argtypes = {
            # stash, emb, g_in, g_out, gemb, first, 9 weights, h2, gm2, part,
            # B, S, D, act, cluster, stream
            "bwd_block": ("bwd_block_launch", [p] * 5 + [i] + [p] * 12 + [i] * 5 + [p]),
            # h2, gm2, dcw, R, D, cluster, stream
            "wgrad": ("wgrad_launch", [p] * 3 + [i] * 3 + [p]),
            # part, B, S, D, 7 gradients, stream
            "reduce": ("reduce_launch", [p, i, i, i] + [p] * 7 + [p]),
            # D, cluster
            "bwd_max_clusters": ("bwd_max_clusters", [i, i]),
            # cluster
            "wgrad_max_clusters": ("wgrad_max_clusters", [i]),
        }[kernel]
        fn = getattr(load_library("fused_transmlp_train"), f"fused_transmlp_train_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[kernel] = fn
    return _bound[kernel]


def backward_resident_clusters(d: int, device: torch.device) -> Dict[int, int]:
    """Clusters of each size the card holds at once at width D, as the CUDA
    runtime reports them for the block kernel (asked once per card and
    width)."""
    key = (device.index, d)
    if key not in _resident:
        query = _launcher("bwd_max_clusters")
        with torch.cuda.device(device):
            counts = {n: query(d, n) for n in fused_mlp.cluster_sizes(d)}
        bad = {n: -v for n, v in counts.items() if v < 0}
        if bad:
            raise RuntimeError("fused_transmlp_train: cudaOccupancyMaxActiveClusters failed "
                               f"with cudaError {bad} (D={d})")
        _resident[key] = counts
    return _resident[key]


# The weight-gradient kernel (wgrad_kernel in csrc/fused_transmlp_train.cu):
# 128 x 128 output tiles, rows in ring stages of 32
WGRAD_TILE, WGRAD_STEP, WGRAD_MAX_CLUSTER = 128, 32, 8
# Clusters of N CTAs of it an H100 SXM holds at once (one CTA an SM, a
# cluster inside one GPC): cudaOccupancyMaxActiveClusters on an NVIDIA H100
# 80GB HBM3, as chip_smoke.py prints it. The default of wgrad_geometry; on a
# card the wrapper asks the card. The 16 tiles at D = 512 take clusters of 6.
H100_WGRAD_RESIDENT_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


class WgradGeometry(NamedTuple):
    tiles: int  # 128 x 128 output tiles, one cluster each
    cluster: int  # CTAs that split a tile's rows
    bounds: Tuple[int, ...]  # row boundaries: CTA j takes [bounds[j], bounds[j + 1])


def wgrad_geometry(rows: int, d: int,
                   resident: Optional[Dict[int, int]] = None) -> WgradGeometry:
    """The weight-gradient kernel's launch geometry for ``d ch_w = h2^T g_m2``
    over ``rows`` rows of width D; raises ``ValueError`` on what the kernel
    does not take. ``resident`` maps a cluster size to the clusters the card
    holds at once (default: an H100 SXM's, ``H100_WGRAD_RESIDENT_CLUSTERS``).

    Each of the ceil(D/128)^2 output tiles is one cluster of N CTAs. N is the
    largest size up to 8 whose clusters all run in one wave and that gives
    every CTA at least one 32-row step: the rows are spread over the most
    SMs. CTA j takes the steps [j * steps // N, (j + 1) * steps // N), steps
    = ceil(rows / 32): boundaries fixed by the rows and N, as the kernel
    computes them."""
    if rows < 1:
        raise ValueError(f"fused_transmlp_train wgrad: {rows} rows; the kernel takes >= 1")
    if not (fused_mlp.DIM_STEP <= d <= fused_mlp.MAX_DIM and d % fused_mlp.DIM_STEP == 0):
        raise ValueError(f"fused_transmlp_train wgrad: D={d}; the kernel takes a multiple of "
                         f"{fused_mlp.DIM_STEP} in [{fused_mlp.DIM_STEP}, {fused_mlp.MAX_DIM}]")
    resident = H100_WGRAD_RESIDENT_CLUSTERS if resident is None else resident
    tiles = ((d + WGRAD_TILE - 1) // WGRAD_TILE) ** 2
    steps = -(-rows // WGRAD_STEP)
    cluster = next((n for n in range(WGRAD_MAX_CLUSTER, 0, -1)
                    if n <= steps and tiles <= resident.get(n, 0)), 1)
    bounds = tuple(min(rows, j * steps // cluster * WGRAD_STEP) for j in range(cluster + 1))
    return WgradGeometry(tiles, cluster, bounds)


def wgrad_resident_clusters(device: torch.device) -> Dict[int, int]:
    """Clusters of each size 1..8 of the weight-gradient kernel the card
    holds at once, as the CUDA runtime reports them (asked once per card)."""
    key = (device.index, "wgrad")
    if key not in _resident:
        query = _launcher("wgrad_max_clusters")
        with torch.cuda.device(device):
            counts = {n: query(n) for n in range(1, WGRAD_MAX_CLUSTER + 1)}
        bad = {n: -v for n, v in counts.items() if v < 0}
        if bad:
            raise RuntimeError("fused_transmlp_train wgrad: cudaOccupancyMaxActiveClusters "
                               f"failed with cudaError {bad}")
        _resident[key] = counts
    return _resident[key]


def _launch(kernel: str, dev: torch.device, *args, what: str) -> None:
    """Call the C launch function on the current stream of ``dev``; raise
    on a non-zero cudaError."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(kernel)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_transmlp_train {kernel} kernel launch failed with cudaError {err} ({what})")
    LAUNCHES[kernel] += 1


def _check_cuda(who: str, x: torch.Tensor, act_name: str) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    _act_pair(act_name)
    return fused_mlp.KERNEL_ACT_CODES[act_name]


def _check_packed(who: str, packed, num_layers: int, s: int, d: int, dev) -> None:
    shapes = {
        "ln1_scale": (num_layers, d), "ln1_bias": (num_layers, d),
        "token_w": (num_layers, s, s), "token_b": (num_layers, s),
        "ln2_scale": (num_layers, d), "ln2_bias": (num_layers, d),
        "ch_w": (num_layers, d, d), "ch_b": (num_layers, d),
    }
    for k, shp in shapes.items():
        fused_mlp._check(k, packed[k], shp, dev, who)


def fused_transmlp_train_forward(
    x: torch.Tensor, emb: torch.Tensor, packed: Dict[str, torch.Tensor],
    act_name: str = "silu", cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, D], stash [L, B, S, D]). A CPU tensor runs the plain
    version; a CUDA tensor launches the cluster kernel with a stash pointer
    or raises. ``cluster`` overrides ``fused_mlp.transmlp_geometry``'s choice
    (for measurement)."""
    if x.device.type == "cpu":
        return fused_transmlp_train_forward_reference(x, emb, packed, act_name)
    who = "fused_transmlp_train"
    act = _check_cuda(who, x, act_name)
    b, s, d = x.shape
    num_layers = packed["token_w"].shape[0]
    dev = x.device
    emb = emb.reshape(b, d)
    fused_mlp._check("x", x, (b, s, d), dev, who)
    fused_mlp._check("emb", emb, (b, d), dev, who)
    _check_packed(who, packed, num_layers, s, d, dev)
    if cluster is None:
        cluster = fused_mlp.transmlp_geometry(
            b, s, d, fused_mlp.resident_clusters(d, dev)).cluster
    out = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    stash = torch.empty((num_layers, b, s, d), dtype=torch.float32, device=dev)
    _launch("fwd", dev, x.data_ptr(), emb.data_ptr(),
            *[packed[k].data_ptr() for k in PACKED_KEYS],
            out.data_ptr(), stash.data_ptr(), b, s, d, num_layers, act, cluster,
            what=f"B={b}, S={s}, D={d}, L={num_layers}, cluster={cluster}")
    return out, stash


def _part_layout(s: int, d: int) -> Dict[str, Tuple[int, ...]]:
    """The gradients a row of ``part`` holds, in its order (and the reduce
    launch's): d ln1 and d ln2 scale and bias and d ch_b [D], d token_b
    [S], d token_w [S, S]."""
    return {"ln1_scale": (d,), "ln1_bias": (d,), "ln2_scale": (d,), "ln2_bias": (d,),
            "ch_b": (d,), "token_b": (s,), "token_w": (s, s)}


def channel_mix_wgrad(h2: torch.Tensor, gm2: torch.Tensor, out: Optional[torch.Tensor] = None,
                      cluster: Optional[int] = None) -> torch.Tensor:
    """``d ch_w = h2^T g_m2`` [D, D] for h2, g_m2 [R, D]: the weight-gradient
    kernel on CUDA tensors (into ``out`` if given), the plain product on CPU
    tensors. ``cluster`` overrides :func:`wgrad_geometry`'s choice (for
    measurement); the kernel refuses a size outside 1..8 and the wrapper
    raises."""
    if h2.device.type == "cpu":
        return torch.einsum("rk,rn->kn", h2, gm2)
    who = "fused_transmlp_train wgrad"
    if h2.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {h2.device}")
    rows, d = h2.shape
    dev = h2.device
    fused_mlp._check("h2", h2, (rows, d), dev, who)
    fused_mlp._check("g_m2", gm2, (rows, d), dev, who)
    if out is None:
        out = torch.empty((d, d), dtype=torch.float32, device=dev)
    fused_mlp._check("out", out, (d, d), dev, who)
    if cluster is None:
        cluster = wgrad_geometry(rows, d, wgrad_resident_clusters(dev)).cluster
    _launch("wgrad", dev, h2.data_ptr(), gm2.data_ptr(), out.data_ptr(), rows, d, cluster,
            what=f"R={rows}, D={d}, cluster={cluster}")
    return out


def reduce_partials(part: torch.Tensor, s: int, d: int,
                    out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The per-sequence partials ``part`` [B, 5D + S + S^2] summed over the
    batch into the gradients of :func:`_part_layout`: the reduce kernel on a
    CUDA tensor (into ``out``'s tensors if given), the plain sum on a CPU
    tensor."""
    layout = _part_layout(s, d)
    if part.device.type == "cpu":
        sums = part.sum(0).split([math.prod(shp) for shp in layout.values()])
        return {k: v.reshape(shp) for (k, shp), v in zip(layout.items(), sums)}
    who = "fused_transmlp_train reduce"
    if part.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {part.device}")
    b = part.shape[0]
    dev = part.device
    fused_mlp._check("part", part, (b, 5 * d + s + s * s), dev, who)
    if out is None:
        out = {k: torch.empty(shp, dtype=torch.float32, device=dev) for k, shp in layout.items()}
    for k, shp in layout.items():
        fused_mlp._check(k, out[k], shp, dev, who)
    _launch("reduce", dev, part.data_ptr(), b, s, d, *[out[k].data_ptr() for k in layout],
            what=f"B={b}, S={s}, D={d}")
    return out


def fused_transmlp_train_backward(
    stash: torch.Tensor, emb: torch.Tensor, g: torch.Tensor,
    packed: Dict[str, torch.Tensor], act_name: str = "silu",
    cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(dx, d emb, packed gradients) for the output cotangent ``g``. A CPU
    tensor runs the plain version; a CUDA tensor launches 3 kernels per
    layer or raises. ``cluster`` overrides :func:`backward_geometry`'s
    choice for the block kernel (for measurement); the weight-gradient
    kernel's cluster is :func:`wgrad_geometry`'s."""
    if g.device.type == "cpu":
        return fused_transmlp_train_backward_reference(stash, emb, g, packed, act_name)
    who = "fused_transmlp_train backward"
    act = _check_cuda(who, g, act_name)
    b, s, d = g.shape
    num_layers = packed["token_w"].shape[0]
    dev = g.device
    if b < 1:
        raise ValueError(f"{who}: empty batch")
    emb = emb.reshape(b, d)
    fused_mlp._check("g", g, (b, s, d), dev, who)
    fused_mlp._check("emb", emb, (b, d), dev, who)
    fused_mlp._check("stash", stash, (num_layers, b, s, d), dev, who)
    _check_packed(who, packed, num_layers, s, d, dev)
    if cluster is None:
        cluster = backward_geometry(b, s, d, backward_resident_clusters(d, dev)).cluster

    f32 = dict(dtype=torch.float32, device=dev)
    gx = torch.empty((b, s, d), **f32)
    gemb = torch.empty((b, d), **f32)
    grads = {k: torch.empty_like(packed[k]) for k in PACKED_KEYS}
    h2, gm2 = torch.empty((2, b, s, d), **f32)  # for the weight-gradient kernel
    part = torch.empty((b, 5 * d + s + s * s), **f32)
    cw_t = packed["ch_w"].transpose(1, 2).contiguous()  # once a backward, every layer's

    def at(t: torch.Tensor, l: int) -> int:  # pointer to layer l of t
        return t.data_ptr() + l * t[0].numel() * t.element_size()

    what = f"B={b}, S={s}, D={d}, L={num_layers}, cluster={cluster}"
    for l in reversed(range(num_layers)):
        first = l == num_layers - 1
        _launch("bwd_block", dev, at(stash, l), emb.data_ptr(),
                (g if first else gx).data_ptr(), gx.data_ptr(), gemb.data_ptr(), int(first),
                *[at(packed[k], l) for k in PACKED_KEYS[:7]], at(cw_t, l), at(packed["ch_b"], l),
                h2.data_ptr(), gm2.data_ptr(), part.data_ptr(), b, s, d, act, cluster,
                what=f"{what}, layer {l}")
        channel_mix_wgrad(h2.view(b * s, d), gm2.view(b * s, d), grads["ch_w"][l])
        reduce_partials(part, s, d, {k: grads[k][l] for k in _part_layout(s, d)})
    return gx, gemb, grads


class _FusedTransMLPTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, emb, act_name, *weights):
        packed = dict(zip(PACKED_KEYS, weights))
        out, stash = fused_transmlp_train_forward(x, emb, packed, act_name)
        ctx.act_name = act_name
        ctx.save_for_backward(stash, emb, *weights)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        stash, emb, *weights = ctx.saved_tensors
        gx, gemb, grads = fused_transmlp_train_backward(
            stash, emb, g.contiguous(), dict(zip(PACKED_KEYS, weights)), ctx.act_name)
        return (gx, gemb, None, *[grads[k] for k in PACKED_KEYS])


def fused_transmlp_train(
    x: torch.Tensor,  # [B, S, D]
    emb: torch.Tensor,  # [B, D] or [B, 1, D]
    packed: Dict[str, torch.Tensor],
    act_name: str = "silu",
) -> torch.Tensor:
    """The differentiable mixer stack, [B, S, D] -> [B, S, D], with the
    semantics of ``TransMLP`` minus the timestep embedder. Under autograd
    the forward stashes the block inputs and the backward is the
    hand-written one; without autograd it is K1's stash-free stack. The
    kernels are f32 only (the plain version also takes float64, for
    gradcheck). A bf16 or f16 ``x`` (the trainer's ``compute_dtype``) is
    computed as the JAX kernel computes it: ``x``, ``emb`` and the weights
    cast to f32, the stack in f32, the output cast back to ``x``'s dtype.
    The gradients reach each reduced-precision input in its own dtype (the
    JAX custom VJP hands its f32 cotangents on unrounded)."""
    _act_pair(act_name)  # raises on gelu, as the JAX kernel does
    if x.dtype in (torch.bfloat16, torch.float16):
        return fused_transmlp_train(
            x.float(), emb.float(), {k: v.float() for k, v in packed.items()},
            act_name).to(x.dtype)
    b, _, d = x.shape
    emb = emb.reshape(b, d)
    weights = [packed[k] for k in PACKED_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, emb, *weights)):
        return _FusedTransMLPTrain.apply(x.contiguous(), emb.contiguous(), act_name, *weights)
    if x.device.type == "cpu":
        return fused_transmlp_train_forward_reference(x, emb, packed, act_name)[0]
    _check_cuda("fused_transmlp_train", x, act_name)
    return fused_mlp.launch_stack(x, emb, packed, fused_mlp.KERNEL_ACT_CODES[act_name])
