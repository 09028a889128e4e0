"""The fused TransMLP stack: packing, plain PyTorch version, CUDA wrapper.

Port of ``livelyspeaker_tpu/ops/pallas/fused_mlp.py``. The kernel
(``csrc/fused_transmlp.cu``) runs all L mixer blocks of one sequence, and
optionally the pose projection, in one launch. :func:`fused_transmlp` runs
the kernel on a CUDA tensor and the plain version
:func:`fused_transmlp_reference` on a CPU tensor; there is no fallback from
one to the other.

Unlike the TPU kernel, nothing is padded: the packed token mix is [L, S, S]
and the pose projection [D, F]. The kernel spreads each sequence over a
thread-block cluster; :func:`transmlp_geometry` picks the cluster from the
shapes and the clusters the card holds at once.

The JAX kernel's bf16 option is here too: ``pack_transmlp_params(...,
dtype=torch.bfloat16)`` and ``pack_out_proj(..., dtype=torch.bfloat16)``
store the three weight matrices in bf16 (LayerNorm parameters and biases
stay f32), and bf16 ``x`` and ``emb`` then go to a kernel of their own
(``csrc/fused_transmlp_bf16.cu``, one CTA a sequence, bf16 tensor cores with
f32 accumulation) or, on the CPU, to the plain bf16 version. A bf16 pack
stores ``ch_w`` as [L, D_out, D_in] and ``out_w`` as [F, D], the layout the
tensor cores read. float32 stays the default, and no path of the package
uses bf16.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from ..models.mlp_backbone import get_activation
from ._build import load_library

__all__ = [
    "ACTIVATIONS",
    "KERNEL_ACT_CODES",
    "pack_transmlp_params",
    "pack_out_proj",
    "fused_transmlp_reference",
    "fused_transmlp_bf16_reference",
    "fused_transmlp",
    "launch_stack",
    "TransMLPGeometry",
    "cluster_sizes",
    "forward_cluster_sizes",
    "pick_cluster",
    "transmlp_geometry",
    "resident_clusters",
    "TransMLPBf16Geometry",
    "transmlp_bf16_geometry",
    "bf16_resident_clusters",
    "bf16_cluster_sizes",
]

# activation name -> the kernel's Act code (csrc/transmlp_common.cuh)
KERNEL_ACT_CODES = {"silu": 0, "relu": 1, "gelu": 2, "lrelu": 3, "lrelu01": 4, "lrelu02": 5}
# what fused_transmlp takes, as the JAX kernel does; any other name raises
ACTIVATIONS = {k: KERNEL_ACT_CODES[k] for k in ("silu", "relu", "gelu")}


DTYPES = (torch.float32, torch.bfloat16)  # what the packs and the kernels take


def _pack_dtype(dtype) -> torch.dtype:
    if dtype not in DTYPES:
        raise TypeError(f"fused_transmlp packs float32 or bfloat16 weights, not {dtype}")
    return dtype


@torch.no_grad()
def pack_transmlp_params(backbone, fold_ln2: bool = False,
                         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Stack a ``TransMLP``'s per-block weights into layer-major tensors.

    The channel mix is stored ``[L, D_in, D_out]``. ``fold_ln2=True`` folds
    LN2's affine into it, ``(z*g + beta) @ W == z @ (g[:, None] * W) +
    beta @ W``; the bias fold uses the unscaled W. The returned dict then has
    no ``ln2_*`` keys, which is how the kernel tells the layouts apart.

    ``dtype=torch.bfloat16`` (the JAX pack's ``dtype=jnp.bfloat16``) rounds
    the token mix and the channel mix to bf16 after the fold, which is done
    in f32; the LayerNorm parameters and the biases stay f32. Its channel
    mix is stored ``[L, D_out, D_in]``, as the bf16 kernel reads it."""
    dtype = _pack_dtype(dtype)
    blocks = backbone.blocks()
    stack = lambda f: torch.stack([f(b) for b in blocks]).contiguous()
    ch_w = stack(lambda b: b.channel_mix.weight.t())
    ch_b = stack(lambda b: b.channel_mix.bias)
    out = {
        "ln1_scale": stack(lambda b: b.ln1.weight),
        "ln1_bias": stack(lambda b: b.ln1.bias),
        "token_w": stack(lambda b: b.token_mix_kernel),
        "token_b": stack(lambda b: b.token_mix_bias),
    }
    g = stack(lambda b: b.ln2.weight)
    beta = stack(lambda b: b.ln2.bias)
    if fold_ln2:
        ch_b = ch_b + torch.einsum("ld,lde->le", beta, ch_w)
        ch_w = g[:, :, None] * ch_w
    else:
        out["ln2_scale"] = g
        out["ln2_bias"] = beta
    if dtype == torch.bfloat16:
        out["token_w"] = out["token_w"].to(dtype)
        ch_w = ch_w.transpose(1, 2).to(dtype)
    out["ch_w"] = ch_w.contiguous()
    out["ch_b"] = ch_b.contiguous()
    return out


@torch.no_grad()
def pack_out_proj(layer: torch.nn.Linear,
                  dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A ``[D] -> [F]`` Linear as ``{'out_w': [D, F], 'out_b': [F]}``; with
    ``dtype=torch.bfloat16``, ``out_w`` is the bf16 ``[F, D]`` weight and
    ``out_b`` stays f32."""
    if _pack_dtype(dtype) == torch.bfloat16:
        return {"out_w": layer.weight.detach().to(dtype).contiguous(),
                "out_b": layer.bias.detach().contiguous()}
    return {
        "out_w": layer.weight.t().contiguous(),
        "out_b": layer.bias.detach().contiguous(),
    }


def _act(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(
            f"fused_transmlp supports {sorted(ACTIVATIONS)}, not {name!r}"
        )
    return get_activation(name)


def _ln_core(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def fused_transmlp_reference(
    x: torch.Tensor,
    emb: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    act_name: str = "silu",
    out_proj: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device; bf16 ``x`` takes
    :func:`fused_transmlp_bf16_reference`."""
    fused_transmlp_reference.calls += 1
    if x.dtype == torch.bfloat16:
        return fused_transmlp_bf16_reference(x, emb, packed, act_name, out_proj)
    act = _act(act_name)
    emb = emb.reshape(emb.shape[0], 1, -1)
    folded = "ln2_scale" not in packed
    for l in range(packed["token_w"].shape[0]):
        x = x + emb
        h = _ln_core(x) * packed["ln1_scale"][l] + packed["ln1_bias"][l]
        h = torch.einsum("ij,bjd->bid", packed["token_w"][l], h)
        x = x + act(h + packed["token_b"][l][None, :, None])
        h = _ln_core(x)
        if not folded:
            h = h * packed["ln2_scale"][l] + packed["ln2_bias"][l]
        x = x + act(h @ packed["ch_w"][l] + packed["ch_b"][l])
    if out_proj is not None:
        return x @ out_proj["out_w"] + out_proj["out_b"]
    return x


fused_transmlp_reference.calls = 0


def _bf16_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b of bf16 values: the f32 sum, rounded once to bf16."""
    return (a.float() + b.float()).to(torch.bfloat16)


def fused_transmlp_bf16_reference(
    x: torch.Tensor,
    emb: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    act_name: str = "silu",
    out_proj: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain version of the bf16 stack, rounding where the JAX kernel does
    with ``x.dtype == bfloat16``: the residual stream is bf16 and each add
    is rounded to bf16; each LayerNorm takes its statistics in f32, applies
    its f32 affine (or none, folded) and rounds the rows to bf16; each
    product multiplies bf16 operands with f32 accumulation and adds its f32
    bias, the activation runs in f32 and the result is rounded to bf16
    before the residual add. The pose projection's output is bf16. Takes a
    bf16 pack (:func:`pack_transmlp_params` with ``dtype=torch.bfloat16``)."""
    act = _act(act_name)
    bf16 = torch.bfloat16
    emb = emb.reshape(emb.shape[0], 1, -1)
    folded = "ln2_scale" not in packed
    for l in range(packed["token_w"].shape[0]):
        x = _bf16_add(x, emb)
        h = (_ln_core(x.float()) * packed["ln1_scale"][l] + packed["ln1_bias"][l]).to(bf16)
        h = torch.einsum("ij,bjd->bid", packed["token_w"][l].float(), h.float())
        x = _bf16_add(x, act(h + packed["token_b"][l][None, :, None]).to(bf16))
        h = _ln_core(x.float())
        if not folded:
            h = h * packed["ln2_scale"][l] + packed["ln2_bias"][l]
        h = h.to(bf16).float() @ packed["ch_w"][l].float().t()
        x = _bf16_add(x, act(h + packed["ch_b"][l]).to(bf16))
    if out_proj is not None:
        return (x.float() @ out_proj["out_w"].float().t() + out_proj["out_b"]).to(bf16)
    return x


# The kernel's limits and its shared-memory layout (csrc/fused_transmlp.cu)
MAX_SEQ, MAX_DIM, DIM_STEP = 36, 512, 16
_MAX_COLS = 128  # Dc of the training backward's block kernel
_MAX_SLICE = 256  # Dc of the forward
# rows of a sequence in wgmma's N, bytes of a row's K-chunk of 32 k, k of a
# ring stage, the ring's most stages, columns of an M-tile
_ROWS, _ROW_BYTES, _STAGE_K, _MAX_STAGES, _TILE = 40, 128, 32, 8, 64
_POSE_BUF = (MAX_DIM // _TILE) * MAX_SEQ * _TILE * 4  # every pose tile's partials
_POSE_SLOTS = 3 * 16 * 256 * 4  # three stages of every thread's pose fragment
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
SM_SHARED = 233_472  # bytes of shared memory an SM gives its blocks
# Clusters of N CTAs an H100 SXM (132 SMs) holds at once at the kernel's
# shared memory, one CTA an SM (cudaOccupancyMaxActiveClusters on an NVIDIA
# H100 80GB HBM3, as chip_smoke.py prints it): a cluster stays inside one
# GPC, so 8-CTA clusters fill 120 SMs, not 128. The default of
# transmlp_geometry; on a card the wrapper asks the card.
H100_RESIDENT_CLUSTERS = {8: 15, 4: 30, 2: 66, 1: 132}


class TransMLPGeometry(NamedTuple):
    cluster: int  # CTAs a sequence is spread over
    cols: int  # columns of the activation each CTA owns, D / cluster
    m_tiles: int  # 64-column tiles of wgmma's M a pass, one a warpgroup
    stages: int  # stages of the weight ring, as many as the shared memory holds
    smem_bytes: int  # dynamic shared memory of one CTA
    ctas_per_sm: int  # as the shared memory allows


def _up(v: int, a: int) -> int:
    return -(-v // a) * a


def _layout(d: int, cluster: int) -> tuple:
    """Mirror of ``Layout`` in the kernel: (M-tiles a pass, ring stages,
    shared-memory bytes)."""
    dc, spad = d // cluster, MAX_SEQ
    m_tiles = 2 if dc > _TILE else 1
    x_bytes = spad * dc * 4
    prm_bytes = (spad * spad + spad + 6 * dc) * 4  # a layer's small parameters, two biases
    partials = (cluster - 1) * spad * dc * 4  # the other CTAs' partial sums
    recv = _up(max(partials, _POSE_BUF - x_bytes - prm_bytes), 16)
    ring_at = _up(2 * -(-dc // 32) * _ROWS * _ROW_BYTES + recv + x_bytes + prm_bytes, 128)
    used = (ring_at + dc * 4  # emb
            + 2 * 8 * spad * 2 * 4 + 2 * spad * 4  # the statistics' exchange; mean, 1/std
            + (_MAX_STAGES + 2) * 8 + _MAX_STAGES * 4 + 1024)  # mbarriers, counters, alignment
    stage = _STAGE_K * (_TILE * m_tiles + 8) * 4
    stages = min(_MAX_STAGES, max(0, SMEM_LIMIT - used) // stage)
    return m_tiles, stages, used + stages * stage


def cluster_sizes(d: int) -> list:
    """The cluster sizes the training backward's block kernel takes at width
    D, largest first: N in {8, 4, 2, 1} with Dc = D/N a whole number of
    16-byte loads and at most 128 columns (its shared memory)."""
    return [n for n in (8, 4, 2, 1) if d % (4 * n) == 0 and d // n <= _MAX_COLS]


def forward_cluster_sizes(d: int) -> list:
    """The cluster sizes the forward kernel takes at width D, largest first:
    N in {8, 4, 2, 1} with Dc = D/N a whole number of 16-byte loads, at
    most 256 columns, and a layout that leaves the weight ring two stages
    and the pose projection's slots (``Layout::ok`` in the kernel)."""
    out = []
    for n in (8, 4, 2, 1):
        if d % (4 * n) or d // n > _MAX_SLICE:
            continue
        m_tiles, stages, _ = _layout(d, n)
        if stages >= 2 and stages * _STAGE_K * (_TILE * m_tiles + 8) * 4 >= _POSE_SLOTS:
            out.append(n)
    return out


def check_limits(b: int, s: int, d: int, f: Optional[int] = None) -> None:
    """Raise ``ValueError`` on a shape the kernels do not take: S above
    36, D not a multiple of 16 in [16, 512], F outside [1, 512]."""
    if b < 0:
        raise ValueError(f"fused_transmlp: batch {b} < 0")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"fused_transmlp: S={s}; the kernel takes 1 <= S <= {MAX_SEQ}")
    if not (DIM_STEP <= d <= MAX_DIM and d % DIM_STEP == 0):
        raise ValueError(f"fused_transmlp: D={d}; the kernel takes a multiple of "
                         f"{DIM_STEP} in [{DIM_STEP}, {MAX_DIM}]")
    if f is not None and not 1 <= f <= MAX_DIM:
        raise ValueError(f"fused_transmlp: F={f}; the kernel takes 1 <= F <= {MAX_DIM}")


def pick_cluster(b: int, d: int, resident: Optional[Dict[int, int]] = None,
                 sizes: Optional[list] = None) -> int:
    """The cluster a stack kernel spreads a sequence over, for B sequences
    at width D: of ``sizes`` (default :func:`forward_cluster_sizes`) with
    Dc >= 64 (below D = 64 one CTA takes the row), the largest whose B
    clusters all run at once, so the batch is spread over the most SMs in
    one wave; a batch too large for one wave of any takes the smallest,
    whose wide column slices pay the fewest cluster barriers and LayerNorm
    exchanges per FLOP (each CTA pays them once a layer in every wave).
    ``resident`` maps a cluster size to the clusters the card holds at once
    (default: an H100 SXM's, ``H100_RESIDENT_CLUSTERS``). At TED's and
    BEAT's D = 512 on an H100 SXM the forward takes 8 CTAs up to 2B = 15, 4
    from 16 (the serving batch) to 30, and 2 from 31 on."""
    resident = H100_RESIDENT_CLUSTERS if resident is None else resident
    sizes = forward_cluster_sizes(d) if sizes is None else sizes
    sizes = [n for n in sizes if d // n >= min(64, d)]
    for n in sizes:
        if b <= resident.get(n, 0):
            return n
    return sizes[-1]


def transmlp_geometry(b: int, s: int, d: int,
                      resident: Optional[Dict[int, int]] = None) -> TransMLPGeometry:
    """The kernel's launch geometry for B sequences of [S, D]; raises
    ``ValueError`` on what the kernel does not take. The cluster is
    :func:`pick_cluster`'s; the weight ring takes the shared memory the
    rest leaves (:func:`_layout`)."""
    check_limits(b, s, d)
    n = pick_cluster(b, d, resident)
    m_tiles, stages, smem = _layout(d, n)
    return TransMLPGeometry(n, d // n, m_tiles, stages, smem, SM_SHARED // (smem + 1024))


def _check(name: str, t: torch.Tensor, shape, device, who: str = "fused_transmlp",
           dtype: torch.dtype = torch.float32, rule: str = "the kernel is f32 only") -> None:
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} is {t.dtype}; {rule}")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


_bound = None
_resident: Dict[tuple, Dict[int, int]] = {}


def _launcher():
    global _bound
    if _bound is None:
        lib = load_library("fused_transmlp")
        fn = lib.fused_transmlp_launch
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # x, emb, 8 weights, out, stash, B, S, D, L, act, cluster, stream
        lib.fused_transmlp_stash_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.fused_transmlp_stash_launch.restype = ctypes.c_int
        query = lib.fused_transmlp_max_clusters
        query.argtypes, query.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        _bound = fn, query, lib.fused_transmlp_stash_launch
    return _bound


def resident_clusters(d: int, device: torch.device) -> Dict[int, int]:
    """Clusters of each size the card holds at once at width D, as the CUDA
    runtime reports them for the kernel (asked once per card and width)."""
    key = (device.index, d)
    if key not in _resident:
        query = _launcher()[1]
        with torch.cuda.device(device):
            counts = {n: query(d, n) for n in forward_cluster_sizes(d)}
        bad = {n: -v for n, v in counts.items() if v < 0}
        if bad:
            raise RuntimeError(f"fused_transmlp: cudaOccupancyMaxActiveClusters failed "
                               f"with cudaError {bad} (D={d})")
        _resident[key] = counts
    return _resident[key]


def fused_transmlp(
    x: torch.Tensor,  # [B, S, D]
    emb: torch.Tensor,  # [B, D] or [B, 1, D]
    packed: Dict[str, torch.Tensor],
    act_name: str = "silu",
    out_proj: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The whole mixer stack; with ``out_proj`` the pose projection is fused
    in and the result is [B, S, F], else [B, S, D]. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises. f32 inputs
    and an f32 pack take the f32 kernel; bf16 ``x`` and ``emb`` and a bf16
    pack take the bf16 kernel; any other mix raises, on either device."""
    _stack_dtype(x, emb, packed, out_proj)
    if x.device.type == "cpu":
        return fused_transmlp_reference(x, emb, packed, act_name, out_proj)
    if x.device.type != "cuda":
        raise ValueError(f"fused_transmlp: no kernel for device {x.device}")
    _act(act_name)  # raises on a name the kernel lacks
    return launch_stack(x, emb, packed, ACTIVATIONS[act_name], out_proj)


# Which tensors a bf16 pack rounds to bf16; the rest stay f32.
BF16_TENSORS = ("x", "emb", "token_w", "ch_w", "out_w")
DTYPE_RULE = ("the kernels take x, emb and the weight matrices all f32, or x, emb, token_w, "
              "ch_w and out_w bf16 with f32 LayerNorm parameters and biases")


def _stack_tensors(x, emb, packed, out_proj) -> Dict[str, torch.Tensor]:
    return {"x": x, "emb": emb, **packed, **(out_proj or {})}


def _stack_dtype(x: torch.Tensor, emb: torch.Tensor, packed: Dict[str, torch.Tensor],
                out_proj: Optional[Dict[str, torch.Tensor]] = None) -> torch.dtype:
    """The route a call takes, float32 or bfloat16 (``x``'s dtype); raises
    ``TypeError`` naming the first tensor that does not fit it."""
    if x.dtype not in DTYPES:
        raise TypeError(f"fused_transmlp: x is {x.dtype}; {DTYPE_RULE}")
    for name, t in _stack_tensors(x, emb, packed, out_proj).items():
        want = x.dtype if name in BF16_TENSORS else torch.float32
        if t.dtype != want:
            raise TypeError(f"fused_transmlp: {name} is {t.dtype} and x is {x.dtype}; "
                            f"{DTYPE_RULE}")
    return x.dtype


def launch_stack(
    x: torch.Tensor,
    emb: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    act_code: int,
    out_proj: Optional[Dict[str, torch.Tensor]] = None,
    cluster: Optional[int] = None,
    group: Optional[int] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with a ``KERNEL_ACT_CODES`` code
    (the training route's no-grad calls also use the leaky relus); checks
    every tensor and raises on what the kernel does not take. ``cluster``
    overrides :func:`transmlp_geometry`'s choice (for measurement); the
    kernel refuses a cluster it cannot take, and the wrapper raises.

    bf16 ``x`` goes to the bf16 kernel (:func:`launch_stack_bf16`), where
    ``cluster`` and ``group`` override :func:`transmlp_bf16_geometry`'s
    choice; the f32 kernel takes no ``group``. Any dtype but f32 and bf16
    raises."""
    if x.dtype == torch.bfloat16:
        return launch_stack_bf16(x, emb, packed, act_code, out_proj, cluster, group)
    if group is not None:
        raise ValueError(f"fused_transmlp: group={group} is for the bf16 kernel; the f32 "
                         "kernel runs one sequence a cluster")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_transmlp: x is {x.dtype}; {DTYPE_RULE}")
    b, s, d = x.shape
    if cluster is None:
        cluster = transmlp_geometry(b, s, d, resident_clusters(d, x.device)).cluster
    emb = emb.reshape(b, d)
    num_layers = packed["token_w"].shape[0]
    folded = "ln2_scale" not in packed
    dev = x.device
    _check("x", x, (b, s, d), dev, rule=DTYPE_RULE)
    _check("emb", emb, (b, d), dev, rule=DTYPE_RULE)
    shapes = {
        "ln1_scale": (num_layers, d), "ln1_bias": (num_layers, d),
        "token_w": (num_layers, s, s), "token_b": (num_layers, s),
        "ch_w": (num_layers, d, d), "ch_b": (num_layers, d),
    }
    if not folded:
        shapes.update(ln2_scale=(num_layers, d), ln2_bias=(num_layers, d))
    for k, shp in shapes.items():
        _check(k, packed[k], shp, dev, rule=DTYPE_RULE)
        if k not in ("token_w", "token_b") and packed[k].data_ptr() % 16:
            raise ValueError(f"fused_transmlp: {k} is not 16-byte aligned")
    if out_proj is not None:
        f = out_proj["out_w"].shape[1]
        _check("out_w", out_proj["out_w"], (d, f), dev, rule=DTYPE_RULE)
        _check("out_b", out_proj["out_b"], (f,), dev, rule=DTYPE_RULE)
        ow, ob = out_proj["out_w"].data_ptr(), out_proj["out_b"].data_ptr()
    else:
        f, ow, ob = d, None, None
    out = torch.empty((b, s, f), dtype=torch.float32, device=dev)
    ptr = lambda k: packed[k].data_ptr() if k in packed else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()[0](
            x.data_ptr(), emb.data_ptr(), ptr("ln1_scale"), ptr("ln1_bias"),
            ptr("token_w"), ptr("token_b"), ptr("ln2_scale"), ptr("ln2_bias"),
            ptr("ch_w"), ptr("ch_b"), ow, ob, out.data_ptr(),
            b, s, d, num_layers, f, act_code, cluster, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_transmlp kernel launch failed with cudaError {err} "
            f"(B={b}, S={s}, D={d}, L={num_layers}, F={f}, cluster={cluster})"
        )
    fused_transmlp.launches += 1
    return out


fused_transmlp.launches = 0
fused_transmlp.bf16_launches = 0  # the bf16 kernel's, counted by launch_stack_bf16

# The bf16 kernel's shared-memory layout (csrc/fused_transmlp_bf16.cu: Layout)
_BF16_ROWS, _BF16_TOK_ROWS, _BF16_MAX_STAGES = 40, 48, 8
BF16_GROUPS = (1, 2)  # sequences a cluster of the bf16 kernel holds
# A wave's fixed time in columns a CTA carries: a wave of the bf16 kernel at
# TED D = 512 took about 0.087 ms + 0.0007 ms a column of group x Dc
# (chip_smoke.bf16_kernel_phase's times of every choice at 2B = 16, H100
# 80GB HBM3 at 700 W).
BF16_WAVE_COLS = 125


class TransMLPBf16Geometry(NamedTuple):
    cluster: int  # CTAs a group of sequences is spread over
    group: int  # sequences a cluster holds; each weight tile feeds all of them
    cols: int  # columns of the residual each CTA owns, D / cluster
    wgmma_n: int  # N of the channel mix's wgmma: 40 rows a sequence of a warpgroup
    stages: int  # stages of the weight ring, as many as the shared memory holds
    smem_bytes: int  # dynamic shared memory of one CTA
    clusters: int  # clusters of the launch, ceil(B / group)


def bf16_cluster_sizes(d: int) -> list:
    """The cluster sizes the bf16 kernel takes at width D, largest first: N
    in {8, 4, 2, 1} with Dc = D/N a whole number of 8-byte loads and at most
    256 columns (two passes of the channel mix over its M-tiles)."""
    return [n for n in (8, 4, 2, 1) if d % (4 * n) == 0 and d // n <= 256]


def _bf16_layout(d: int, cluster: int, group: int) -> tuple:
    """Mirror of ``Layout`` in the bf16 kernel: (ring stages, shared-memory
    bytes)."""
    dc = d // cluster
    r8 = -(-dc // 8) * 8
    xst = hst = r8 + 8
    chunks = -(-d // 64)
    rest = (max(chunks * group * _BF16_ROWS * 128, group * _BF16_TOK_ROWS * hst * 2)
            + group * _BF16_ROWS * xst * 2  # x
            + _BF16_TOK_ROWS * (_BF16_TOK_ROWS + 8) * 2  # token_w
            + 2 * 8 * group * _BF16_ROWS * 2 * 4  # the statistics' exchange
            + 2 * group * _BF16_ROWS * 4  # mean, 1/std
            + group * r8 * 2  # emb
            + 2 * (5 * dc + _BF16_ROWS) * 4  # two layers' small parameters
            + _BF16_MAX_STAGES * 12 + 1024)  # the ring's mbarriers and counters, alignment
    stage = (128 if dc > 64 else 64) * 128
    stages = min(_BF16_MAX_STAGES, max(0, SMEM_LIMIT - rest) // stage)
    return stages, stages * stage + rest


def _bf16_geometry(b: int, d: int, cluster: int, group: int) -> TransMLPBf16Geometry:
    cols = d // cluster
    n = 40 * group if cols > 64 else 40
    stages, smem = _bf16_layout(d, cluster, group)
    return TransMLPBf16Geometry(cluster, group, cols, n, stages, smem, -(-b // group))


def transmlp_bf16_geometry(b: int, s: int, d: int,
                           resident: Optional[Dict[tuple, int]] = None) -> TransMLPBf16Geometry:
    """The bf16 kernel's launch geometry for B sequences of [S, D]; raises
    ``ValueError`` on what the kernel does not take (:func:`check_limits`).
    ``resident`` maps (cluster, group) to the clusters the card holds at
    once (default: an H100 SXM's, ``H100_RESIDENT_CLUSTERS``, one CTA an SM).

    The cluster sizes are :func:`bf16_cluster_sizes` with Dc >= 64 unless D
    is smaller; a group is one or two sequences. It takes the (cluster,
    group) of the least waves x (BF16_WAVE_COLS + group x Dc): a wave of
    clusters takes a fixed time plus one growing with the columns a CTA
    carries (the LayerNorms, the exchanges and the products' epilogues run
    on them), and a group of two halves the clusters and so the L2 reads of
    ``ch_w``. Ties go to the smaller group, then the larger cluster. At TED's
    and BEAT's D = 512 on an H100 SXM that is 8 CTAs up to 2B = 15, 4 CTAs
    from 16 (the serving batch) to 30, then 2 CTAs with one or two
    sequences as the waves fall (two at 2B = 512 and 1,024; ``chip_smoke.py``
    times every choice at 2B in {16, 512})."""
    check_limits(b, s, d)
    if resident is None:
        resident = {(n, g): H100_RESIDENT_CLUSTERS[n] for n in (8, 4, 2, 1) for g in BF16_GROUPS}
    sizes = [n for n in bf16_cluster_sizes(d) if d // n >= min(64, d)]

    def cost(ng):
        n, g = ng
        clusters = -(-b // g)
        waves = -(-clusters // resident[ng])
        return waves * (BF16_WAVE_COLS + g * d // n), g, -n

    n, g = min(((n, g) for n in sizes for g in BF16_GROUPS if resident.get((n, g), 0) > 0),
               key=cost)
    return _bf16_geometry(b, d, n, g)


_bf16_bound = None
_bf16_resident: Dict[tuple, Dict[tuple, int]] = {}


def _bf16_launcher():
    global _bf16_bound
    if _bf16_bound is None:
        lib = load_library("fused_transmlp_bf16")
        fn = lib.fused_transmlp_bf16_launch
        # x, emb, 10 weights, out; B, S, D, L, F, act, cluster, group; stream
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        query = lib.fused_transmlp_bf16_max_clusters
        query.argtypes, query.restype = [ctypes.c_int] * 3, ctypes.c_int
        _bf16_bound = fn, query
    return _bf16_bound


def bf16_resident_clusters(d: int, device: torch.device) -> Dict[tuple, int]:
    """Clusters of each (cluster, group) the card holds at once at width D,
    as the CUDA runtime reports them for the bf16 kernel (asked once per
    card and width)."""
    key = (device.index, d)
    if key not in _bf16_resident:
        query = _bf16_launcher()[1]
        with torch.cuda.device(device):
            counts = {(n, g): query(d, n, g) for n in bf16_cluster_sizes(d) for g in BF16_GROUPS}
        bad = {k: -v for k, v in counts.items() if v < 0}
        if bad:
            raise RuntimeError(f"fused_transmlp: cudaOccupancyMaxActiveClusters failed for the "
                               f"bf16 kernel with cudaError {bad} (D={d})")
        _bf16_resident[key] = counts
    return _bf16_resident[key]


def launch_stack_bf16(
    x: torch.Tensor,
    emb: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    act_code: int,
    out_proj: Optional[Dict[str, torch.Tensor]] = None,
    cluster: Optional[int] = None,
    group: Optional[int] = None,
) -> torch.Tensor:
    """Launch the bf16 kernel (``csrc/fused_transmlp_bf16.cu``) on CUDA
    tensors: bf16 ``x`` [B, S, D] and ``emb``, a bf16 pack; returns bf16
    [B, S, F] with ``out_proj``, else [B, S, D]. ``cluster`` and ``group``
    override :func:`transmlp_bf16_geometry`'s choice (for measurement).
    Checks every tensor and raises on what the kernel does not take."""
    b, s, d = x.shape
    emb = emb.reshape(b, d)
    num_layers = packed["token_w"].shape[0]
    f = out_proj["out_w"].shape[0] if out_proj is not None else None
    check_limits(b, s, d, f)
    if cluster is not None and cluster not in bf16_cluster_sizes(d):
        raise ValueError(f"fused_transmlp: the bf16 kernel takes cluster in "
                         f"{bf16_cluster_sizes(d)} at D={d}, not cluster={cluster}")
    if group is not None and group not in BF16_GROUPS:
        raise ValueError(f"fused_transmlp: the bf16 kernel takes group in {BF16_GROUPS}, "
                         f"not group={group}")
    dev = x.device
    shapes = {
        "x": (b, s, d), "emb": (b, d),
        "ln1_scale": (num_layers, d), "ln1_bias": (num_layers, d),
        "token_w": (num_layers, s, s), "token_b": (num_layers, s),
        "ch_w": (num_layers, d, d), "ch_b": (num_layers, d),
    }
    if "ln2_scale" in packed:
        shapes.update(ln2_scale=(num_layers, d), ln2_bias=(num_layers, d))
    if out_proj is not None:
        shapes.update(out_w=(f, d), out_b=(f,))
    tensors = _stack_tensors(x, emb, packed, out_proj)
    for k, shp in shapes.items():
        want = torch.bfloat16 if k in BF16_TENSORS else torch.float32
        _check(k, tensors[k], shp, dev, dtype=want, rule=DTYPE_RULE)
        if k not in ("token_w", "token_b", "out_b") and tensors[k].data_ptr() % 16:
            raise ValueError(f"fused_transmlp: {k} is not 16-byte aligned")
    if cluster is None or group is None:
        geo = transmlp_bf16_geometry(b, s, d, bf16_resident_clusters(d, dev))
        cluster = geo.cluster if cluster is None else cluster
        group = geo.group if group is None else group
    out = torch.empty((b, s, f or d), dtype=torch.bfloat16, device=dev)
    ptr = lambda k: tensors[k].data_ptr() if k in tensors else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bf16_launcher()[0](
            ptr("x"), ptr("emb"), ptr("ln1_scale"), ptr("ln1_bias"), ptr("token_w"),
            ptr("token_b"), ptr("ln2_scale"), ptr("ln2_bias"), ptr("ch_w"), ptr("ch_b"),
            ptr("out_w"), ptr("out_b"), out.data_ptr(), b, s, d, num_layers, f or 0,
            act_code, cluster, group, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_transmlp bf16 kernel launch failed with cudaError {err} "
            f"(B={b}, S={s}, D={d}, L={num_layers}, F={f}, cluster={cluster}, group={group})")
    fused_transmlp.bf16_launches += 1
    return out
