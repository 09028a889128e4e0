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
    "fused_transmlp",
    "launch_stack",
    "TransMLPGeometry",
    "cluster_sizes",
    "transmlp_geometry",
    "resident_clusters",
]

# activation name -> the kernel's Act code (csrc/transmlp_common.cuh)
KERNEL_ACT_CODES = {"silu": 0, "relu": 1, "gelu": 2, "lrelu": 3, "lrelu01": 4, "lrelu02": 5}
# what fused_transmlp takes, as the JAX kernel does; any other name raises
ACTIVATIONS = {k: KERNEL_ACT_CODES[k] for k in ("silu", "relu", "gelu")}


@torch.no_grad()
def pack_transmlp_params(backbone, fold_ln2: bool = False) -> Dict[str, torch.Tensor]:
    """Stack a ``TransMLP``'s per-block weights into layer-major tensors.

    The channel mix is stored ``[L, D_in, D_out]``. ``fold_ln2=True`` folds
    LN2's affine into it, ``(z*g + beta) @ W == z @ (g[:, None] * W) +
    beta @ W``; the bias fold uses the unscaled W. The returned dict then has
    no ``ln2_*`` keys, which is how the kernel tells the layouts apart."""
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
    out["ch_w"] = ch_w.contiguous()
    out["ch_b"] = ch_b.contiguous()
    return out


@torch.no_grad()
def pack_out_proj(layer: torch.nn.Linear) -> Dict[str, torch.Tensor]:
    """A ``[D] -> [F]`` Linear as ``{'out_w': [D, F], 'out_b': [F]}``."""
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
    """Plain PyTorch version of the kernel, on any device."""
    fused_transmlp_reference.calls += 1
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

# The kernel's limits and its shared-memory layout (csrc/fused_transmlp.cu)
MAX_SEQ, MAX_DIM, DIM_STEP = 36, 512, 16
_THREADS, _RING_FLOATS, _BARS, _MAX_COLS, _MAX_SLICES, _TILE = 256, 24576, 51, 128, 8, (9, 8)
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
    k_slices: int  # K-slices of the channel mix's 9 x 8 register tiles
    smem_bytes: int  # dynamic shared memory of one CTA
    ctas_per_sm: int  # as the shared memory allows


def _smem_bytes(d: int, cluster: int) -> int:
    """Mirror of ``Smem::bytes`` in the kernel."""
    dp, dc, spad = d + 4, d // cluster, MAX_SEQ
    params = spad * spad + spad + 5 * dc  # one layer's token mix, biases, affines
    floats = (_RING_FLOATS + max(spad * dp, _THREADS * (_TILE[0] * _TILE[1] + 4)) + spad * dc
              + 2 * params + dc + 2 * 8 * spad * 2 + 2 * spad)
    return -(-_BARS * 8 // 128) * 128 + 4 * floats


def cluster_sizes(d: int) -> list:
    """The cluster sizes the kernel takes at width D, largest first: N in
    {8, 4, 2, 1} with Dc = D/N a whole number of 16-byte loads and at most
    128 columns (the shared memory)."""
    return [n for n in (8, 4, 2, 1) if d % (4 * n) == 0 and d // n <= _MAX_COLS]


def _geometry(d: int, cluster: int) -> TransMLPGeometry:
    dc = d // cluster
    per_slice = 4 * -(-dc // _TILE[1])  # 4 row groups x the column groups of a tile
    smem = _smem_bytes(d, cluster)
    k_slices = min(_MAX_SLICES, _THREADS // per_slice)
    return TransMLPGeometry(cluster, dc, k_slices, smem, SM_SHARED // (smem + 1024))


def transmlp_geometry(b: int, s: int, d: int,
                      resident: Optional[Dict[int, int]] = None) -> TransMLPGeometry:
    """The kernel's launch geometry for B sequences of [S, D]; raises
    ``ValueError`` on what the kernel does not take. ``resident`` maps a
    cluster size to the clusters the card holds at once (default: an H100
    SXM's, ``H100_RESIDENT_CLUSTERS``).

    Of the sizes :func:`cluster_sizes` allows with Dc >= 64 (a K-slice of the
    channel mix is then whole warps; below D = 64 one CTA takes the row),
    it is the largest whose B clusters all run at once: the batch is spread
    over the most SMs in one wave. A batch too large for one wave of any
    takes the smallest, whose wide column slices pay the fewest cluster
    barriers and LayerNorm exchanges per FLOP. At TED's and BEAT's D = 512
    on an H100 SXM that is 8 CTAs up to 2B = 15 and 4 from 2B = 16, the
    serving batch, on (``chip_smoke.py`` times 8 against 4)."""
    if b < 0:
        raise ValueError(f"fused_transmlp: batch {b} < 0")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"fused_transmlp: S={s}; the kernel takes 1 <= S <= {MAX_SEQ}")
    if not (DIM_STEP <= d <= MAX_DIM and d % DIM_STEP == 0):
        raise ValueError(f"fused_transmlp: D={d}; the kernel takes a multiple of "
                         f"{DIM_STEP} in [{DIM_STEP}, {MAX_DIM}]")
    resident = H100_RESIDENT_CLUSTERS if resident is None else resident
    sizes = [n for n in cluster_sizes(d) if d // n >= min(64, d)]
    for n in sizes:
        if b <= resident.get(n, 0):
            return _geometry(d, n)
    return _geometry(d, sizes[-1])


def _check(name: str, t: torch.Tensor, shape, device, who: str = "fused_transmlp") -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{who}: {name} is {t.dtype}; the kernel is f32 only")
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
        query = lib.fused_transmlp_max_clusters
        query.argtypes, query.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        _bound = fn, query
    return _bound


def resident_clusters(d: int, device: torch.device) -> Dict[int, int]:
    """Clusters of each size the card holds at once at width D, as the CUDA
    runtime reports them for the kernel (asked once per card and width)."""
    key = (device.index, d)
    if key not in _resident:
        query = _launcher()[1]
        with torch.cuda.device(device):
            counts = {n: query(d, n) for n in cluster_sizes(d)}
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
    plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return fused_transmlp_reference(x, emb, packed, act_name, out_proj)
    if x.device.type != "cuda":
        raise ValueError(f"fused_transmlp: no kernel for device {x.device}")
    _act(act_name)  # raises on a name the kernel lacks
    return launch_stack(x, emb, packed, ACTIVATIONS[act_name], out_proj)


def launch_stack(
    x: torch.Tensor,
    emb: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    act_code: int,
    out_proj: Optional[Dict[str, torch.Tensor]] = None,
    cluster: Optional[int] = None,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with a ``KERNEL_ACT_CODES`` code
    (the training route's no-grad calls also use the leaky relus); checks
    every tensor and raises on what the kernel does not take. ``cluster``
    overrides :func:`transmlp_geometry`'s choice (for measurement); the
    kernel refuses a cluster it cannot take, and the wrapper raises."""
    b, s, d = x.shape
    if cluster is None:
        cluster = transmlp_geometry(b, s, d, resident_clusters(d, x.device)).cluster
    emb = emb.reshape(b, d)
    num_layers = packed["token_w"].shape[0]
    folded = "ln2_scale" not in packed
    dev = x.device
    _check("x", x, (b, s, d), dev)
    _check("emb", emb, (b, d), dev)
    shapes = {
        "ln1_scale": (num_layers, d), "ln1_bias": (num_layers, d),
        "token_w": (num_layers, s, s), "token_b": (num_layers, s),
        "ch_w": (num_layers, d, d), "ch_b": (num_layers, d),
    }
    if not folded:
        shapes.update(ln2_scale=(num_layers, d), ln2_bias=(num_layers, d))
    for k, shp in shapes.items():
        _check(k, packed[k], shp, dev)
        if k not in ("token_w", "token_b") and packed[k].data_ptr() % 16:
            raise ValueError(f"fused_transmlp: {k} is not 16-byte aligned")
    if out_proj is not None:
        f = out_proj["out_w"].shape[1]
        _check("out_w", out_proj["out_w"], (d, f), dev)
        _check("out_b", out_proj["out_b"], (f,), dev)
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
