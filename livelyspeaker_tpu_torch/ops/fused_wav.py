"""The fused WavEncoder conv stack: geometry, packing, the plain PyTorch
forward and backward, the CUDA wrappers, the autograd Function that joins
them and a drop-in module.

Port of ``livelyspeaker_tpu/ops/pallas/fused_wav.py``. The stack is conv0
(k15, stride 5, padded 1600 a side) -> InstanceNorm -> LeakyReLU -> conv1
(stride 6) -> IN -> LReLU -> conv2 (stride 6) -> IN -> LReLU -> conv3
(stride 6); the InstanceNorms have no affine and eps 1e-5. On a CUDA tensor
the kernels of ``csrc/fused_wav.cu`` run (nine forward launches, sixteen
backward ones) or the wrapper raises; on a CPU tensor the plain versions
run. Nothing in the package routes through it by default:
``FusedWavEncoder`` swaps in for a model's ``audio_encoder``.

The kernels read torch's ``Conv1d`` layout, weights ``[C_out, C_in, 15]``
and biases ``[C_out]``, so packing is the parameters themselves, with no
copy. What the backward keeps (the residuals): the waveform, conv1's and
conv2's pre-norm outputs ``m1 [B, T2, 64]`` and ``m2 [B, T3, 128]``, and the
mean and 1/std of the three InstanceNorms, ``st_i [B, 2, C_i]``. conv0's
output is never stored: the kernels recompute it from the waveform.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.audio_encoder import WavEncoder
from . import fused_mlp
from ._build import load_library

__all__ = [
    "WavDims",
    "WavResiduals",
    "PACKED_KEYS",
    "LAUNCHES",
    "pack_wav_params",
    "StatsGeometry",
    "stats_geometry",
    "norm_stats",
    "lrelu_inputs",
    "fused_wav_forward_reference",
    "fused_wav_backward_reference",
    "fused_wav_forward",
    "fused_wav_backward",
    "conv0_live",
    "conv0_stats",
    "Stats0Geometry",
    "stats0_geometry",
    "Wgrad0Geometry",
    "wgrad0_geometry",
    "conv0_backward",
    "conv0_partials",
    "conv_fwd_tiles",
    "forward_weight_split",
    "conv_forward",
    "WgradGeometry",
    "wgrad_geometry",
    "wgrad_partials",
    "ReduceGeometry",
    "reduce_geometry",
    "reduce_partials",
    "bwd_data_rows",
    "data_grad",
    "fused_wav_encoder",
    "FusedWavEncoder",
]

EPS = 1e-5
CHANNELS = (1, 32, 64, 128, 256)
PACKED_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3")
# launches of each CUDA kernel; a forward is stats0 1, wsplit_fwd 3,
# conv_fwd 3, stats 2; a backward is wgrad 3, reduce 4, wsplit 3, bwd_data
# 3, in_bwd 2, wgrad0 1
LAUNCHES = {"stats0": 0, "wsplit_fwd": 0, "conv_fwd": 0, "stats": 0, "wgrad": 0, "reduce": 0,
            "wsplit": 0, "bwd_data": 0, "in_bwd": 0, "wgrad0": 0}
FORWARD_LAUNCHES = {"stats0": 1, "wsplit_fwd": 3, "conv_fwd": 3, "stats": 2}
BACKWARD_LAUNCHES = {"wgrad": 3, "reduce": 4, "wsplit": 3, "bwd_data": 3, "in_bwd": 2,
                     "wgrad0": 1}


BWD_DATA_CHANNELS = 16  # input channels of a data-gradient tile (csrc: kDCW)
FWD_TILE_N = 64  # output channels of a forward conv tile (csrc: kFN)
FWD_STAGE_CHANNELS = 16  # input channels of a forward conv stage (kFC)
# the taps of the forward conv's split weights, slot by slot: residue r's
# taps r, r + 6 (, r + 12) together (csrc: fwd_first, fwd_taps)
FWD_TAP_ORDER = (0, 6, 12, 1, 7, 13, 2, 8, 14, 3, 9, 4, 10, 5, 11)


FWD_TILE_ROWS = 64  # output rows (b, t) of a forward conv tile (csrc: FGeo<2, 2>::kRows)
FWD_SEGMENTS = 4  # sequences a forward conv tile may span (kSeg)


def conv_fwd_tiles(b: int, t_out: int) -> Tuple[int, int]:
    """(tiles, tiles_per_seq) of the forward conv kernel for ``b``
    sequences of ``t_out`` output rows (csrc: fwd_tiles): tiles of 64
    flattened (b, t) rows (tiles_per_seq = 0) where any 64 consecutive rows
    span at most 4 sequences (t_out >= 21), else ceil(t_out / 64) tiles
    inside each sequence."""
    rows = FWD_TILE_ROWS
    if 1 + math.ceil((rows - 1) / t_out) <= FWD_SEGMENTS:
        return math.ceil(b * t_out / rows), 0
    tps = math.ceil(t_out / rows)
    return b * tps, tps


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as the kernels round it (csrc: to_tf32): to
    nearest, ties away from zero, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def _plain_forward_weight_split(w: torch.Tensor) -> torch.Tensor:
    """The plain version of the forward weight split: flat
    [C_in / 16, C_out / 64, 15 slots, 2, 64, 4, 4], each float4
    (hi w[o, c, k], hi w[o, c + 1, k], lo w[o, c, k], lo w[o, c + 1, k]) for
    c = 16 g + 8 h + 2 tq and the slot's tap k (``FWD_TAP_ORDER``)."""
    cout, cin, _ = w.shape
    hi = _tf32(w)
    lo = _tf32(w - hi)
    k = torch.tensor(FWD_TAP_ORDER, device=w.device)

    def arrange(x):  # [C_out, C_in, 15] -> [g, nt, slot, h, o, tq, e], c = 16 g + 8 h + 2 tq + e
        x = x[:, :, k].reshape(cout // FWD_TILE_N, FWD_TILE_N, cin // 16, 2, 4, 2, 15)
        return x.permute(2, 0, 6, 3, 1, 4, 5)

    return torch.cat([arrange(hi), arrange(lo)], dim=-1).contiguous().reshape(-1)


def forward_weight_split(w: torch.Tensor) -> torch.Tensor:
    """Conv weights [C_out, C_in, 15] (C_in a multiple of 16, C_out of 64)
    split into TF32 halves in the order the forward conv kernel reads them:
    the split kernel on a CUDA tensor, the plain version on a CPU one."""
    if w.device.type == "cpu":
        return _plain_forward_weight_split(w)
    cout, cin, _ = w.shape
    wsp = torch.empty(cout * cin * 30, dtype=torch.float32, device=w.device)
    _launch("wsplit_fwd", w.device, w.data_ptr(), cin, cout, wsp.data_ptr(),
            what=f"[{cout}, {cin}, 15]")
    return wsp


def bwd_data_rows(t_in: int, from_wav: bool) -> int:
    """q rows (input times / 6) of a data-gradient tile: 64, or 48 for a
    stored input of at most 48 (csrc: bwd_data_rows)."""
    return 64 if from_wav or math.ceil(t_in / 6) > 48 else 48


def _bwd_data_tiles(t_in: int, from_wav: bool) -> int:
    """Time tiles of the data-gradient kernel a sequence: the ceil(T_in / 6)
    q rows in tiles of ``bwd_data_rows``."""
    return math.ceil(math.ceil(t_in / 6) / bwd_data_rows(t_in, from_wav))


class WavDims:
    """The conv chain's lengths for a waveform of ``length`` samples, as the
    JAX package's ``WavDims`` computes them (k15, strides 5/6/6/6, conv0
    padded 1600 a side); raises ValueError when no output frame is left.
    The TPU kernel's row layout and padding have no counterpart here."""

    def __init__(self, length: int):
        self.L = length
        self.T1 = (length + 3200 - 15) // 5 + 1
        self.T2 = (self.T1 - 15) // 6 + 1
        self.T3 = (self.T2 - 15) // 6 + 1
        self.T4 = (self.T3 - 15) // 6 + 1
        if self.T4 < 1:
            raise ValueError(f"waveform too short: {length}")


class WavResiduals(NamedTuple):
    """What the forward keeps for the backward."""
    wav: torch.Tensor  # [B, L]
    m1: torch.Tensor   # [B, T2, 64] conv1's output, before IN1
    m2: torch.Tensor   # [B, T3, 128] conv2's output, before IN2
    st0: torch.Tensor  # [B, 2, 32] IN0 mean, 1/std
    st1: torch.Tensor  # [B, 2, 64]
    st2: torch.Tensor  # [B, 2, 128]


def pack_wav_params(encoder: nn.Module, differentiable: bool = True) -> Dict[str, torch.Tensor]:
    """A ``WavEncoder``'s conv parameters in the layout the kernels read:
    ``w{i}`` the ``conv{i}.weight`` [C_out, C_in, 15], ``b{i}`` the bias.
    They are the parameters themselves, so the kernels' gradients reach
    them through autograd; ``differentiable=False`` detaches them (for
    inference)."""
    out = {}
    for i in range(4):
        conv = getattr(encoder, f"conv{i}")
        out[f"w{i}"], out[f"b{i}"] = conv.weight, conv.bias
    return out if differentiable else {k: v.detach() for k, v in out.items()}


def _norm_stats(m: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, 2, C]: the InstanceNorm mean and 1/std over time,
    two-pass, as ``models/audio_encoder.py`` takes them."""
    mean = m.mean(-1)
    var = ((m - mean[..., None]) ** 2).mean(-1)
    return torch.stack([mean, torch.rsqrt(var + EPS)], dim=1)


STATS_SMS = 132  # CTAs that fill an H100, one an SM (csrc: kStatsSMs)
STATS_CLUSTER = 8  # the portable cluster size (kStatsCluster)
THREADS = 256  # threads of a statistics or reduce CTA (kThreads)


class StatsGeometry(NamedTuple):
    """The statistics kernel's split of a sequence's T rows: ``cluster``
    CTAs, rank r owning the rows [r rows_per_cta, min(T, (r + 1)
    rows_per_cta))."""
    cluster: int
    rows_per_cta: int


def stats_geometry(b: int, t: int, c: int) -> StatsGeometry:
    """The statistics kernel's cluster for ``b`` sequences of ``t`` rows of
    ``c`` channels (csrc: stats_geometry): as many CTAs a sequence as b of
    them need to fill the card, at most 8 and at most one a step of the
    1024 / c rows a CTA step covers; each CTA a whole number of steps.
    Raises ValueError for shapes the kernel refuses."""
    if b < 1 or not 1 <= t < 2 ** 24 or c not in CHANNELS[1:4]:
        raise ValueError(f"stats_geometry: B={b}, T={t}, C={c}; the kernel takes B >= 1, "
                         "1 <= T < 2^24 and C = 32, 64 or 128")
    rows = THREADS * 4 // c
    steps = math.ceil(t / rows)
    n = max(1, min(STATS_CLUSTER, math.ceil(STATS_SMS / b), steps))
    per = math.ceil(steps / n) * rows
    return StatsGeometry(math.ceil(t / per), per)


def norm_stats(m: torch.Tensor) -> torch.Tensor:
    """The InstanceNorm statistics over time of a stored pre-norm tensor
    m [B, T, C] (C = 32, 64 or 128), as st [B, 2, C] (mean, then 1/std): the
    statistics kernel on a CUDA tensor, the two-pass plain version on a CPU
    one. Raises on what the kernel does not take."""
    if m.device.type == "cpu":
        return _norm_stats(m.transpose(1, 2))
    if m.dim() != 3:
        raise ValueError(f"norm_stats: m has shape {tuple(m.shape)}, expected [B, T, C]")
    b, t, c = m.shape
    stats_geometry(b, t, c)
    fused_mlp._check("m", m, (b, t, c), m.device, "norm_stats")
    st = torch.empty((b, 2, c), dtype=torch.float32, device=m.device)
    _launch("stats", m.device, m.data_ptr(), b, t, c, st.data_ptr(), what=f"[{b}, {t}, {c}]")
    return st


CONV0_BATCH = 32  # times a warp batch of the conv0 kernels (csrc: kC0Batch)
CONV0_GROUP = 4  # times a group (kC0Group)
WGRAD0_WARPS = STATS_SMS * 2 * THREADS // 32  # the warps of two CTAs of 8 an SM of an H100


class Stats0Geometry(NamedTuple):
    """The conv0 statistics kernel's split of a sequence's live times
    [lo, hi) (``conv0_live``): ``cluster`` CTAs, rank r owning [lo + r per,
    min(hi, lo + (r + 1) per)); warp w of a CTA its batches of 32 times at
    offsets 32 w, 32 w + 256, ..."""
    cluster: int
    per: int


def stats0_geometry(b: int, length: int) -> Stats0Geometry:
    """The conv0 statistics kernel's cluster for ``b`` waveforms of
    ``length`` samples, which its launch takes and checks: as many CTAs a
    sequence as b of them need to fill the card, at most 8 and at most one
    a step of the 256 times a CTA's 8 warps cover; each CTA a whole number
    of steps. Depends on (b, length) only."""
    if b < 1 or length < 1:
        raise ValueError(f"stats0_geometry: B={b}, L={length}; the kernel takes B, L >= 1")
    lo, hi = conv0_live(length)
    step = THREADS // 32 * CONV0_BATCH
    steps = math.ceil((hi - lo) / step)
    n = max(1, min(STATS_CLUSTER, math.ceil(STATS_SMS / b), steps))
    per = math.ceil(steps / n) * step
    return Stats0Geometry(math.ceil((hi - lo) / per), per)


class Wgrad0Geometry(NamedTuple):
    """The conv0 backward kernel's split: ``splits`` warps a sequence, warp
    k of the grid owning sequence k // splits and its times [j per,
    min(T1, (j + 1) per)), j = k % splits; ``ctas`` CTAs of 8 warps, one
    partial row each."""
    splits: int
    per: int
    ctas: int

    def ranges(self, t1: int):
        """[(t_begin, t_end)] of a sequence's warps, in order."""
        return [(j * self.per, min(t1, (j + 1) * self.per)) for j in range(self.splits)]


def wgrad0_geometry(b: int, length: int) -> Wgrad0Geometry:
    """The conv0 backward kernel's split for ``b`` waveforms of ``length``
    samples, which its launch takes and checks: as many warps a sequence as
    fill two CTAs of 8 warps an SM when b of them run, at most one a batch
    of 32 times, each a whole number of groups of 4 times. Depends on (b,
    length) only, so the partial rows are summed in the same order every
    run."""
    if not 1 <= b <= 65535 or length < 1:
        raise ValueError(f"wgrad0_geometry: B={b}, L={length}; the kernel takes 1 <= B <= 65535 "
                         "and L >= 1")
    t1 = WavDims(length).T1
    splits = max(1, min(WGRAD0_WARPS // b, math.ceil(t1 / CONV0_BATCH)))
    per = math.ceil(math.ceil(t1 / splits) / CONV0_GROUP) * CONV0_GROUP
    splits = math.ceil(t1 / per)
    return Wgrad0Geometry(splits, per, math.ceil(b * splits / (THREADS // 32)))


def _xhat(m: torch.Tensor, st: torch.Tensor) -> torch.Tensor:
    """[B, C, T] normalised by st [B, 2, C]."""
    return (m - st[:, 0, :, None]) * st[:, 1, :, None]


def conv0_live(length: int) -> Tuple[int, int]:
    """[lo, hi): the conv0 output times whose window reaches a sample of a
    waveform of ``length`` samples. Every other time sees only padding, and
    conv0 there is b0 exactly (csrc: conv0_live)."""
    return (1600 - 15) // 5 + 1, min(WavDims(length).T1, -(-(length + 1600) // 5))


def _conv0(wav: torch.Tensor, packed) -> torch.Tensor:
    """conv0, [B, L] -> [B, 32, T1], summed as the kernels sum it: the bias,
    then the 15 taps in order, each product and each sum rounded. Both
    versions then round every output to the same bits and take the same
    LeakyReLU branch at the kink, where the gradient jumps."""
    x = F.pad(wav, (1600, 1600)).unfold(1, 15, 5)  # [B, T1, 15]
    w = packed["w0"][:, 0]  # [32, 15]
    m = packed["b0"][None, :, None].expand(wav.shape[0], -1, x.shape[1])
    for k in range(15):
        m = m + w[None, :, k, None] * x[:, None, :, k]
    return m


def fused_wav_forward_reference(
    wav: torch.Tensor, packed: Dict[str, torch.Tensor], leak: float = 0.3,
) -> Tuple[torch.Tensor, WavResiduals]:
    """Plain version of the forward kernels: (out [B, T4, 256], residuals),
    on any device and in f32 or f64."""
    fused_wav_forward_reference.calls += 1
    WavDims(wav.shape[1])
    m = _conv0(wav, packed)  # [B, 32, T1]
    stats, pre = [], []
    for i in (1, 2, 3):
        st = _norm_stats(m)
        stats.append(st)
        m = F.conv1d(F.leaky_relu(_xhat(m, st), leak), packed[f"w{i}"], packed[f"b{i}"], stride=6)
        pre.append(m)
    tm = lambda x: x.transpose(1, 2).contiguous()
    return tm(m), WavResiduals(wav, tm(pre[0]), tm(pre[1]), *stats)


fused_wav_forward_reference.calls = 0


def lrelu_inputs(res: WavResiduals, packed: Dict[str, torch.Tensor]):
    """The three InstanceNorm outputs the LeakyReLUs take, [B, C_i, T_i],
    recomputed from the residuals as the backward recomputes them."""
    return [_xhat(_conv0(res.wav, packed), res.st0),
            _xhat(res.m1.transpose(1, 2), res.st1),
            _xhat(res.m2.transpose(1, 2), res.st2)]


def _in_backward(gy, xh, st, mean_gy, mean_gyxh):
    """d/d pre of IN(pre) for the cotangent gy of its output, [B, C, T]:
    inv (gy - mean_t(gy) - xhat mean_t(gy xhat)), the two means [B, C]
    given."""
    return st[:, 1, :, None] * (gy - mean_gy[..., None] - xh * mean_gyxh[..., None])


def _norm_lrelu_backward(g_a, xh, st, leak):
    """d/d pre of lrelu(IN(pre)) for the cotangent g_a of its output, all
    [B, C, T]: gy = g_a lrelu'(xhat), then the InstanceNorm backward."""
    gy = g_a * torch.where(xh > 0, 1.0, leak).to(g_a.dtype)
    return _in_backward(gy, xh, st, gy.mean(-1), (gy * xh).mean(-1))


def _conv_weight_grad(a, g, stride):
    """dW [C_out, C_in, 15] = sum_{b,t} g[b, o, t] a[b, c, stride t + k],
    and db, for a [B, C_in, T_in] and g [B, C_out, T_out]."""
    win = a.unfold(2, 15, stride)[:, :, :g.shape[2]]  # [B, C_in, T_out, 15]
    return torch.einsum("bctk,bot->ock", win, g), g.sum((0, 2))


def fused_wav_backward_reference(
    res: WavResiduals, g: torch.Tensor, packed: Dict[str, torch.Tensor], leak: float = 0.3,
    need_wav_grad: bool = True,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """Plain version of the backward kernels, written out: each stage's
    activation recomputed from the residuals, the LeakyReLU and
    InstanceNorm backward by their formulas, the weight gradients as
    products over unfolded windows and the input gradients as transposed
    convolutions. (d_wav [B, L] or None, gradients keyed as ``packed``)."""
    fused_wav_backward_reference.calls += 1
    d = WavDims(res.wav.shape[1])
    xh = lrelu_inputs(res, packed)
    sts = (res.st0, res.st1, res.st2)
    lengths = (d.T1, d.T2, d.T3, d.T4)
    grads = {}
    g_m = g.transpose(1, 2)  # [B, 256, T4]
    for i in (3, 2, 1):
        grads[f"w{i}"], grads[f"b{i}"] = _conv_weight_grad(F.leaky_relu(xh[i - 1], leak), g_m, 6)
        extra = lengths[i - 1] - ((lengths[i] - 1) * 6 + 15)  # input times no window reaches
        g_a = F.conv_transpose1d(g_m, packed[f"w{i}"], stride=6, output_padding=extra)
        g_m = _norm_lrelu_backward(g_a, xh[i - 1], sts[i - 1], leak)
    d_wav, grads["w0"], grads["b0"] = _conv0_grads(res.wav, g_m, packed, need_wav_grad)
    return d_wav, grads


fused_wav_backward_reference.calls = 0


def _conv0_grads(wav, g_m0, packed, need_wav_grad):
    """(d_wav [B, L] or None, dW0, db0) for the cotangent g_m0 [B, 32, T1]
    of conv0's output: the weight gradient over the padded waveform's
    windows and, for d_wav, the transposed conv."""
    wavp = F.pad(wav, (1600, 1600))[:, None, :]  # [B, 1, L + 3200]
    dw, db = _conv_weight_grad(wavp, g_m0, 5)
    d_wav = None
    if need_wav_grad:
        d_wav = F.conv_transpose1d(g_m0, packed["w0"], stride=5, padding=1600,
                                   output_padding=(wav.shape[1] + 3185) % 5)[:, 0]
    return d_wav, dw, db


_bound: Dict[str, object] = {}


def _launcher(kernel: str):
    if kernel not in _bound:
        lib = load_library("fused_wav")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        src = [i, p, p, i, i, p, p, p, i]  # from_wav, pre, st, T_in, C_in, wav, w0, b0, L
        argtypes = {
            "stats0": [p, p, p, i, i, i, i, i, p],
            "stats": [p, i, i, i, p],
            "wsplit_fwd": [p, i, i, p],
            "conv_fwd": src + [p, p, p, i, i, i, f],
            "wsplit": [p, i, i, p],
            "bwd_data": src + [p, p, i, i, i, f, p, p],
            "in_bwd": [p, p, p, i, i, i, i, p],
            "wgrad": src + [p, i, i, i, f, p, i, i],
            "wgrad0": [p, p, p, i, p, p, p, i, i, i, i, i, p, i, p],
            "reduce": [p, i, i, p],
        }[kernel]
        fn = getattr(lib, f"fused_wav_{kernel}_launch")
        fn.argtypes = argtypes + [p]
        fn.restype = ctypes.c_int
        _bound[kernel] = fn
    return _bound[kernel]


def _launch(kernel: str, dev: torch.device, *args, what: str) -> None:
    """Call the C launch function on the current stream of ``dev``; raise
    on a non-zero cudaError."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(kernel)(*args, stream)
    if err != 0:
        raise RuntimeError(f"fused_wav {kernel} kernel launch failed with cudaError {err} ({what})")
    LAUNCHES[kernel] += 1


def _check_conv0(who: str, wav: torch.Tensor, packed) -> WavDims:
    """Raise on a waveform or conv0 parameters the conv0 kernels do not
    take; the chain's lengths."""
    if wav.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {wav.device}")
    if wav.dim() != 2 or not 1 <= wav.shape[0] <= 65535 or wav.shape[1] < 1:
        raise ValueError(f"{who}: wav has shape {tuple(wav.shape)}, expected [B, L] with a "
                         "batch of 1..65535 and at least one sample")
    d = WavDims(wav.shape[1])
    fused_mlp._check("wav", wav, tuple(wav.shape), wav.device, who)
    fused_mlp._check("w0", packed["w0"], (32, 1, 15), wav.device, who)
    fused_mlp._check("b0", packed["b0"], (32,), wav.device, who)
    return d


def _check_cuda(who: str, wav: torch.Tensor, packed) -> WavDims:
    """Raise on what the kernels do not take; the chain's lengths."""
    d = _check_conv0(who, wav, packed)
    for i in range(1, 4):
        cin, cout = CHANNELS[i], CHANNELS[i + 1]
        fused_mlp._check(f"w{i}", packed[f"w{i}"], (cout, cin, 15), wav.device, who)
        fused_mlp._check(f"b{i}", packed[f"b{i}"], (cout,), wav.device, who)
    return d


def _check_residuals(who: str, res: WavResiduals, d: WavDims) -> None:
    b, dev = res.wav.shape[0], res.wav.device
    for name, t, shape in (("m1", res.m1, (b, d.T2, 64)), ("m2", res.m2, (b, d.T3, 128)),
                           ("st0", res.st0, (b, 2, 32)), ("st1", res.st1, (b, 2, 64)),
                           ("st2", res.st2, (b, 2, 128))):
        fused_mlp._check(name, t, shape, dev, who)


def _src(from_wav: bool, pre, st, t_in: int, c_in: int, wav, packed):
    """The stage-input arguments of the C launch functions."""
    return (int(from_wav), None if pre is None else pre.data_ptr(), st.data_ptr(), t_in, c_in,
            wav.data_ptr(), packed["w0"].data_ptr(), packed["b0"].data_ptr(), wav.shape[1])


def fused_wav_forward(
    wav: torch.Tensor, packed: Dict[str, torch.Tensor], leak: float = 0.3,
) -> Tuple[torch.Tensor, WavResiduals]:
    """(out [B, T4, 256], residuals). A CPU tensor runs the plain version;
    a CUDA tensor launches the nine forward kernels or raises."""
    if wav.device.type == "cpu":
        return fused_wav_forward_reference(wav, packed, leak)
    who = "fused_wav_encoder"
    d = _check_cuda(who, wav, packed)
    b, dev = wav.shape[0], wav.device
    f32 = dict(dtype=torch.float32, device=dev)
    m1 = torch.empty((b, d.T2, 64), **f32)
    m2 = torch.empty((b, d.T3, 128), **f32)
    out = torch.empty((b, d.T4, 256), **f32)
    sts = [conv0_stats(wav, packed)]
    for i, (pre, y) in enumerate(((None, m1), (m1, m2), (m2, out)), start=1):
        if pre is not None:
            sts.append(norm_stats(pre))
        _conv_forward(i, wav, pre, sts[-1], packed, leak, d, y)
    return out, WavResiduals(wav, m1, m2, *sts)


def conv0_stats(wav: torch.Tensor, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """IN0's statistics st0 [B, 2, 32] (mean, then 1/std over time) of
    conv0's output over the waveform wav [B, L], which is never stored: the
    statistics kernel on a CUDA tensor, the two-pass plain version over the
    plain conv0 on a CPU one. Raises on what the kernel does not take."""
    if wav.device.type == "cpu":
        return _norm_stats(_conv0(wav, packed))
    d = _check_conv0("conv0_stats", wav, packed)
    b = wav.shape[0]
    geo = stats0_geometry(b, d.L)
    st0 = torch.empty((b, 2, 32), dtype=torch.float32, device=wav.device)
    _launch("stats0", wav.device, wav.data_ptr(), packed["w0"].data_ptr(),
            packed["b0"].data_ptr(), d.L, d.T1, b, geo.cluster, geo.per, st0.data_ptr(),
            what=f"B={b}, L={d.L}")
    return st0


def _conv_forward(i, wav, pre, st, packed, leak, d: WavDims, y) -> None:
    """Conv i's (1..3) forward launches on tensors already checked: its
    weights split, then the conv into y [B, T_i, C_out]."""
    lengths = (d.T1, d.T2, d.T3, d.T4)
    cin, cout, b = CHANNELS[i], CHANNELS[i + 1], wav.shape[0]
    wsp = forward_weight_split(packed[f"w{i}"])
    _launch("conv_fwd", wav.device, *_src(i == 1, pre, st, lengths[i - 1], cin, wav, packed),
            wsp.data_ptr(), packed[f"b{i}"].data_ptr(), y.data_ptr(), b, lengths[i], cout, leak,
            what=f"B={b}, L={d.L}, conv{i}")


def conv_forward(i: int, res: WavResiduals, packed: Dict[str, torch.Tensor],
                 leak: float = 0.3) -> torch.Tensor:
    """Conv ``i``'s (1..3) output [B, T_i, C_out] over its input
    lrelu(IN(pre)), the input taken from the residuals (conv1's recomputed
    from the waveform). On the card two launches: the weights split into
    TF32 halves, then the forward conv kernel (3xTF32 on the tensor cores);
    a CPU tensor runs the plain conv."""
    wav = res.wav
    pre, st = (None, res.m1, res.m2)[i - 1], (res.st0, res.st1, res.st2)[i - 1]
    if wav.device.type == "cpu":
        m = _conv0(wav, packed) if i == 1 else pre.transpose(1, 2).contiguous()
        a = F.leaky_relu(_xhat(m, st), leak)
        return F.conv1d(a, packed[f"w{i}"], packed[f"b{i}"], stride=6).transpose(1, 2).contiguous()
    d = _check_cuda("conv_forward", wav, packed)
    _check_residuals("conv_forward", res, d)
    y = torch.empty((wav.shape[0], (d.T1, d.T2, d.T3, d.T4)[i], CHANNELS[i + 1]),
                    dtype=torch.float32, device=wav.device)
    _conv_forward(i, wav, pre, st, packed, leak, d, y)
    return y


WGRAD_STAGE = 32  # rows (b, t) of a stage (csrc: kGRows)
WGRAD_SEGMENTS = 4  # sequences a stage may span (kGSeg)
WGRAD_TILE = (16, 64)  # input and output channels of an output tile (kGC, kGN)
WGRAD_WAVE = 132  # CTAs the card runs at once: one an SM of an H100
WGRAD_MIN_STAGES = 4  # stages a chunk takes at least, where the rows allow


class WgradGeometry(NamedTuple):
    """The weight-gradient launch of one conv: ``tiles`` output tiles of
    16 input channels x 15 taps by 64 output channels, the B*T rows cut into
    ``nsplit`` chunks of ``rows_per_split`` (a multiple of 32), one CTA a
    tile and chunk."""
    tiles: int
    nsplit: int
    rows_per_split: int

    def bounds(self, rows: int):
        """Chunk j holds the rows [bounds[j], bounds[j + 1])."""
        return [min(rows, j * self.rows_per_split) for j in range(self.nsplit + 1)]


def wgrad_geometry(b: int, t_out: int, c_in: int, c_out: int) -> WgradGeometry:
    """Tiles and row chunks of the weight-gradient kernel for a conv from
    ``c_in`` to ``c_out`` channels over ``b`` sequences of ``t_out`` output
    times: as many chunks of whole 32-row stages as fill one wave of the
    card with the tiles, each at least 4 stages where the rows allow.
    Depends on the shapes only, so the partials are
    summed in the same order every run. Raises ValueError for shapes the
    kernel refuses."""
    if b < 1 or t_out < 1:
        raise ValueError(f"wgrad_geometry: B={b}, T={t_out}; the kernel takes B, T >= 1")
    if c_in not in (32, 64, 128):
        raise ValueError(f"wgrad_geometry: C_in={c_in}; the kernel takes 32, 64 or 128")
    if c_out < WGRAD_TILE[1] or c_out % WGRAD_TILE[1]:
        raise ValueError(f"wgrad_geometry: C_out={c_out}; the kernel takes multiples of 64")
    rows = b * t_out
    if rows > 2 ** 31 - 1:
        raise ValueError(f"wgrad_geometry: B*T={rows} rows; the kernel takes < 2^31")
    tiles = c_in // WGRAD_TILE[0] * (c_out // WGRAD_TILE[1])
    steps = math.ceil(rows / WGRAD_STAGE)
    nsplit = max(1, min(math.ceil(steps / WGRAD_MIN_STAGES), WGRAD_WAVE // tiles))
    per = math.ceil(steps / nsplit) * WGRAD_STAGE
    return WgradGeometry(tiles, math.ceil(rows / per), per)


def wgrad_partials(i: int, res: WavResiduals, g: torch.Tensor, packed: Dict[str, torch.Tensor],
                   leak: float = 0.3) -> torch.Tensor:
    """Conv ``i``'s (1..3) weight- and bias-gradient partials on the card:
    one launch of the weight-gradient kernel (3xTF32 on the tensor cores,
    ``wgrad_geometry``'s chunks) for the cotangent ``g``
    [B, T_i, C_out] of conv i's output, over its input lrelu(IN(pre))
    recomputed from the residuals. Returns part [nsplit, C_out*C_in*15 +
    C_out], each row dW (torch's layout) then db over one chunk of the
    B*T_i rows; ``reduce_partials`` sums them. A CPU tensor runs the plain
    version, one chunk of all the rows."""
    wav = res.wav
    if g.device.type == "cpu":  # the plain version: one chunk of all the rows
        pre = _conv0(wav, packed) if i == 1 else (res.m1, res.m2)[i - 2].transpose(1, 2)
        a = F.leaky_relu(_xhat(pre, (res.st0, res.st1, res.st2)[i - 1]), leak)
        dw, db = _conv_weight_grad(a, g.transpose(1, 2), 6)
        return torch.cat([dw.reshape(-1), db])[None]
    d = _check_cuda("wgrad_partials", wav, packed)
    _check_residuals("wgrad_partials", res, d)
    t_out = (d.T1, d.T2, d.T3, d.T4)[i]
    fused_mlp._check("g", g, (wav.shape[0], t_out, CHANNELS[i + 1]), wav.device, "wgrad_partials")
    return _wgrad_partials(i, res, g, packed, leak, d)


def _wgrad_partials(i, res: WavResiduals, g, packed, leak, d: WavDims) -> torch.Tensor:
    """wgrad_partials' launch on tensors already checked."""
    wav = res.wav
    b, lengths = wav.shape[0], (d.T1, d.T2, d.T3, d.T4)
    cin, cout, t_in, t_out = CHANNELS[i], CHANNELS[i + 1], lengths[i - 1], lengths[i]
    pre, st = (None, res.m1, res.m2)[i - 1], (res.st0, res.st1, res.st2)[i - 1]
    _, nsplit, per = wgrad_geometry(b, t_out, cin, cout)
    part = torch.empty((nsplit, cout * cin * 15 + cout), dtype=torch.float32, device=wav.device)
    _launch("wgrad", wav.device, *_src(i == 1, pre, st, t_in, cin, wav, packed), g.data_ptr(), b,
            t_out, cout, leak, part.data_ptr(), nsplit, per, what=f"B={b}, L={d.L}, conv{i}")
    return part


REDUCE_CTAS = 264  # two CTAs an SM of an H100 (csrc: kRedCtas)
REDUCE_MIN_VECTORS = 4  # column vectors a reduce CTA at least (kRedMinQ)


class ReduceGeometry(NamedTuple):
    """The reduce kernel's grouping of part [n, width]: columns in vectors
    of ``vec`` (4: float4 loads, or 1), ``vectors`` adjacent vectors a CTA,
    the rows in groups of ``rows`` (the last one may be shorter), summed
    in order each and then in group order; ``ctas`` CTAs."""
    vec: int
    vectors: int
    rows: int
    ctas: int


def reduce_geometry(n: int, width: int) -> ReduceGeometry:
    """The reduce kernel's grouping for ``n`` rows of ``width`` columns
    (csrc: reduce_geometry): vectors a CTA halve from 256 (twice the row
    groups) while the CTAs are fewer than two an SM and there are rows for
    twice the groups, down to 4. Depends on (n, width) only."""
    if n < 1 or width < 1:
        raise ValueError(f"reduce_geometry: n={n}, width={width}; the kernel takes n, width >= 1")
    vec = 4 if width % 4 == 0 else 1
    cols = width // vec
    q = THREADS
    while q > REDUCE_MIN_VECTORS and math.ceil(cols / q) < REDUCE_CTAS and 2 * (THREADS // q) <= n:
        q //= 2
    return ReduceGeometry(vec, q, math.ceil(n / (THREADS // q)), math.ceil(cols / q))


def _plain_reduce(part: torch.Tensor) -> torch.Tensor:
    """part [n, width] summed over its rows in the reduce kernel's grouping:
    each group of ``reduce_geometry(n, width).rows`` rows in order, then the
    groups in order; the kernel's bits."""
    rows = reduce_geometry(*part.shape).rows
    total = None
    for j0 in range(0, part.shape[0], rows):
        s = part[j0].clone()
        for row in part[j0 + 1:j0 + rows]:
            s = s + row
        total = s if total is None else total + s
    return total


def reduce_partials(part: torch.Tensor, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW_i, db_i) from conv i's (0..3) partials [n, C_out*C_in*15 +
    C_out], the rows summed in ``reduce_geometry``'s grouping: the reduce
    kernel on the card, the same sums in the same order on the CPU."""
    cout, cin = CHANNELS[i + 1], CHANNELS[i]
    width = cout * cin * 15 + cout
    if part.device.type == "cpu":
        flat = _plain_reduce(part)
    else:
        fused_mlp._check("part", part, (part.shape[0], width), part.device, "reduce_partials")
        reduce_geometry(part.shape[0], width)
        flat = torch.empty(width, dtype=torch.float32, device=part.device)
        _launch("reduce", part.device, part.data_ptr(), part.shape[0], width, flat.data_ptr(),
                what=f"conv{i}")
    return flat[:cout * cin * 15].view(cout, cin, 15), flat[cout * cin * 15:]


def _plain_data_grad(g, w, xh, t_in, leak):
    """The plain data gradient of one conv: g [B, T_out, C_out], xh [B, C_in,
    T_in]; (gy [B, T_in, C_in], sums [B, 1, 2, C_in])."""
    extra = t_in - ((g.shape[1] - 1) * 6 + 15)  # input times no window reaches
    g_a = F.conv_transpose1d(g.transpose(1, 2), w, stride=6, output_padding=extra)
    gy = g_a * torch.where(xh > 0, 1.0, leak).to(g_a.dtype)
    sums = torch.stack([gy.sum(-1), (gy * xh).sum(-1)], dim=1)[:, None]
    return gy.transpose(1, 2).contiguous(), sums


def data_grad(i: int, res: WavResiduals, g: torch.Tensor, packed: Dict[str, torch.Tensor],
              leak: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv ``i``'s (1..3) data gradient through its input's LeakyReLU, for
    the cotangent ``g`` [B, T_i, C_out] of conv i's output:
    gy = lrelu'(xhat) * conv_i^T g, [B, T_in, C_in], with xhat recomputed
    from the residuals, and the per-tile sums of gy and gy * xhat over
    time, [B, ntq, 2, C_in], that the InstanceNorm backward reads. On the
    card two launches: the weights split into TF32 halves, then the
    data-gradient kernel (3xTF32 on the tensor cores, tiles of
    ``bwd_data_rows`` q rows of one sequence); a CPU tensor runs the plain
    version, one tile of all the times."""
    wav = res.wav
    if g.device.type == "cpu":
        xh = lrelu_inputs(res, packed)[i - 1]
        return _plain_data_grad(g, packed[f"w{i}"], xh, xh.shape[2], leak)
    d = _check_cuda("data_grad", wav, packed)
    _check_residuals("data_grad", res, d)
    t_out = (d.T1, d.T2, d.T3, d.T4)[i]
    fused_mlp._check("g", g, (wav.shape[0], t_out, CHANNELS[i + 1]), wav.device, "data_grad")
    return _data_grad(i, res, g, packed, leak, d)


def _data_grad(i, res: WavResiduals, g, packed, leak, d: WavDims):
    """data_grad's launches on tensors already checked."""
    wav = res.wav
    b, lengths = wav.shape[0], (d.T1, d.T2, d.T3, d.T4)
    cin, cout, t_in, t_out = CHANNELS[i], CHANNELS[i + 1], lengths[i - 1], lengths[i]
    pre, st = (None, res.m1, res.m2)[i - 1], (res.st0, res.st1, res.st2)[i - 1]
    f32 = dict(dtype=torch.float32, device=wav.device)
    what = f"B={b}, L={d.L}, conv{i}"
    cw = BWD_DATA_CHANNELS
    wsp = torch.empty((cout // 8, cin // cw, 15, cw, 8, 2), **f32)  # csrc: wav_wsplit_kernel
    _launch("wsplit", wav.device, packed[f"w{i}"].data_ptr(), cin, cout, wsp.data_ptr(),
            what=what)
    gy = torch.empty((b, t_in, cin), **f32)
    sums = torch.empty((b, _bwd_data_tiles(t_in, i == 1), 2, cin), **f32)
    _launch("bwd_data", wav.device, *_src(i == 1, pre, st, t_in, cin, wav, packed),
            wsp.data_ptr(), g.data_ptr(), b, t_out, cout, leak, gy.data_ptr(), sums.data_ptr(),
            what=what)
    return gy, sums


def fused_wav_backward(
    res: WavResiduals, g: torch.Tensor, packed: Dict[str, torch.Tensor], leak: float = 0.3,
    need_wav_grad: bool = True,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """(d_wav [B, L] or None, gradients keyed as ``packed``) for the output
    cotangent ``g`` [B, T4, 256]. A CPU tensor runs the plain version; a
    CUDA tensor launches the sixteen backward kernels or raises."""
    if g.device.type == "cpu":
        return fused_wav_backward_reference(res, g, packed, leak, need_wav_grad)
    who = "fused_wav_encoder backward"
    d = _check_cuda(who, res.wav, packed)
    fused_mlp._check("g", g, (res.wav.shape[0], d.T4, 256), g.device, who)
    _check_residuals(who, res, d)
    grads, gy1, sums = _stack_backward(res, g, packed, leak, d)
    d_wav, grads["w0"], grads["b0"] = conv0_backward(res, gy1, sums, packed, need_wav_grad)
    return d_wav, grads


def _stack_backward(res: WavResiduals, g, packed, leak, d: WavDims):
    """The backward's launches for conv3, conv2 and conv1 on tensors already
    checked: (their gradients, gy1 [B, T1, 32], sums [B, ntq, 2, 32]), gy1
    the cotangent of IN0's output through LeakyReLU and sums its tile sums
    of gy1 and gy1 xhat0."""
    wav = res.wav
    b, dev = wav.shape[0], wav.device
    lengths = (d.T1, d.T2, d.T3, d.T4)
    what = f"B={b}, L={d.L}"
    pres, sts = (None, res.m1, res.m2), (res.st0, res.st1, res.st2)
    grads = {}
    g_m = g
    for i in (3, 2, 1):
        cin, t_in = CHANNELS[i], lengths[i - 1]
        part = _wgrad_partials(i, res, g_m, packed, leak, d)
        grads[f"w{i}"], grads[f"b{i}"] = reduce_partials(part, i)
        gy, sums = _data_grad(i, res, g_m, packed, leak, d)
        if i > 1:  # the InstanceNorm backward in place: gy becomes g_m
            _launch("in_bwd", dev, pres[i - 1].data_ptr(), sts[i - 1].data_ptr(),
                    sums.data_ptr(), sums.shape[1], b, t_in, cin, gy.data_ptr(),
                    what=f"{what}, IN{i - 1}")
            g_m = gy
    return grads, gy, sums


def conv0_backward(res: WavResiduals, gy1: torch.Tensor, sums: torch.Tensor,
                   packed: Dict[str, torch.Tensor], need_wav_grad: bool = True,
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """conv0's backward through IN0: (d_wav [B, L] or None, dW0 [32, 1, 15],
    db0 [32]) for gy1 [B, T1, 32], the cotangent of IN0's output, and its
    tile sums [B, ntq, 2, 32] of gy1 and gy1 xhat0 over time (conv1's data
    gradient gives both): ``conv0_partials``, then the partials summed by
    ``reduce_partials``."""
    d_wav, part = conv0_partials(res, gy1, sums, packed, need_wav_grad)
    dw0, db0 = reduce_partials(part, 0)
    return d_wav, dw0, db0


def conv0_partials(res: WavResiduals, gy1: torch.Tensor, sums: torch.Tensor,
                   packed: Dict[str, torch.Tensor], need_wav_grad: bool = True,
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(d_wav or None, part [rows, 512]) of ``conv0_backward``: g_m0 =
    inv0 (gy1 - mean(gy1) - xhat0 mean(gy1 xhat0)), xhat0 from conv0
    recomputed and st0, then d_wav and the partial sums of dW0 (torch's
    layout) and db0, a row each. On the card one launch of the conv0
    backward kernel; a CPU tensor runs the plain version, one row."""
    wav = res.wav
    if gy1.device.type == "cpu":
        xh = _xhat(_conv0(wav, packed), res.st0)
        tot = sums.sum(1) / gy1.shape[1]  # [B, 2, 32]: mean(gy1), mean(gy1 xhat0)
        g_m0 = _in_backward(gy1.transpose(1, 2), xh, res.st0, tot[:, 0], tot[:, 1])
        d_wav, dw, db = _conv0_grads(wav, g_m0, packed, need_wav_grad)
        return d_wav, torch.cat([dw.reshape(-1), db])[None]
    who = "conv0_backward"
    d = _check_conv0(who, wav, packed)
    b = wav.shape[0]
    fused_mlp._check("st0", res.st0, (b, 2, 32), wav.device, who)
    fused_mlp._check("gy1", gy1, (b, d.T1, 32), wav.device, who)
    if sums.dim() != 4 or sums.shape[1] < 1:
        raise ValueError(f"{who}: sums has shape {tuple(sums.shape)}, expected [B, ntq, 2, 32]")
    fused_mlp._check("sums", sums, (b, sums.shape[1], 2, 32), wav.device, who)
    f32 = dict(dtype=torch.float32, device=wav.device)
    d_wav = torch.empty((b, d.L), **f32) if need_wav_grad else None
    geo = wgrad0_geometry(b, d.L)
    part = torch.empty((geo.ctas, 32 * 15 + 32), **f32)
    _launch("wgrad0", wav.device, wav.data_ptr(), packed["w0"].data_ptr(),
            packed["b0"].data_ptr(), d.L, res.st0.data_ptr(), gy1.data_ptr(), sums.data_ptr(),
            sums.shape[1], b, d.T1, geo.splits, geo.per, part.data_ptr(), geo.ctas,
            None if d_wav is None else d_wav.data_ptr(), what=f"B={b}, L={d.L}, conv0")
    return d_wav, part


class _FusedWav(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wav, leak, *weights):
        packed = dict(zip(PACKED_KEYS, weights))
        out, res = fused_wav_forward(wav, packed, leak)
        ctx.leak = leak
        ctx.save_for_backward(*res, *weights)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        res, weights = WavResiduals(*saved[:6]), saved[6:]
        d_wav, grads = fused_wav_backward(res, g.contiguous(), dict(zip(PACKED_KEYS, weights)),
                                          ctx.leak, need_wav_grad=ctx.needs_input_grad[0])
        return (d_wav, None, *[grads[k] for k in PACKED_KEYS])


def fused_wav_encoder(
    wav: torch.Tensor,  # [B, L] float
    packed: Dict[str, torch.Tensor],
    leak: float = 0.3,
) -> torch.Tensor:
    """The WavEncoder conv stack, [B, L] -> [B, T4, 256], differentiable
    with the hand-written backward. f32 only on the card (the plain version
    also takes float64). ``d_wav`` is computed only when ``wav`` needs a
    gradient. The JAX function's ``batch_tile`` is a TPU grid parameter
    with no counterpart here."""
    if wav.dtype in (torch.bfloat16, torch.float16):
        raise TypeError(f"fused_wav_encoder: wav is {wav.dtype}; the kernels are f32 only")
    weights = [packed[k] for k in PACKED_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (wav, *weights)):
        return _FusedWav.apply(wav.contiguous(), leak, *weights)
    return fused_wav_forward(wav.contiguous(), packed, leak)[0]


class FusedWavEncoder(nn.Module):
    """Drop-in for a ``WavEncoder`` through :func:`fused_wav_encoder`.

    It holds the encoder's own ``conv0..conv3`` modules, so the state_dict
    keys and the ``Parameter`` objects are the encoder's: an optimizer built
    before or after ``model.audio_encoder = FusedWavEncoder(model.audio_encoder)``
    updates the same tensors. f32 only, as the kernels are."""

    def __init__(self, encoder: WavEncoder):
        super().__init__()
        if encoder.dtype != torch.float32:
            raise TypeError(f"FusedWavEncoder: the encoder computes in {encoder.dtype}; "
                            "the fused stack is f32 only")
        self.leak = encoder.leak
        self.dtype = torch.float32
        for i in range(4):
            self.add_module(f"conv{i}", getattr(encoder, f"conv{i}"))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if not wav.is_floating_point():
            wav = wav.to(torch.float32) * (1.0 / 32768.0)
        packed = pack_wav_params(self, differentiable=torch.is_grad_enabled())
        return fused_wav_encoder(wav.to(torch.float32), packed, self.leak)
