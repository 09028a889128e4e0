"""The grouped SwiGLU of the language-model text tower: the plain PyTorch
version and the CUDA wrapper.

``grouped_swiglu(x, w_gate, w_up, w_down, offsets, dest, scale)`` computes,
for the rows p of each group g (rows ``offsets[g]`` to ``offsets[g + 1]``
of x, sorted by group),

    y[p] = (silu(x[p] w_gate[g]^T) * (x[p] w_up[g]^T)) w_down[g]^T

and writes ``scale[dest[p]] * y[p]`` to row ``dest[p]`` of the result
(``dest`` None: row p; ``scale`` None: 1). The weights are stacked packs,
``[G, N, K]`` for the gate and up projections and ``[G, K, N]`` for the
down projection, as ``models/moe_text.py`` holds its experts; a single
SwiGLU (the shared experts, a dense layer) is one group of every row, with
``offsets`` None. A CPU tensor runs the plain version; a CUDA tensor
launches the two kernels of ``csrc/grouped_swiglu.cu`` (gate-up, then
down) or raises. The kernels read the offsets on the card: the host never
learns the groups' sizes.

The kernels walk (group, row tile, column tile) tiles: a group's rows are
rounded up to whole row tiles, whose rows past the group are computed and
not written. ``tile_rows``, an int64 counter on the card, has the rows so
computed added to it at each launch (nothing on the CPU, where no kernel
runs). The tiling is the library's own (:func:`tiling`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._build import load_library

__all__ = ["Tiling", "tiling", "padded_rows", "grouped_swiglu_reference", "grouped_swiglu"]


class Tiling(NamedTuple):
    """The kernels' tiling (``grouped_swiglu_tiling`` of the library)."""
    rows: int  # rows of a tile
    gate_cols: int  # output columns of a gate-up tile (as many gate and up products)
    down_cols: int  # output columns of a down tile
    max_groups: int


def padded_rows(counts: torch.Tensor) -> torch.Tensor:
    """The rows the kernels compute for groups of ``counts`` rows: each
    group's count rounded up to whole row tiles, summed, on counts' device
    (no wait on the card)."""
    bm = tiling().rows
    return ((counts + bm - 1) // bm * bm).sum()


def _sizes(x: torch.Tensor, offsets: Optional[torch.Tensor]) -> List[int]:
    if offsets is None:
        return [x.shape[0]]
    ends = offsets.tolist()
    if ends[0] != 0 or ends[-1] != x.shape[0] or any(b < a for a, b in zip(ends, ends[1:])):
        raise ValueError(f"grouped_swiglu: offsets {ends} do not split {x.shape[0]} rows")
    return [b - a for a, b in zip(ends, ends[1:])]


def grouped_swiglu_reference(x, w_gate, w_up, w_down, offsets=None, dest=None, scale=None):
    """The plain version: each group's three products in f32, then the
    scale and the rows' destinations."""
    parts = x.split(_sizes(x, offsets))
    y = torch.cat([F.linear(F.silu(F.linear(rows, wg)) * F.linear(rows, wu), wd)
                   for rows, wg, wu, wd in zip(parts, w_gate, w_up, w_down)])
    if scale is not None:
        y = y * scale[dest if dest is not None else slice(None), None]
    return y if dest is None else torch.empty_like(y).index_copy_(0, dest, y)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"grouped_swiglu: {name} is {t.dtype}, the kernel takes {dtype}")
    if t.device != device:
        raise ValueError(f"grouped_swiglu: {name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"grouped_swiglu: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"grouped_swiglu: {name} is not contiguous and 16-byte aligned")


_bound = None
_tiling: Optional[Tiling] = None
_sms: Dict[int, int] = {}


def _launchers():
    global _bound
    if _bound is None:
        lib = load_library("grouped_swiglu")
        gate_up, down = lib.grouped_swiglu_gate_up, lib.grouped_swiglu_down
        # x, w_gate, w_up, offsets, h, rows, G, K, N, grid, stream
        gate_up.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                            + [ctypes.c_void_p])
        # h, w_down, offsets, dest, scale, out, rows, G, N, D, grid, stream
        down.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
        gate_up.restype = down.restype = ctypes.c_int
        _bound = gate_up, down
    return _bound


def tiling() -> Tiling:
    """The kernels' tiling, read once from the library (built on first use)."""
    global _tiling
    if _tiling is None:
        out = (ctypes.c_int * 4)()
        load_library("grouped_swiglu").grouped_swiglu_tiling(out)
        _tiling = Tiling(*out)
    return _tiling


def _grid(device: torch.device, tiles_at_most: int) -> int:
    """One persistent CTA an SM, or one a tile where there are fewer."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(_sms[device.index], tiles_at_most))


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                   dest: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
                   tile_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The grouped SwiGLU (see the module's head): x [P, K] f32; w_gate and
    w_up [G, N, K], w_down [G, K, N]; offsets [G + 1] int64 (None: one
    group); dest [P] int64, a permutation of the rows, or None; scale f32
    indexed by dest, or None; tile_rows an int64 counter or None. Returns
    [P, K]. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernels (``launches`` counts them, two a call of at least one row) or
    raises."""
    if x.device.type == "cpu":
        return grouped_swiglu_reference(x, w_gate, w_up, w_down, offsets, dest, scale)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_swiglu: no kernel for device {x.device}")
    dev = x.device
    if x.dim() != 2 or w_gate.dim() != 3:
        raise ValueError(f"grouped_swiglu: x {tuple(x.shape)} and w_gate "
                         f"{tuple(w_gate.shape)} are not [P, K] and [G, N, K]")
    (p, k), (g, n) = x.shape, w_gate.shape[:2]
    _check("x", x, (p, k), torch.float32, dev)
    _check("w_gate", w_gate, (g, n, k), torch.float32, dev)
    _check("w_up", w_up, (g, n, k), torch.float32, dev)
    _check("w_down", w_down, (g, k, n), torch.float32, dev)
    if offsets is None:
        if g != 1:
            raise ValueError(f"grouped_swiglu: {g} groups need their offsets")
    else:
        _check("offsets", offsets, (g + 1,), torch.int64, dev)
    if dest is not None:
        _check("dest", dest, (p,), torch.int64, dev)
    if scale is not None:
        _check("scale", scale, (p,), torch.float32, dev)
    tile = tiling()
    if not 1 <= g <= tile.max_groups or k % tile.down_cols or n % tile.gate_cols:
        raise ValueError(f"grouped_swiglu: G={g}, K={k}, N={n}; the kernels take 1 <= G <= "
                         f"{tile.max_groups}, K a multiple of {tile.down_cols} and N of "
                         f"{tile.gate_cols}")
    out = torch.empty((p, k), dtype=torch.float32, device=dev)
    if p == 0:  # nothing to compute: no launch
        return out
    h = torch.empty((p, n), dtype=torch.float32, device=dev)
    row_tiles = -(-p // tile.rows) + g  # at least the row tiles of any split into g groups
    ptr = lambda t: None if t is None else t.data_ptr()
    gate_up, down = _launchers()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = gate_up(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), ptr(offsets),
                      h.data_ptr(), p, g, k, n, _grid(dev, row_tiles * (n // tile.gate_cols)),
                      stream)
        if err == 0:
            grouped_swiglu.launches += 1
            err = down(h.data_ptr(), w_down.data_ptr(), ptr(offsets), ptr(dest), ptr(scale),
                       out.data_ptr(), p, g, n, k, _grid(dev, row_tiles * (k // tile.down_cols)),
                       stream)
            if err == 0:
                grouped_swiglu.launches += 1
    if err != 0:
        raise RuntimeError(f"grouped_swiglu kernel launch failed with cudaError {err} "
                           f"(P={p}, G={g}, K={k}, N={n})")
    if tile_rows is not None:
        tile_rows += (padded_rows(offsets.diff()) if offsets is not None
                      else -(-p // tile.rows) * tile.rows)
    return out


grouped_swiglu.launches = 0
