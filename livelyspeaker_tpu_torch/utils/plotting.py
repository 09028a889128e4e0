"""Phase/PCA diagnostic plotting and farthest-point sampling.

Port of ``livelyspeaker_tpu/utils/plotting.py``: equivalents of the
reference's DeepPhase-style utilities (``scripts/utils/plotting.py:5-128``:
PCA2D, Distribution, Circles, Function(s), Phase1D, Phase2D; no call sites in
the reference, kept for completeness) and
``scripts/utils/sample_utils.py:137-157`` (``farthest_point_sample``).

The plotters draw onto a given matplotlib Axes, as the originals do; the PCA
is a self-contained SVD (no sklearn). ``farthest_point_sample`` is a loop
over the picks on torch tensors, where the JAX module scans: the same
indices for the same ``start``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "pca2d",
    "pca_2d_tracks",
    "distribution",
    "circles",
    "function",
    "functions",
    "phase_1d",
    "phase_2d",
    "farthest_point_sample",
]


def pca_2d_tracks(batches: Sequence[np.ndarray], whiten: bool = True):
    """Stack [Ti, D] tracks, project to 2 principal components (matches
    sklearn ``PCA(n_components=2, whiten=True)`` up to component sign)."""
    x = np.vstack([np.asarray(b, np.float64) for b in batches])
    mu = x.mean(axis=0)
    xc = x - mu
    u, s, _vt = np.linalg.svd(xc, full_matrices=False)
    y = u[:, :2] * (np.sqrt(x.shape[0] - 1) if whiten else s[:2])
    out, ofs = [], 0
    for b in batches:
        out.append(y[ofs : ofs + len(b)])
        ofs += len(b)
    return out


def pca2d(ax, indices, batches, title):
    """PCA trajectory scatter with step arrows (plotting.py:5-33)."""
    ax.cla()
    tracks = pca_2d_tracks(batches)
    arrow_step, arrow_size = 50, 0.015
    for i in indices:
        t = tracks[i]
        px, py = t[:, 0], t[:, 1]
        ax.plot(px, py, c=(0, 0, 0), alpha=0.2)
        ax.scatter(px, py, alpha=0.3)
        for j in range(0, len(t) - arrow_step, arrow_step):
            d = np.hypot(px[j], py[j])
            ax.arrow(
                px[j], py[j], px[j + 1] - px[j], py[j + 1] - py[j],
                alpha=1.0, width=d * arrow_size, color=(0.25, 0.25, 0.5),
            )
    ax.set_axis_off()
    ax.set_title(title)


def distribution(ax, values, title):
    """Per-channel mean±std bar chart (plotting.py:35-49)."""
    ax.cla()
    values = np.asarray(values)
    means, std = values.mean(axis=0), values.std(axis=0)
    args = np.arange(len(means))
    ax.bar(args, means, yerr=std, align="center", alpha=0.5,
           ecolor="black", capsize=10)
    ax.set_xticks(args)
    ax.set_xticklabels([f"Channel {i + 1}" for i in args])
    ax.set_title(title)
    ax.yaxis.grid(True)


def circles(ax, p, m, title: Optional[str] = None, show_axes: bool = True):
    """Phase/amplitude clock dials, one per channel (plotting.py:51-77)."""
    ax.cla()
    aspect = 0.5
    ax.set_aspect(aspect)
    p, m = np.asarray(p), np.asarray(m)
    count = p.shape[0]
    ax.set_xlim(0, count + 1)
    ax.set_ylim(-1, 1)
    theta = np.linspace(0, 2 * np.pi, 100)
    for i in range(count):
        ax.plot(aspect * m[i] * np.cos(theta) + i + 1, m[i] * np.sin(theta))
        ax.plot(
            [i + 1, i + 1 + aspect * m[i] * np.cos(2 * np.pi * p[i])],
            [0, m[i] * np.sin(2 * np.pi * p[i])],
            color=(0, 0, 0),
        )
    if title is not None:
        ax.set_title(title)
    if not show_axes:
        ax.axes.xaxis.set_visible(False)
        ax.axes.yaxis.set_visible(False)


def function(ax, values_list, xmin, xmax, ymin, ymax, colors=None,
             title: Optional[str] = None, show_axes: bool = True):
    """Overlaid 1-D curves on a shared x grid (plotting.py:79-93)."""
    ax.cla()
    for idx, values in enumerate(values_list):
        args = np.linspace(xmin, xmax, np.asarray(values).shape[0])
        ax.plot(args, values, color=colors[idx] if colors else None)
    ax.set_ylim(ymin, ymax)
    if title is not None:
        ax.set_title(title)
    if not show_axes:
        ax.axes.xaxis.set_visible(False)
        ax.axes.yaxis.set_visible(False)


def functions(ax, values, xmin, xmax, ymin, ymax, colors=None,
              title: Optional[str] = None, show_axes: bool = True):
    """Row-per-curve variant over a [C, T] array (plotting.py:95-109)."""
    function(ax, list(np.asarray(values)), xmin, xmax, ymin, ymax,
             colors=colors, title=title, show_axes=show_axes)


def phase_1d(ax, phase, opacity, color=(0, 0, 0),
             title: Optional[str] = None, show_axes: bool = True):
    """Wrapped phase track with per-step opacity (plotting.py:111-128)."""
    ax.cla()
    phase = np.asarray(phase, np.float64)
    phase = np.where(phase < 0, phase, phase + 1) % 1.0
    opacity = np.clip(np.asarray(opacity, np.float64).flatten(), 0, 1)
    args = np.arange(len(phase))
    for i in range(1, len(phase)):
        ax.plot([args[i - 1], args[i]], [phase[i - 1], phase[i]],
                color=(color[0], color[1], color[2], opacity[i]))
    ax.set_ylim(0, 1)
    if title is not None:
        ax.set_title(title)
    if not show_axes:
        ax.axes.xaxis.set_visible(False)
        ax.axes.yaxis.set_visible(False)


def phase_2d(ax, p, m, colors=None, title: Optional[str] = None,
             show_axes: bool = True):
    """Amplitude-modulated 2-D phase portrait (sin/cos columns)."""
    ax.cla()
    p, m = np.asarray(p), np.asarray(m)
    args = np.arange(len(p))
    sx = m * np.sin(2 * np.pi * p)
    cx = m * np.cos(2 * np.pi * p)
    ax.plot(args, sx, color=colors[0] if colors else None)
    ax.plot(args, cx, color=colors[1] if colors else None)
    if title is not None:
        ax.set_title(title)
    if not show_axes:
        ax.axes.xaxis.set_visible(False)
        ax.axes.yaxis.set_visible(False)


def farthest_point_sample(xyz, npoint: int, start=None) -> torch.Tensor:
    """Greedy farthest-point sampling, [B, N, C] -> [B, npoint] int64
    indices (sample_utils.py:137-157), on ``xyz``'s device.

    ``start`` gives the first index per batch element ([B] int, default 0
    for determinism: the torch original uses ``randint``; pass your own
    random start for that behaviour)."""
    xyz = torch.as_tensor(xyz)
    b, n, _ = xyz.shape
    if start is None:
        farthest = torch.zeros((b,), dtype=torch.int64, device=xyz.device)
    else:
        farthest = torch.as_tensor(start, device=xyz.device).to(torch.int64)
    distance = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    picked = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    for i in range(npoint):
        picked[:, i] = farthest
        centroid = xyz[rows, farthest][:, None]  # [B, 1, C]
        dist = torch.sum((xyz - centroid) ** 2, dim=-1)  # [B, N]
        distance = torch.minimum(distance, dist)
        farthest = torch.argmax(distance, dim=-1)
    return picked
