"""A CPU emulation of K3's statistics kernel (``wav_stats_kernel`` in
``livelyspeaker_tpu_torch/csrc/fused_wav.cu``), in f32 with each add,
product, quotient and root rounded as the kernel rounds it: the rows of a
sequence split over ``stats_geometry``'s CTAs, each thread's rows (one
float4 channel group, every kR-th row) summed shifted by the sequence's
row 0, each thread's (n, mean, M2), then Chan's combine over the lanes of a
warp that hold one channel group (halving), the warps in order and the CTAs
in rank order. It imports no JAX: the CPU tests and the card's tests both
hold the kernel to it.
"""

import numpy as np
import torch

from livelyspeaker_tpu_torch.ops import fused_wav as k3


def chan(a, b):
    """Chan's combine of two (n, mean, M2) triples of tensors, a's rows
    before b's (csrc: chan); a where both are empty."""
    na, ma, qa = a
    nb, mb, qb = b
    n = na + nb
    d = mb - ma
    f = nb / n
    out = (n, ma + d * f, (qa + qb) + (d * d) * (na * f))
    return tuple(torch.where(n == 0, x, y) for x, y in zip(a, out))


def thread_moments(m: torch.Tensor):
    """(n, mean - x0, M2), each [B, N, kR, C], of every thread of the
    launch for m [B, T, C] f32: CTA rank r, row slot s; x0 = m[:, 0]."""
    b, t, c = m.shape
    geo = k3.stats_geometry(b, t, c)
    step = k3.THREADS * 4 // c  # kR, rows a CTA step covers
    rank = torch.arange(geo.cluster)[:, None]
    slot = torch.arange(step)[None, :]
    end = torch.clamp((rank + 1) * geo.rows_per_cta, max=t)
    x0 = m[:, 0][:, None, None, :]
    s1 = torch.zeros(b, geo.cluster, step, c)
    s2 = torch.zeros_like(s1)
    cnt = torch.zeros(geo.cluster, step)
    for k in range(geo.rows_per_cta // step):
        r = rank * geo.rows_per_cta + slot + k * step
        valid = r < end
        d = m[:, r.clamp(max=t - 1)] - x0
        v = valid[None, :, :, None]
        s1 = torch.where(v, s1 + d, s1)
        s2 = torch.where(v, s2 + d * d, s2)
        cnt = cnt + valid
    n = cnt[None, :, :, None].expand_as(s1).contiguous()
    mean = torch.where(n > 0, s1 / n, torch.zeros_like(s1))
    m2 = torch.where(n > 0, (s2 - s1 * mean).clamp_min(0.0), torch.zeros_like(s1))
    return n, mean, m2


def emulate_stats(m: torch.Tensor) -> torch.Tensor:
    """st [B, 2, C] (mean, 1/std) of m [B, T, C] f32, as the kernel
    computes it."""
    b, t, c = m.shape
    per_warp = 32 // (c // 4)  # row slots a warp holds
    # [B, N, warps, slots of a warp, C]
    mo = [x.reshape(b, x.shape[1], k3.THREADS // 32, per_warp, c) for x in thread_moments(m)]
    while per_warp > 1:  # lane l takes lane l + o's rows: the second half of the slots
        per_warp //= 2
        mo = list(chan([x[..., :per_warp, :] for x in mo], [x[..., per_warp:, :] for x in mo]))
    mo = [x[..., 0, :] for x in mo]  # [B, N, warps, C]
    acc = [x[:, :, 0] for x in mo]
    for w in range(1, mo[0].shape[2]):
        acc = chan(acc, [x[:, :, w] for x in mo])
    tot = [x[:, 0] for x in acc]
    for r in range(1, acc[0].shape[1]):
        tot = chan(tot, [x[:, r] for x in acc])
    _, mean, m2 = tot
    var = m2 / torch.full_like(m2, t)
    # the root rounded once to f32 (torch.sqrt of an f32 tensor is not
    # correctly rounded on the CPU; of f64, rounded to f32, it is), then
    # the quotient
    root = torch.sqrt((var + torch.full_like(var, k3.EPS)).double()).float()
    inv = torch.ones_like(root) / root
    return torch.stack([m[:, 0] + mean, inv], dim=1)


def unshifted_stats(m: torch.Tensor) -> torch.Tensor:
    """The one-pass statistics the kernel does not take: plain f32 sums of
    x and x^2 over time, var = E[x^2] - mean^2."""
    t = m.shape[1]
    mean = m.sum(1) / t
    var = (m * m).sum(1) / t - mean * mean
    return torch.stack([mean, torch.rsqrt(var.clamp_min(0.0) + k3.EPS)], dim=1)


def offset_case(b: int, t: int, c: int, offset: float, seed: int) -> torch.Tensor:
    """m [B, T, C] f32 from a numpy seed: per (b, c) a std in [0.5, 2) and a
    mean of ``offset`` times it, of either sign."""
    rng = np.random.default_rng(seed)
    std = rng.uniform(0.5, 2.0, size=(b, 1, c))
    mean = offset * std * rng.choice([-1.0, 1.0], size=(b, 1, c))
    return torch.from_numpy((mean + std * rng.normal(size=(b, t, c))).astype(np.float32))



def emulate_stats0(wav: torch.Tensor, packed) -> torch.Tensor:
    """st0 [B, 2, 32] (mean, 1/std) of conv0 over wav [B, L] f32, as the
    conv0 statistics kernel (``wav_stats0_kernel``) computes it: conv0 with
    the kernels' bits (bias first, taps in order, each product and sum
    rounded), over the live times [lo, hi) only, shifted by b0 (conv0's row
    0); the live times split over ``stats0_geometry``'s CTAs, warp w of a
    CTA summing its batches of 32 times at offsets 32 w, 32 w + 256, ...
    in order, each batch's (n, mean, M2) combined into the warp's by Chan's
    formula; then the warps in order, the CTAs in rank order, and last the
    padding's times as (n_pad, 0, 0) before them."""
    b, length = wav.shape
    m = k3._conv0(wav, packed)  # [B, 32, T1]
    t1 = m.shape[2]
    lo, hi = k3.conv0_live(length)
    live = hi - lo
    bias = packed["b0"]
    d = m[:, :, lo:hi] - bias[None, :, None]
    geo = k3.stats0_geometry(b, length)
    warps, batch = k3.THREADS // 32, k3.CONV0_BATCH
    step = warps * batch
    rank = torch.arange(geo.cluster)[:, None]
    warp = torch.arange(warps)[None, :]
    end = torch.clamp((rank + 1) * geo.per, max=live)  # [R, 1]
    shape = (b, 32, geo.cluster, warps)
    zero = torch.zeros(shape)
    run = (zero, zero, zero)
    for j in range(geo.per // step):
        start = rank * geo.per + warp * batch + j * step  # [R, W]
        n = torch.clamp(end - start, min=0, max=batch)
        s1, s2 = zero, zero
        for i in range(batch):
            valid = (i < n)[None, None]
            di = d[:, :, (start + i).clamp(max=live - 1)]
            s1 = torch.where(valid, s1 + di, s1)
            s2 = torch.where(valid, s2 + di * di, s2)
        nb = n.float()[None, None].expand(shape)
        has = nb > 0
        mean = torch.where(has, s1 / nb, zero)
        m2 = torch.where(has, (s2 - s1 * mean).clamp_min(0.0), zero)
        new = chan(run, (nb, mean, m2))
        run = tuple(torch.where(has, y, x) for x, y in zip(run, new))
    acc = [x[..., 0] for x in run]  # [B, 32, R]
    for w in range(1, warps):
        acc = chan(acc, [x[..., w] for x in run])
    tot = [x[..., 0] for x in acc]
    for r in range(1, geo.cluster):
        tot = chan(tot, [x[..., r] for x in acc])
    pad = torch.full_like(tot[0], float(t1 - live))
    _, mean, m2 = chan((pad, torch.zeros_like(pad), torch.zeros_like(pad)), tot)
    var = m2 / torch.full_like(m2, t1)
    root = torch.sqrt((var + torch.full_like(var, k3.EPS)).double()).float()
    inv = torch.ones_like(root) / root
    return torch.stack([bias[None, :] + mean, inv], dim=1)
