"""Interactive serving: an open loop of clip requests into
``GestureBatcher`` (built by ``build_rag_server``), Poisson arrivals at a
fixed rate.

The inter-arrival gaps are the ``n = rate * seconds`` midpoint quantiles of
the exponential law, shuffled by the seed, so every seed offers the same
gaps in another order. Each request carries a waveform from a seeded pool,
a speaker drawn uniformly and a guidance from {1.0, 1.5, 2.0}. The load
comes from one thread of the benchmark's: it submits each request at its
due time and, between two, waits for the oldest answer outstanding (the
batcher serves its queue in order). A request's latency runs from its due
time to its clip in hand; a refused or failed request, or one unanswered a
minute after the last was due, counts as over every limit.
``serve_p95_ms`` is the 95th percentile (nearest rank) over every request
due in the window. A traced run profiles the window's last ``trace_s``
seconds, with the activities ``trace_activities`` names, and stops the
profiler once the last request is submitted.

Correctness: the batcher pads each batch to ``max_batch`` rows, copying
row 0's conditioning at the default guidance, and draws every batch's noise
from its one generator, seeded from ``ServeConfig.seed``, in the sampler's
documented order. The requests' ``batch_size`` gives each batch's members
(in submit order), so the reference replays the generator over every
batch, samples ``check_batches`` batches of the window drawn from the seed,
and compares each member's clip: ``clip_gap`` is the worst clip's
max |served - reference| over its max |reference|. ``unanswered`` counts
the requests whose clip never came (refused, failed, or not in hand a
minute after the last was due): an answer that never comes is not
correct.
"""

from __future__ import annotations

import collections
import math
import random
import time

import numpy as np
import torch

from .. import arith, harness
from ..reference import diffusion
from ..weights import derive_seed
from .common import GUIDANCES, audio_pool, build_rag, clip_shape

DRAIN_S = 60.0  # how long after the last due time an answer may come


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``rate * seconds``
    requests."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng(derive_seed(seed, "arrivals")).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def requests(n: int, pool: int, n_speakers: int, seed: int, tag: str) -> np.ndarray:
    """[n, 3] (pool row, speaker, guidance index) of each request."""
    rng = np.random.default_rng(derive_seed(seed, "requests", tag))
    return np.stack([rng.integers(pool, size=n), rng.integers(n_speakers, size=n),
                     rng.integers(len(GUIDANCES), size=n)], axis=1)


def p95(lat_ms) -> float:
    s = sorted(lat_ms)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def _reap(pending, done_t, until: float, idle: bool) -> None:
    """Stamp the answers of ``pending`` ((index, request), oldest first)
    as they come, until ``until`` (``time.monotonic()``). The batcher
    serves its queue in order, so the oldest is waited on and the others
    of its batch, set with it, are stamped at the same wake. With ``idle``
    the rest of the time to ``until`` is slept once nothing is pending;
    otherwise it returns then."""
    while pending:
        req = pending[0][1]
        if not req.done.wait(max(0.0, until - time.monotonic())):
            return
        t = time.monotonic()
        while pending and pending[0][1].done.is_set():
            j, req = pending.popleft()
            if req.error is None:
                done_t[j] = t
            req.audio = None  # the padded copy; the pool keeps the waveform
    pause = until - time.monotonic()
    if idle and pause > 0:
        time.sleep(pause)


def run(ctx: harness.Ctx) -> harness.Outcome:
    from livelyspeaker_tpu_torch.serving import ServeConfig, ServerOverloaded, build_rag_server

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    rag = cfg["rag"]
    model, weights = build_rag(cfg, ctx.seed, dev)
    scfg = ServeConfig(max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"],
                       pipeline_depth=tr["pipeline_depth"], sampler=tr["method"],
                       timestep_respacing=tr["respacing"], steps=cfg["diffusion"]["steps"],
                       default_guidance=tr["default_guidance"], use_fused=True,
                       seed=derive_seed(ctx.seed, "batcher"))
    batcher = build_rag_server(model, scfg, device=dev)
    pool = audio_pool(cfg, tr["audio_pool"], ctx.seed, dev).cpu().numpy()
    due = arrivals(tr["rate"], ctx.seconds, ctx.seed)
    warm = requests(tr["warmup"], len(pool), rag["n_speakers"], ctx.seed, "warmup")
    win = requests(len(due), len(pool), rag["n_speakers"], ctx.seed, "window")
    submitted = []  # (attributes, request or None) in submit order

    def submit(a):
        try:
            req = batcher.submit(pool[a[0]], speaker=int(a[1]), guidance=GUIDANCES[a[2]])
        except ServerOverloaded:
            req = None
        submitted.append((a, req))
        return req

    obs, notes = {}, {}
    tracer = harness.Tracer(ctx, obs, counters=lambda: {"batcher": batcher.stats()})
    try:
        for r in [submit(a) for a in warm]:  # the one served shape, warmed
            if r is not None:
                r.wait(timeout=600)
        batcher.reset_stats()
        tracer.warm()
        done_t = [math.inf] * len(due)
        pending = collections.deque()
        trace_from = max(0.0, ctx.seconds - tr["trace_s"])
        setup_s = harness.now() - ctx.t0
        t_start = time.monotonic()
        deadline = t_start + float(due[-1]) + DRAIN_S
        late = 0.0
        for j, a in enumerate(win):
            t_due = t_start + float(due[j])
            if ctx.trace and "start" not in obs.get("counters", {}) and due[j] >= trace_from:
                t0 = time.monotonic()
                tracer.start()
                notes["trace_start_ms"] = (time.monotonic() - t0) * 1e3
            _reap(pending, done_t, t_due, idle=True)
            req = submit(a)
            late = max(late, time.monotonic() - t_due)
            if req is not None:
                pending.append((j, req))
        if tracer.active:
            first, last = obs["counters"]["start"]["batcher"], batcher.stats()
            tracer.stop(batches=last["batches_served"] - first["batches_served"],
                        clips=last["requests_served"] - first["requests_served"])
        _reap(pending, done_t, deadline, idle=False)
        stats = batcher.stats()
    finally:
        batcher.close()
    tracer.finish()
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    lat = [(done_t[j] - t_start - float(due[j])) * 1e3 for j in range(len(due))]
    failed = sum(1 for x in lat if not math.isfinite(x))
    p95_ms = p95(lat)
    if not math.isfinite(p95_ms):
        p95_ms = (float(due[-1]) + DRAIN_S) * 1e3  # over every limit
    half = len(lat) // 2
    last_due = t_start + float(due[-1])
    backlog = {"p50_first_half_ms": _finite(sorted(lat[:half])[half // 2] if half else lat[0]),
               "p50_second_half_ms": _finite(sorted(lat[half:])[(len(lat) - half) // 2]),
               "unanswered_at_last_due": sum(1 for t in done_t if t > last_due)}
    batches = _batches(submitted)
    n_warm = len(warm)
    window_batches = [k for k, rows in enumerate(batches) if rows[0] >= n_warm]
    pick = sorted(random.Random(derive_seed(ctx.seed, "check")).sample(
        window_batches, min(tr["check_batches"], len(window_batches))))
    del batcher, model
    harness.free_device()
    checks = _check(ctx, weights, scfg, pool, submitted, batches, pick)
    checks["unanswered"] = [failed, tr["limits"]["unanswered"]]
    steps = int(tr["respacing"][len("ddim"):])
    obs["counters"] = {**obs.get("counters", {}), "window": stats}
    obs["flops_per_unit"] = {"clips": arith.sample_batch_flops(rag, 1, steps)}
    return harness.Outcome(
        setup_s=setup_s, e2e={"serve_p95_ms": p95_ms}, attempted=len(due), failed=failed,
        checks=checks, obs=obs, memory_peak_bytes=peak,
        notes={"requests": len(due), "p50_ms": _finite(sorted(lat)[len(lat) // 2]),
               "p99_ms": _finite(sorted(lat)[max(0, math.ceil(0.99 * len(lat)) - 1)]),
               "max_late_ms": late * 1e3, "rejected": stats["rejected"],
               "batches": stats["batches_served"],
               "occupancy": stats["mean_batch_occupancy"], "checked_batches": pick,
               **backlog, **notes})


def _finite(x):
    return x if math.isfinite(x) else None


def _batches(submitted):
    """Each served batch's members (indices into ``submitted``), in order:
    the batcher forms batches from consecutive requests of its queue, and a
    request learns how many shared its batch. Stops at the first request
    that was not served."""
    out, i = [], 0
    live = [i for i, (_, r) in enumerate(submitted) if r is not None]
    while i < len(live):
        req = submitted[live[i]][1]
        n = req.batch_size
        if not req.done.is_set() or req.error is not None or n < 1:
            break
        out.append(live[i: i + n])
        i += n
    return out


def _check(ctx, weights, scfg, pool, submitted, batches, pick):
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    rag = cfg["rag"]
    mb = tr["max_batch"]
    gap, control = 0.0, 0.0
    limit = tr["limits"]["clip_gap"]
    g = torch.Generator(device=dev).manual_seed(scfg.seed)
    for k in range(max(pick) + 1 if pick else 0):
        if k not in pick:
            diffusion.skip_draws(g, rag, mb, method=tr["method"], respacing=tr["respacing"],
                                 steps=cfg["diffusion"]["steps"])
            continue
        rows = batches[k]
        attrs = [submitted[i][0] for i in rows]
        attrs += [attrs[0]] * (mb - len(rows))  # the batcher's padding rows
        cond = {"audio": torch.from_numpy(pool[[a[0] for a in attrs]]).to(dev),
                "vid": torch.tensor([int(a[1]) for a in attrs], device=dev),
                "origin_x": torch.zeros((mb,) + clip_shape(cfg), device=dev)}
        if rag["num_emotions"]:
            cond["emo"] = torch.zeros(mb, dtype=torch.long, device=dev)
        scale = torch.tensor([GUIDANCES[a[2]] for a in attrs[: len(rows)]]
                             + [tr["default_guidance"]] * (mb - len(rows)), device=dev)
        state = g.get_state()
        outs = {}
        for tf32 in ((False, True) if ctx.control else (False,)):
            g.set_state(state)
            with harness.precision(tf32):
                outs[tf32] = diffusion.sample(weights, rag, cond, scale, g, method=tr["method"],
                                              respacing=tr["respacing"],
                                              steps=cfg["diffusion"]["steps"])
        ref = outs[False]
        for r, i in enumerate(rows):
            served = torch.from_numpy(submitted[i][1].result).to(dev)
            gap = max(gap, harness.rel_gap(served, ref[r]))
            if ctx.control:
                control = max(control, harness.rel_gap(outs[True][r], ref[r]))
    checks = {"clip_gap": [gap if pick else math.inf, limit]}
    if ctx.control:
        checks["control.clip_gap"] = [control, limit]
    return checks
