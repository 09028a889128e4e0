"""Offline sampling: batches of ``batch`` clips back to back through
``RAGSampler(use_fused=True)`` under classifier-free guidance, each row at
a guidance drawn from {1.0, 1.5, 2.0}.

Batch k draws its inputs from a generator of its own, seeded by the run's
seed and k: rows of a seeded audio pool on the device, speakers, emotions
(BEAT), guidance, seed motion and the initial noise, in that order; the
sampler then draws its style tokens (and DDIM's step noise) from the same
generator. The window ends at the first batch completion at or after
``seconds``, read after a synchronise; the rate, named by the traffic's
``rate_metric``, is every clip of the batches done over the window's wall
time.

Correctness: ``check_batches`` batches of the window, drawn from the seed,
are sampled again by the plain reference from the same generator seeds;
``clip_gap`` is the worst clip's max |program - reference| over its
max |reference|.
"""

from __future__ import annotations

import random

import torch

from .. import arith, harness
from ..reference import diffusion
from ..weights import derive_seed
from .common import audio_pool, batch_window, build_rag, clip_shape, draw_cond, gen


def _inputs(ctx, pool, k):
    g = gen(ctx.device, ctx.seed, "batch", k)
    b = ctx.traffic["batch"]
    cond, scale = draw_cond(ctx.config, pool, b, g)
    noise = torch.randn((b,) + clip_shape(ctx.config), generator=g, device=ctx.device)
    return g, cond, scale, noise


def run(ctx: harness.Ctx) -> harness.Outcome:
    from livelyspeaker_tpu_torch.pipeline import RAGSampler

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    model, weights = build_rag(cfg, ctx.seed, dev)
    sampler = RAGSampler(model, steps=cfg["diffusion"]["steps"],
                         timestep_respacing=tr["respacing"], method=tr["method"],
                         use_fused=True, device=dev)
    pool = audio_pool(cfg, tr["audio_pool"], ctx.seed, dev)

    def one(k):
        g, cond, scale, noise = _inputs(ctx, pool, k)
        return sampler(cond, g, guidance=scale, noise=noise)

    one(-1)  # the cell's one shape, outside the window
    harness.sync(dev)
    obs = {}
    tracer = harness.Tracer(ctx, obs)
    tracer.warm()
    setup_s = harness.now() - ctx.t0
    outs, done, window = batch_window(ctx, one, tracer)
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    b = tr["batch"]
    pick = sorted(random.Random(derive_seed(ctx.seed, "check")).sample(
        range(done), min(tr["check_batches"], done)))
    kept = {i: outs[i] for i in pick}
    del outs, sampler, model
    harness.free_device()

    checks = {"clip_gap": [0.0, tr["limits"]["clip_gap"]]}
    control = 0.0
    for i in pick:
        for tf32 in ((False, True) if ctx.control else (False,)):
            g, cond, scale, noise = _inputs(ctx, pool, i)
            with harness.precision(tf32):
                ref = diffusion.sample(weights, cfg["rag"], cond, scale, g, method=tr["method"],
                                       respacing=tr["respacing"],
                                       steps=cfg["diffusion"]["steps"], noise=noise)
            if not tf32:
                base = ref
                gap = max(harness.rel_gap(kept[i][r], ref[r]) for r in range(b))
                checks["clip_gap"][0] = max(checks["clip_gap"][0], gap)
            else:
                control = max(control, max(harness.rel_gap(ref[r], base[r]) for r in range(b)))
    if ctx.control:
        checks["control.clip_gap"] = [control, tr["limits"]["clip_gap"]]
    flops = arith.sample_batch_flops(cfg["rag"], b, int(tr["respacing"][len("ddim"):]))
    obs["flops_per_unit"] = {"batches": flops}
    return harness.Outcome(
        setup_s=setup_s, e2e={tr["rate_metric"]: done * b / window},
        attempted=done * b, failed=0, checks=checks, obs=obs, memory_peak_bytes=peak,
        notes={"batches": done, "window_s": window, "checked_batches": pick})

