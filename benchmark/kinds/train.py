"""RAG training as ``train_rag --fused_train --device_resident 1`` runs it:
``TrainLoop``'s step (the cosine 1,000-step diffusion loss, the backward
through K2 and cuDNN's WavEncoder, AdamW) fed by ``DeviceDataLoader`` over
a seeded pool of windows staged on the card. No checkpoint is written.

Each step's timesteps, noise, condition drop and style tokens come from a
generator of the benchmark's, seeded by the run's seed and the step, and
go to the step through its public arguments. Set-up builds one loop and
drives it through its first three steps with the window's own call and
feed; the window then continues the same loop. ``train_clips_per_s`` is
the batch times the steps done in the window over its wall time, which
ends with the first step completion at or after ``seconds`` (each step
reads its metrics back, a synchronise).

Correctness: once the window has closed and the program is freed, the
plain reference takes the same three steps from the same weights on the
same rows (found in the benchmark's own pool by their motion) and draws,
with ``torch.optim.AdamW``. ``loss_gap``: the worst step's | loss - ref |
over | ref |; ``grad_gap``: the worst leaf's gap of norms of the first
gradient, the program's read from its Adam state after one step;
``change_gap``: the worst leaf's gap of norms of the change over the three
steps (``harness.leaf_norm_gaps``). The same three numbers, named
``window_...``, for three steps of the window itself, from a step past the
traced stretch drawn from the seed (``check_within`` steps to draw from):
as that step starts, the window clones the parameters and AdamW's count
and moments, and the first moments once more after it; the reference
starts from that state (the program's: the reference can only follow it
there) and takes the same three steps, the gradient read as
(mu after - b1 mu before) / (1 - b1).
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Dict

import numpy as np
import torch

from .. import arith, harness
from ..reference import diffusion
from ..weights import derive_seed
from .common import build_rag, clip_shape, gen, n_samples

FIELDS = ("motion", "audio", "vid")
CHECK_STEPS = 3


class Pool:
    """The seeded windows, in the record dataset's interface
    (``len``, ``batch(indices, fields)``) for ``DeviceDataLoader``."""

    def __init__(self, host):
        self.host = host

    def __len__(self):
        return len(self.host["motion"])

    def batch(self, idx, fields=None):
        whole = len(idx) == len(self) and np.array_equal(idx, np.arange(len(self)))
        return {k: (v if whole else v[idx]) for k, v in self.host.items()
                if fields is None or k in fields}


def make_pool(cfg, n, seed, device):
    """[n] windows on ``device``: motion (unit normal), audio (0.1 rms),
    speakers."""
    rag = cfg["rag"]
    g = gen(device, seed, "pool")
    pool = {"motion": torch.randn((n,) + clip_shape(cfg), generator=g, device=device),
            "audio": torch.randn((n, n_samples(cfg)), generator=g, device=device).mul_(0.1),
            "vid": torch.randint(rag["n_speakers"], (n,), generator=g, device=device)}
    if rag["num_emotions"]:
        pool["emo"] = torch.randint(rag["num_emotions"], (n,), generator=g, device=device)
    return pool


def step_inputs(cfg, b, seed, k, device):
    """Step k's timesteps, noise, condition drop and style tokens."""
    rag = cfg["rag"]
    g = gen(device, seed, "step", k)
    return {"t": torch.randint(cfg["diffusion"]["steps"], (b,), generator=g, device=device),
            "noise": torch.randn((b,) + clip_shape(cfg), generator=g, device=device),
            "cond_drop": (torch.rand((b,), generator=g, device=device)
                          < rag["cond_mask_prob"]).float(),
            "style_eps": torch.randn((b, 1, rag["latent_dim"]), generator=g, device=device)}


def find_rows(pool_motion, motion):
    """The pool index of each row of ``motion`` (exact copies), found by
    the bits of each row's first two values; -1 where none matches."""
    def key(m):
        bits = m.reshape(m.shape[0], -1)[:, :2].contiguous().view(torch.int32).long()
        return (bits[:, 0] << 32) | (bits[:, 1] & 0xFFFFFFFF)

    pk, order = torch.sort(key(pool_motion))
    q = key(motion)
    pos = torch.searchsorted(pk, q).clamp(max=len(pk) - 1)
    idx = order[pos]
    same = (pool_motion[idx] == motion).reshape(len(q), -1).all(1)
    return torch.where(same, idx, torch.full_like(idx, -1))


def run(ctx: harness.Ctx) -> harness.Outcome:
    from livelyspeaker_tpu_torch.data import DeviceDataLoader
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
    from livelyspeaker_tpu_torch.training import TrainConfig
    from livelyspeaker_tpu_torch.training.loop import TrainLoop

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    tc = cfg["train"]
    b = tr["batch"]
    model, weights = build_rag(cfg, ctx.seed, dev, fused_train_backbone=True)
    pool = make_pool(cfg, tr["pool"], ctx.seed, dev)
    fields = FIELDS + (("emo",) if cfg["rag"]["num_emotions"] else ())
    loader = DeviceDataLoader(Pool({k: pool[k].cpu().numpy() for k in fields}), b,
                              shuffle=True, seed=ctx.seed, fields=fields, device=dev)
    sched = DiffusionSchedule.create(steps=cfg["diffusion"]["steps"],
                                     schedule=cfg["diffusion"]["schedule"])
    tcfg = TrainConfig(lr=tc["lr"], weight_decay=tc["weight_decay"], loss_type=tc["loss_type"],
                       lambda_vel=tc["lambda_vel"], kld_weight=tc["kld_weight"])
    loop = TrainLoop(model, sched, None, loader, cfg=tcfg, num_epochs=1, device=dev)

    def feed():
        for epoch in itertools.count():
            loader.set_epoch(epoch)
            yield from loader

    batches = feed()
    steps_done = 0

    def step():
        nonlocal steps_done
        batch = next(batches)
        x = step_inputs(cfg, b, ctx.seed, steps_done, dev)
        loop.state, m = loop.step_fn(loop.state, batch, None, **x)
        steps_done += 1
        return batch, x, m

    beta1 = tc["betas"][0]
    first = []
    for k in range(CHECK_STEPS):
        batch, x, m = step()
        first.append({"motion": batch["motion"], **x, "loss": m["loss"]})
        if k == 0:
            grad1 = {n: v / (1.0 - beta1) for n, v in loop.state.opt_state.mu.items()}
    after = {n: v.detach().clone() for n, v in loop.state.params.items()}
    for _ in range(tr["warmup_steps"]):
        step()
    harness.sync(dev)
    peak_before = harness.memory_peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    obs = {}
    tracer = harness.Tracer(ctx, obs)
    tracer.warm()
    # the window's own steps that the reference follows: CHECK_STEPS from a
    # step drawn from the seed, past the traced stretch
    k_check = tr["trace_units"] + random.Random(derive_seed(ctx.seed, "window check")).randrange(
        tr["check_within"])
    snap, later = {}, []
    setup_s = harness.now() - ctx.t0
    tracer.start()
    t_start = harness.now()
    n = 0
    while True:
        if n == k_check:
            snap = _snapshot(loop.state)
        batch, x, m = step()
        if k_check <= n < k_check + CHECK_STEPS:
            later.append({"motion": batch["motion"], **x, "loss": m["loss"]})
        if n == k_check:
            snap["mu1"] = {k: v.clone() for k, v in loop.state.opt_state.mu.items()}
        n += 1
        if n == k_check + CHECK_STEPS:
            snap["after"] = {k: v.detach().clone() for k, v in loop.state.params.items()}
        if n == tr["trace_units"]:
            tracer.stop(steps=n)
        t_end = harness.now()
        if t_end - t_start >= ctx.seconds and not tracer.active and "after" in snap:
            break
    harness.sync(dev)
    tracer.finish()
    window = t_end - t_start
    peak_window = harness.memory_peak(dev)
    del loop, model, loader, batches
    harness.free_device()

    checks, leaves = _check(ctx, weights, pool, first, grad1, after)
    grad_w = {k: (snap["mu1"][k] - beta1 * snap["mu"][k]) / (1.0 - beta1) for k in snap["mu"]}
    more, more_leaves = _check(ctx, snap["params"], pool, later, grad_w, snap["after"],
                               adam=snap, prefix="window_")
    checks.update(more)
    leaves.update(more_leaves)
    c = cfg["rag"]
    obs.update(peak_bytes_window=peak_window,
               flops_per_unit={"steps": arith.train_step_matmul_flops(c, b)})
    return harness.Outcome(
        setup_s=setup_s, e2e={"train_clips_per_s": n * b / window}, attempted=n, failed=0,
        checks=checks, obs=obs, memory_peak_bytes=max(peak_before, peak_window),
        notes={"steps": n, "window_s": window, "window_check_step": k_check,
               "losses": [f["loss"] for f in first],
               "window_losses": [f["loss"] for f in later], **leaves})


def _snapshot(state) -> Dict:
    """The training state as a step of the window starts: the parameters,
    AdamW's count and moments, cloned."""
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
    return {"params": clone(state.params), "count": state.opt_state.count,
            "mu": clone(state.opt_state.mu), "nu": clone(state.opt_state.nu)}


def _ref_steps(ctx, weights, pool, first, tf32, half=False, adam=None):
    rows = [find_rows(pool["motion"], f["motion"]) for f in first]
    if any(bool((r < 0).any()) for r in rows):
        return None
    steps = []
    for r, f in zip(rows, first):
        keep = slice(0, len(r) // 2) if half else slice(None)
        r = r[keep]
        batch = {k: pool[k][r] for k in pool}
        steps.append({"batch": batch, "t": f["t"][keep], "noise": f["noise"][keep],
                      "drop": f["cond_drop"][keep], "style_eps": f["style_eps"][keep]})
    with harness.precision(tf32):
        return diffusion.train_steps(weights, ctx.config["rag"], ctx.config["train"], steps,
                                     adam=adam)


def _readings(ref, base, losses, grad1, after, weights):
    if ref is None:  # a row the loader gave is in no pool
        return {k: math.inf for k in ("loss_gap", "grad_gap", "change_gap")}, {}
    loss_gap = max(abs(a - r) / abs(r) for a, r in zip(losses, ref["losses"]))
    grad_gap, grad_leaf, _ = harness.leaf_norm_gaps(grad1, ref["first_grad"],
                                                    base["first_grad"])
    change = {k: after[k] - weights[k] for k in after}
    ref_change = {k: ref["params"][k] - weights[k] for k in ref["params"]}
    change_gap, change_leaf, change_median = harness.leaf_norm_gaps(change, ref_change,
                                                                    base["first_grad"])
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap},
            {"grad_leaf": grad_leaf, "change_leaf": change_leaf,
             "change_gap_median_leaf": change_median})


def _check(ctx, weights, pool, first, grad1, after, adam=None, prefix=""):
    """The readings of the steps ``first`` from ``weights`` (and AdamW's
    state ``adam``; fresh by default), named with ``prefix``, each beside
    its limit; with ``ctx.control`` the control's and the half batch's
    too."""
    limits = ctx.traffic["limits"]
    base = _ref_steps(ctx, weights, pool, first, tf32=False, adam=adam)
    losses = [f["loss"] for f in first]
    read, notes = _readings(base, base, losses, grad1, after, weights)
    checks = {prefix + k: [v, limits[prefix + k]] for k, v in read.items()}
    notes = {prefix + k: v for k, v in notes.items()}
    if ctx.control and base is not None:
        # the reference in the program's place: in TF32 (the control), and
        # with half of each batch left out, its mean taken over the rest
        for tag, kw in (("control", {"tf32": True}), ("half_batch", {"tf32": False, "half": True})):
            alt = _ref_steps(ctx, weights, pool, first, adam=adam, **kw)
            alt_read, alt_notes = _readings(base, base, alt["losses"],
                                            alt["first_grad"], alt["params"], weights)
            checks.update({f"{tag}.{prefix}{k}": [v, limits[prefix + k]]
                           for k, v in alt_read.items()})
            notes.update({f"{tag}.{prefix}{k}": v for k, v in alt_notes.items()})
    return checks, notes
