"""The two-stage composition: ``LivelySpeakerPipeline.__call__`` on batches
of ``batch`` sentences back to back: CLIP's text tower, the SAG's decode,
then the RAG's refinement over the last steps of the respaced chain under
CFG at one guidance, with the fused kernel.

Batch k's token ids come from the seed through the benchmark's own
tokenizer callable (each sentence ``tokens`` long, start and end-of-text
ids around uniform word ids, padded to the context); its conditioning from
a generator of its own, as in ``kinds/sample.py``, which the pipeline then
draws its initial noise, style tokens and step noise from. The window and
its rate are those of ``kinds/sample.py``.

Correctness: ``check_batches`` batches of the window, drawn from the seed,
are composed again by the plain reference (``reference/text.py`` for the
sketch, ``reference/diffusion.py`` for the refinement) from the same ids
and generator seeds; ``clip_gap`` as in ``kinds/sample.py``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .. import arith, harness
from ..reference import diffusion, text
from ..weights import derive_seed, seeded_tensors, shapes_of
from .common import audio_pool, batch_window, build_rag, draw_cond, gen

SOT, EOT = 49406, 49407  # CLIP's start- and end-of-text ids


def token_ids(cfg, tr, seed, k) -> np.ndarray:
    """[batch, context] ids of batch k: SOT, uniform word ids, EOT, zeros."""
    clip = cfg["clip"]
    rng = np.random.default_rng(derive_seed(seed, "tokens", k))
    ids = np.zeros((tr["batch"], clip["context_length"]), np.int64)
    lo, hi = tr["tokens"]
    for i, n in enumerate(rng.integers(lo, hi + 1, size=tr["batch"])):
        ids[i, 0], ids[i, n - 1] = SOT, EOT
        ids[i, 1:n - 1] = rng.integers(1, SOT, size=n - 2)
    return ids


class Tokenizer:
    """The ids of the sentence names a batch's sentences carry."""

    def __init__(self):
        self.ids = {}

    def __call__(self, sentences):
        return np.stack([self.ids[s] for s in sentences])


def _inputs(ctx, pool, k):
    g = gen(ctx.device, ctx.seed, "batch", k)
    cond, _ = draw_cond(ctx.config, pool, ctx.traffic["batch"], g)
    return g, cond


def run(ctx: harness.Ctx) -> harness.Outcome:
    from livelyspeaker_tpu_torch.models import SAG, CLIPTextConfig, CLIPTextEncoder
    from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    rag, weights = build_rag(cfg, ctx.seed, dev)
    sag = SAG(**{k: cfg["sag"][k] for k in ("njoints", "nfeats", "latent_dim", "ff_size",
                                            "num_layers", "num_heads", "n_pre_poses")})
    clip = CLIPTextEncoder(CLIPTextConfig(**cfg["clip"]))
    sag_w = seeded_tensors(shapes_of(sag), ctx.seed, "sag", dev)
    clip_w = seeded_tensors(shapes_of(clip), ctx.seed, "clip", dev)
    sag.to(dev).load_state_dict(sag_w)
    clip.to(dev).load_state_dict(clip_w)
    tok = Tokenizer()
    pipe = LivelySpeakerPipeline(rag, sag, clip, tok, steps=cfg["diffusion"]["steps"],
                                 timestep_respacing=tr["respacing"], skip_timesteps=tr["skip"],
                                 method=tr["method"], use_fused=True, device=dev)
    pool = audio_pool(cfg, tr["audio_pool"], ctx.seed, dev)
    b = tr["batch"]

    def one(k):
        names = [f"{k}:{i}" for i in range(b)]
        tok.ids.update(zip(names, token_ids(cfg, tr, ctx.seed, k)))
        g, cond = _inputs(ctx, pool, k)
        out = pipe(names, cond, g, guidance=tr["guidance"])
        for n in names:
            del tok.ids[n]
        return out

    one(-1)
    harness.sync(dev)
    obs = {}
    tracer = harness.Tracer(ctx, obs)
    tracer.warm()
    setup_s = harness.now() - ctx.t0
    outs, done, window = batch_window(ctx, one, tracer)
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    pick = sorted(random.Random(derive_seed(ctx.seed, "check")).sample(
        range(done), min(tr["check_batches"], done)))
    kept = {i: outs[i] for i in pick}
    del outs, pipe, rag, sag, clip
    harness.free_device()

    gap, control = 0.0, 0.0
    for i in pick:
        ids = torch.from_numpy(token_ids(cfg, tr, ctx.seed, i)).to(dev)
        for tf32 in ((False, True) if ctx.control else (False,)):
            g, cond = _inputs(ctx, pool, i)
            scale = torch.full((b,), float(tr["guidance"]), device=dev)
            with harness.precision(tf32), torch.no_grad():
                z = text.clip_text(clip_w, cfg["clip"], ids)
                sketch = text.sag_decode(sag_w, cfg["sag"], z, cond["origin_x"])
                ref = diffusion.sample(weights, cfg["rag"], cond, scale, g, method=tr["method"],
                                       respacing=tr["respacing"],
                                       steps=cfg["diffusion"]["steps"], skip=tr["skip"],
                                       init_image=sketch)
            if not tf32:
                base = ref
                gap = max(gap, max(harness.rel_gap(kept[i][r], ref[r]) for r in range(b)))
            else:
                control = max(control, max(harness.rel_gap(ref[r], base[r]) for r in range(b)))
    limit = tr["limits"]["clip_gap"]
    checks = {"clip_gap": [gap, limit]}
    if ctx.control:
        checks["control.clip_gap"] = [control, limit]
    c = cfg["rag"]
    steps = int(tr["respacing"][len("ddim"):]) - tr["skip"]
    flops = (arith.clip_text_flops(cfg["clip"], b)
             + arith.sag_decode_flops(cfg["sag"], c["nframes"], b)
             + steps * arith.denoiser_matmul_flops(c, 2 * b)
             + arith.wav_encoder_flops(arith.audio_samples_for_frames(c["nframes"]), b))
    obs["flops_per_unit"] = {"batches": flops}
    return harness.Outcome(
        setup_s=setup_s, e2e={tr["rate_metric"]: done * b / window},
        attempted=done * b, failed=0, checks=checks, obs=obs, memory_peak_bytes=peak,
        notes={"batches": done, "window_s": window, "checked_batches": pick})
