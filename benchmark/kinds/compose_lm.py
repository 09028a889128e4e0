"""The two-stage composition with a language model's text tower:
``LivelySpeakerPipeline.__call__`` on batches of ``batch`` sentences back
to back, a DeepSeek-V3 stack (``models/moe_text.py``, the configuration's
top-level keys) in CLIP's place, then the SAG's decode and the RAG's
refinement as in ``kinds/compose.py``, whose window, rate and conditioning
this shares.

Batch k's sentences are drawn from the seed: each ``tokens`` [lo, hi] ids
long, log-uniform, the ids uniform over the vocabulary; the tokenizer pads
them to the batch's longest and gives their lengths. The tower's weights
are made once on the card (``benchmark/weights_lm.py``); the port's module
is built on the meta device and takes those tensors in place, and the
reference reads the same tensors once the program is freed.

Correctness: ``check_batches`` batches of the window, drawn from the seed
after it. What the timed path produced, the features ``z`` and the routing
of its tower call and the final clips, is compared with the plain
reference (``reference/moe_text.py``, then ``reference/text.sag_decode``
and ``reference/diffusion.sample`` from the same generator seeds):

- ``text_gap``: the worst sentence's max |z - z_ref| over its max |z_ref|,
  the reference following the program's routing (weighted by its own
  scores);
- ``route_margin``: the worst, over every real token and routed layer, of
  the reference's k-th best biased score less its lowest among the
  program's choices (0 where every choice agrees);
- ``clip_gap``: as in ``kinds/compose.py``, the reference composing from
  its own ``z``.

The control (``ctx.control``) is the reference in TF32, routing on its own
scores, in the program's place.
"""

from __future__ import annotations

import random
import statistics

import numpy as np
import torch

from .. import arith, arith_lm, harness, weights_lm
from ..reference import diffusion, moe_text, text
from ..weights import derive_seed, seeded_tensors, shapes_of
from .common import audio_pool, batch_window, build_rag, draw_cond, gen


def token_ids(cfg, tr, seed, k):
    """The ids of batch k's sentences, one array a sentence."""
    rng = np.random.default_rng(derive_seed(seed, "tokens", k))
    lo, hi = tr["tokens"]
    n = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=tr["batch"])).astype(np.int64)
    return [rng.integers(0, cfg["vocab_size"], size=int(min(max(m, lo), hi))) for m in n]


def padded(rows):
    """(ids [B, longest] padded with 0, lengths [B])."""
    lengths = np.array([len(r) for r in rows], np.int64)
    ids = np.zeros((len(rows), int(lengths.max())), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids, lengths


class Tokenizer:
    """The ids of the sentence names a batch's sentences carry, padded to
    the batch's longest."""

    def __init__(self):
        self.ids = {}

    def __call__(self, sentences):
        return padded([self.ids[s] for s in sentences])


def _inputs(ctx, pool, k):
    g = gen(ctx.device, ctx.seed, "batch", k)
    cond, _ = draw_cond(ctx.config, pool, ctx.traffic["batch"], g)
    return g, cond


def _kept_calls(tower, kept):
    """Make the tower's calls keep their features and routing."""
    call = tower.forward

    def forward(ids, lengths):
        z, routing = call(ids, lengths, return_routing=True)
        kept.append((z, routing))
        return z

    tower.forward = forward


def _row_gap(prog, ref) -> float:
    return max(harness.rel_gap(prog[r], ref[r]) for r in range(ref.shape[0]))


def run(ctx: harness.Ctx) -> harness.Outcome:
    from livelyspeaker_tpu_torch.models import SAG, MoETextConfig, MoETextEncoder
    from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    rag, weights = build_rag(cfg, ctx.seed, dev)
    sag = SAG(**{k: cfg["sag"][k] for k in ("njoints", "nfeats", "latent_dim", "ff_size",
                                            "num_layers", "num_heads", "n_pre_poses")})
    sag_w = seeded_tensors(shapes_of(sag), ctx.seed, "sag", dev)
    sag.to(dev).load_state_dict(sag_w)
    with torch.device("meta"):
        tower = MoETextEncoder(MoETextConfig.from_hf(cfg, out_dim=cfg["text_tower"]["out_dim"]))
    lm_w = weights_lm.seeded_tensors(shapes_of(tower), ctx.seed, "moe_text", dev)
    tower.load_state_dict(lm_w, assign=True)
    kept = []
    _kept_calls(tower, kept)
    tok = Tokenizer()
    pipe = LivelySpeakerPipeline(rag, sag, tower, tok, steps=cfg["diffusion"]["steps"],
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
    kept.clear()
    obs = {}
    tracer = harness.Tracer(ctx, obs)
    tracer.warm()
    setup_s = harness.now() - ctx.t0
    outs, done, window = batch_window(ctx, one, tracer)
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    pick = sorted(random.Random(derive_seed(ctx.seed, "check")).sample(
        range(done), min(tr["check_batches"], done)))
    checked = {i: (outs[i],) + kept[i] for i in pick}
    del outs, kept, pipe, rag, sag, tower
    harness.free_device()

    def compose(z, i):
        g, cond = _inputs(ctx, pool, i)
        scale = torch.full((b,), float(tr["guidance"]), device=dev)
        sketch = text.sag_decode(sag_w, cfg["sag"], z, cond["origin_x"])
        return diffusion.sample(weights, cfg["rag"], cond, scale, g, method=tr["method"],
                                respacing=tr["respacing"], steps=cfg["diffusion"]["steps"],
                                skip=tr["skip"], init_image=sketch)

    gaps = dict.fromkeys(("text_gap", "route_margin", "clip_gap"), 0.0)
    control = dict(gaps)
    for i in pick:
        clips, z, routing = checked[i]
        ids, lengths = padded(token_ids(cfg, tr, ctx.seed, i))
        ids = torch.from_numpy(ids).to(dev)
        with harness.precision(False), torch.no_grad():
            z_ref, _, margin = moe_text.forward(lm_w, cfg, ids, lengths, routing=routing)
            ref = compose(z_ref, i)
        for k, v in (("text_gap", _row_gap(z, z_ref)), ("route_margin", margin),
                     ("clip_gap", _row_gap(clips, ref))):
            gaps[k] = max(gaps[k], v)
        if ctx.control:
            with harness.precision(True), torch.no_grad():
                z_c, routing_c, _ = moe_text.forward(lm_w, cfg, ids, lengths)
                clips_c = compose(z_c, i)
            with harness.precision(False), torch.no_grad():
                z_f, _, margin_c = moe_text.forward(lm_w, cfg, ids, lengths, routing=routing_c)
            for k, v in (("text_gap", _row_gap(z_c, z_f)), ("route_margin", margin_c),
                         ("clip_gap", _row_gap(clips_c, ref))):
                control[k] = max(control[k], v)
    checks = {k: [v, tr["limits"][k]] for k, v in gaps.items()}
    if ctx.control:
        checks.update({f"control.{k}": [v, tr["limits"][k]] for k, v in control.items()})

    # the work of the traced batches (the first trace_units), a batch
    traced = [[len(r) for r in token_ids(cfg, tr, ctx.seed, k)]
              for k in range(tr["trace_units"])]
    lm = [arith_lm.tower_flops(cfg, lengths) for lengths in traced]
    c = cfg["rag"]
    steps = int(tr["respacing"][len("ddim"):]) - tr["skip"]
    rest = (arith.sag_decode_flops(cfg["sag"], c["nframes"], b)
            + steps * arith.denoiser_matmul_flops(c, 2 * b)
            + arith.wav_encoder_flops(arith.audio_samples_for_frames(c["nframes"]), b))
    obs["flops_per_unit"] = {"batches": statistics.mean(f["total"] for f in lm) + rest}
    obs["lm_flops_per_batch"] = {part: statistics.mean(f[part] for f in lm)
                                 for part in ("attn", "route", "ffn")}
    return harness.Outcome(
        setup_s=setup_s, e2e={tr["rate_metric"]: done * b / window},
        attempted=done * b, failed=0, checks=checks, obs=obs, memory_peak_bytes=peak,
        notes={"batches": done, "window_s": window, "checked_batches": pick,
               "real_tokens_traced": [sum(t) for t in traced]})
