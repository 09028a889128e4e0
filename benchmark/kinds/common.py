"""Building the program's models from a configuration file and the seed,
and the inputs every kind draws."""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from .. import arith
from ..weights import derive_seed, seeded_tensors, shapes_of

RAG_KEYS = ("njoints", "nfeats", "nframes", "latent_dim", "num_layers", "mlpact", "n_pre_seq",
            "n_speakers", "speaker_dim", "audio_feat_dim", "num_emotions", "cond_mask_prob")
GUIDANCES = (1.0, 1.5, 2.0)


def build_rag(config: Dict, seed: int, device, **kw) -> Tuple[torch.nn.Module, Dict]:
    """The port's RAG for ``config['rag']`` on ``device`` with the seeded
    weights, and those weights (the harness's tensors, which the reference
    reads)."""
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig

    model = RAG(RAGConfig(**{k: config["rag"][k] for k in RAG_KEYS}, **kw))
    w = seeded_tensors(shapes_of(model), seed, "rag", device)
    model.to(device)
    model.load_state_dict(w)
    return model, w


def seq_len(rag: Dict) -> int:
    """Tokens a sequence holds in the mixer: the frames, the style token
    and on BEAT the emotion token."""
    return rag["nframes"] + 1 + (1 if rag["num_emotions"] else 0)


def k1_call(rag: Dict, rows: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one K1 call over ``rows`` sequences."""
    return arith.k1_cost(rows, seq_len(rag), rag["latent_dim"], rag["num_layers"],
                         rag["njoints"] * rag["nfeats"])


def n_samples(config: Dict) -> int:
    return arith.audio_samples_for_frames(config["rag"]["nframes"])


def gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))


def audio_pool(config: Dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` seeded waveforms [n, L] on ``device`` (normal, 0.1 rms)."""
    g = gen(device, seed, "audio")
    return torch.randn((n, n_samples(config)), generator=g, device=device).mul_(0.1)


def clip_shape(config: Dict) -> Tuple[int, int, int]:
    c = config["rag"]
    return c["njoints"], c["nfeats"], c["nframes"]


def draw_cond(config: Dict, pool: torch.Tensor, b: int, g: torch.Generator) -> Dict:
    """A batch's conditioning, drawn from ``g`` in a fixed order: pool rows,
    speakers, emotions (BEAT), guidance indices into :data:`GUIDANCES`,
    seed motion; all on ``g``'s device."""
    c = config["rag"]
    dev = g.device
    cond = {"audio": pool[torch.randint(pool.shape[0], (b,), generator=g, device=dev)],
            "vid": torch.randint(c["n_speakers"], (b,), generator=g, device=dev)}
    if c["num_emotions"]:
        cond["emo"] = torch.randint(c["num_emotions"], (b,), generator=g, device=dev)
    gi = torch.randint(len(GUIDANCES), (b,), generator=g, device=dev)
    scale = torch.tensor(GUIDANCES, device=dev)[gi]
    cond["origin_x"] = torch.randn((b,) + clip_shape(config), generator=g, device=dev)
    return cond, scale


def batch_window(ctx, one, tracer):
    """Run ``one(k)`` for k = 0, 1, ... back to back until the first batch
    completion at or after ``ctx.seconds`` from the start, read after a
    synchronise (on the card, batch k - 1's completion is read once batch k
    is enqueued). The first ``trace_units`` batches are traced. Returns
    (the outputs, the batches done, the window's seconds)."""
    dev = ctx.device
    units = ctx.traffic["trace_units"]
    outs, events = [], []
    t_start = time.monotonic()
    tracer.start()
    k = 0
    while True:
        outs.append(one(k))
        if dev.type == "cuda":
            events.append(torch.cuda.Event())
            events[-1].record()
        if k + 1 == units:
            tracer.stop(batches=units)
        if k >= 1 or dev.type != "cuda":
            done = k if dev.type == "cuda" else k + 1
            if events:
                events[done - 1].synchronize()
            t_end = time.monotonic()
            if t_end - t_start >= ctx.seconds and not tracer.active:
                break
        k += 1
    tracer.finish()
    return outs, done, t_end - t_start
