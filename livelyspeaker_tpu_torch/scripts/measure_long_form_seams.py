"""Long-form window-seam quality (``eval.metrics.long_form_seam_report``),
on the card.

Port of the JAX package's ``scripts/measure_long_form_seams.py``. The
long-form path (``pipeline.generate_long_form``) stitches windows through
the seed-frame mechanism (reference RAG.py:184-192): each window is seeded
with the last ``n_pre_seq`` frames of the one before. This measures the
quality a user sees: is the frame-to-frame velocity at a seam like the
motion inside a window (ratio about 1), or does the stitch jerk?

A trained RAG (``--model_path``, with the ``args.json`` of its run) generates
over long audio stitched from the dataset's clips (in-distribution
conditioning); the report gives seam against within-window velocity
percentiles. A random-weight model (``torch.Generator`` seed 5) is scored
as the null baseline. ``--fused`` samples every denoise step through the
fused TransMLP kernel (K1), once a step of each window.

    python -m livelyspeaker_tpu_torch.scripts.measure_long_form_seams \\
        --model_path /tmp/seam/model000001000.npz --seconds 60 --fused

Prints ``trained: {...}`` and ``random-baseline: {...}`` as the JAX script
does, then one JSON line of both, which :func:`main` returns.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..eval.metrics import long_form_seam_report
from ..models import RAG, RAGConfig
from ..pipeline import RAGSampler, generate_long_form
from ..utils.config import add_all_groups, apply_saved_args
from ..utils.device import place_model
from .eval_rag_ted import load_rag_params

__all__ = ["main", "parse_args", "build_audio", "score"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_all_groups(p, training=False)
    g = p.add_argument_group("seams")
    g.add_argument("--seconds", type=float, default=60.0,
                   help="length of stitched audio to generate over")
    g.add_argument("--respacing", type=str, default="ddim100")
    g.add_argument("--guidance", type=float, default=1.5)
    g.add_argument("--speaker", type=int, default=1)
    g.add_argument("--emotion", type=int, default=0,
                   help="emotion id for BEAT models (--num_emotions > 0)")
    g.add_argument("--with_random_baseline", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also score a random-init model for context "
                        "(--no-with_random_baseline skips the extra generation)")
    g.add_argument("--max_ratio", type=float, default=0.0,
                   help="fail if the trained seam ratio_p95 exceeds this (0 = report only)")
    return apply_saved_args(p.parse_args(argv), p)


def build_audio(args) -> np.ndarray:
    """``--seconds`` of 16 kHz audio, the dataset's clips end to end
    (``--dataset synthetic``: ``train_rag``'s synthetic records)."""
    if args.dataset == "synthetic":
        from .train_rag import synthetic_records_dir

        args.data_dir = synthetic_records_dir()
    if args.dataset == "beat":
        from ..data.beat import BeatWindowDataset

        ds = BeatWindowDataset(args.data_dir)
    else:
        from ..data import TedWindowDataset

        ds = TedWindowDataset(args.data_dir)
    want = int(args.seconds * 16000)
    pieces, i, total = [], 0, 0
    while total < want:
        audio = np.asarray(ds[i % len(ds)]["audio"], np.float32)
        pieces.append(audio)
        total += len(audio)
        i += 1
    return np.concatenate(pieces)[:want]


def score(model: RAG, args, audio: np.ndarray) -> Dict:
    """The seam report of one long-form generation over ``audio``."""
    sampler = RAGSampler(model, steps=args.diffusion_steps,
                         timestep_respacing=args.respacing, method="ddim",
                         use_fused=args.fused, guidance_schedule=args.guidance_schedule,
                         device=args.device)
    generator = torch.Generator(device=sampler.device).manual_seed(233)
    out = generate_long_form(sampler, audio, speaker=args.speaker, generator=generator,
                             guidance=args.guidance, emotion=args.emotion)
    rep = long_form_seam_report(out, model.cfg.nframes, model.cfg.n_pre_seq)
    rep["frames"] = int(out.shape[-1])
    return rep


def main(argv: Optional[List[str]] = None) -> Dict:
    """Measure as ``argv`` says; returns ``{"trained": report,
    "random_baseline": report or None}``."""
    args = parse_args(argv)
    cfg = RAGConfig(
        njoints=args.njoints, nfeats=args.nfeats, nframes=args.n_poses,
        latent_dim=args.latent_dim, num_layers=args.layers,
        mlpact=args.mlpact, n_speakers=args.n_speakers,
        num_emotions=args.num_emotions, cond_mask_prob=args.cond_mask_prob,
    )
    model = RAG(cfg)
    model.load_state_dict(load_rag_params(args.model_path, args))
    place_model(model, args.device, "measure_long_form_seams")  # raises before any work
    audio = build_audio(args)
    trained = score(model, args, audio)
    print(f"trained: {json.dumps(trained, sort_keys=True)}")
    out = {"trained": trained, "random_baseline": None}
    if args.with_random_baseline:
        rand = RAG(cfg, generator=torch.Generator().manual_seed(5))
        out["random_baseline"] = score(rand, args, audio)
        print(f"random-baseline: {json.dumps(out['random_baseline'], sort_keys=True)}")
    print(json.dumps(out, sort_keys=True))

    if args.max_ratio:
        p95 = trained["ratio_p95"]
        if trained["n_seams"] < 1 or not np.isfinite(p95):
            raise SystemExit(
                f"--max_ratio gate needs at least one seam to measure "
                f"(n_seams={trained['n_seams']}, ratio_p95={p95}); increase --seconds")
        if p95 > args.max_ratio:
            raise SystemExit(f"seam ratio_p95 {p95:.3f} > bound {args.max_ratio}")
    return out


if __name__ == "__main__":
    main()
