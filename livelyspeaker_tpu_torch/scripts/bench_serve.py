"""Serving throughput benchmark: a sustained burst through the dynamic
batcher.

Port of the JAX package's ``scripts/bench_serve.py``: served clips/s end to
end (submit to result handed back) through ``serving.GestureBatcher`` at
full TED (or BEAT) width on seeded random weights, at a given
``--pipeline_depth``: the dispatch/collect split that overlaps the host's
batch assembly and read-back with the card's work, so depth 0 against
depth 1 measures that overlap. ``--single N`` adds N requests one at a time
(the unloaded latency: batching window, padded chain, read-back);
``--text_frac`` sends that share of the burst with text, through the
two-stage composition (seeded random SAG and CLIP towers: a throughput
bench, not quality).

    python -m livelyspeaker_tpu_torch.scripts.bench_serve --max_batch 16 --burst 256 --pipeline_depth 0
    python -m livelyspeaker_tpu_torch.scripts.bench_serve --max_batch 16 --burst 256 --pipeline_depth 1

Each denoise step runs the fused TransMLP kernel unless ``--no_fused``. It
serves on the card unless ``--device`` says otherwise (``--device cpu`` runs
the plain versions on the CPU). The reference has no serving path at all
(its eval scripts loop a fixed dataset, scripts/test_RAG_ted.py:142-193).
"""

from __future__ import annotations

import argparse
import math
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> dict:
    """Benchmark as ``argv`` says; returns the numbers of the printed
    line(s) and ``batches``, every batch the batcher served (the warm-up,
    the single requests and the burst)."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="ted", choices=["ted", "beat"],
                   help="beat serves the 47x6 rot6d, emotion-conditioned configuration "
                        "(test_RAG_beat.py's shape), S=36 in the fused kernel")
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--burst", type=int, default=256)
    p.add_argument("--clients", type=int, default=8, help="submitter threads")
    p.add_argument("--pipeline_depth", type=int, default=1)
    p.add_argument("--single", type=int, default=0,
                   help="also measure N sequential single requests (the unloaded "
                        "latency: batching window, padded chain, read-back)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--timestep_respacing", type=str, default="ddim20")
    p.add_argument("--sampler", type=str, default="dpmpp")
    p.add_argument("--no_fused", action="store_true")
    p.add_argument("--text_frac", type=float, default=0.0,
                   help="share of burst requests carrying text, served through the "
                        "SAG -> skip-80 composition; 0 attaches no composition")
    p.add_argument("--composition_respacing", type=str, default="ddim100",
                   help="respacing of the composition (skip 80 presumes the ddim100 grid)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' serves the plain versions on the CPU; the default is the card")
    args = p.parse_args(argv)

    from ..data import HashTokenizer
    from ..models import RAG, SAG, CLIPTextEncoder, RAGConfig, audio_samples_for_frames
    from ..pipeline import LivelySpeakerPipeline
    from ..serving import ServeConfig, build_rag_server

    if args.dataset == "beat":
        cfg = RAGConfig.beat(latent_dim=args.latent_dim, num_layers=args.layers, n_speakers=30)
    else:
        cfg = RAGConfig.ted(latent_dim=args.latent_dim, num_layers=args.layers)
    model = RAG(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    n_samples = audio_samples_for_frames(cfg.nframes)

    serve_cfg = ServeConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        steps=args.steps,
        timestep_respacing=args.timestep_respacing or None,
        sampler=args.sampler,
        use_fused=not args.no_fused,
        max_queue=max(128, args.burst),
        pipeline_depth=args.pipeline_depth,
    )
    composition = None
    if args.text_frac > 0:
        g = torch.Generator().manual_seed(7)
        composition = LivelySpeakerPipeline(
            model, SAG(njoints=cfg.njoints, nfeats=cfg.nfeats, latent_dim=512, generator=g),
            CLIPTextEncoder(generator=g), HashTokenizer(), steps=args.steps,
            timestep_respacing=args.composition_respacing, skip_timesteps=80,
            use_fused=serve_cfg.use_fused, device=args.device)
        n_spaced = int(composition.rag_sampler.sched.num_timesteps)
        if n_spaced - 80 <= 0:
            raise SystemExit(
                f"skip 80 leaves no refinement steps on the {args.composition_respacing} grid "
                f"({n_spaced} steps); use a finer --composition_respacing")
    batcher = build_rag_server(model, serve_cfg, composition=composition, device=args.device)
    print(f"device: {batcher.device}", file=sys.stderr)
    batches = 0

    def served_so_far():
        return batcher.stats()["batches_served"]

    summary = {"device": str(batcher.device), "dataset": args.dataset,
               "text_frac": args.text_frac, "burst": args.burst,
               "max_batch": args.max_batch, "depth": args.pipeline_depth,
               "sampler": f"{args.sampler}-{args.timestep_respacing}"}
    try:
        t0 = time.perf_counter()
        batcher.generate(np.zeros(n_samples, np.float32), timeout=3600.0)
        if composition is not None:
            batcher.generate(np.zeros(n_samples, np.float32), text="warmup", timeout=3600.0)
        summary["warm_s"] = round(time.perf_counter() - t0, 3)
        print(f"warm-up (kernel build, first calls): {summary['warm_s']:.1f}s", file=sys.stderr)
        # the warm-up's first-call latency would become the p99, and its
        # batch of one would understate the mean occupancy
        batches += served_so_far()
        batcher.reset_stats()

        if args.single:
            lats = []
            wav1 = rng.normal(size=n_samples).astype(np.float32)
            for i in range(args.single):
                t0 = time.perf_counter()
                out = batcher.generate(wav1, timeout=600.0, speaker=i % 10)
                lats.append((time.perf_counter() - t0) * 1e3)
                assert np.isfinite(out).all()
            lats.sort()
            summary.update(single=args.single, single_p50_ms=lats[len(lats) // 2],
                           single_min_ms=lats[0], single_max_ms=lats[-1])
            print(f"single-request latency (n={args.single}, max_batch={args.max_batch}, "
                  f"wait={args.max_wait_ms}ms): p50={lats[len(lats) // 2]:.0f}ms "
                  f"min={lats[0]:.0f}ms max={lats[-1]:.0f}ms")
            batches += served_so_far()
            batcher.reset_stats()

        audio = rng.normal(size=(args.burst, n_samples)).astype(np.float32)
        speakers = rng.integers(0, cfg.n_speakers, size=args.burst)
        guid = rng.choice([1.0, 1.5, 2.0], size=args.burst)
        reqs = [None] * args.burst
        idx_lock = threading.Lock()
        next_idx = [0]

        def submit_worker():
            while True:
                with idx_lock:
                    i = next_idx[0]
                    if i >= args.burst:
                        return
                    next_idx[0] += 1
                # text requests spread evenly through the burst (Bresenham):
                # blocked runs would leave the per-kind batch split idle
                with_text = args.text_frac > 0 and (
                    math.floor(i * args.text_frac) > math.floor((i - 1) * args.text_frac))
                reqs[i] = batcher.submit(
                    audio[i], speaker=int(speakers[i]), guidance=float(guid[i]),
                    emotion=int(i % max(cfg.num_emotions, 1)),
                    text="a person waves both hands" if with_text else None)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit_worker) for _ in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_submitted = time.perf_counter() - t0
        for r in reqs:
            out = r.wait(timeout=3600.0)
            assert np.isfinite(out).all()
        elapsed = time.perf_counter() - t0
        st = batcher.stats()
        batches += st["batches_served"]
    finally:
        batcher.close()

    summary.update(seconds=elapsed, clips_per_sec=args.burst / elapsed,
                   submit_drain_s=t_submitted, occupancy=st["mean_batch_occupancy"],
                   p50_ms=st["latency_ms_p50"], p95_ms=st["latency_ms_p95"],
                   p99_ms=st["latency_ms_p99"], batches=batches,
                   burst_batches=st["batches_served"])
    text_tag = f" text_frac={args.text_frac}" if args.text_frac > 0 else ""
    print(f"[{args.dataset}{text_tag}] burst={args.burst} max_batch={args.max_batch} "
          f"depth={args.pipeline_depth} sampler={args.sampler}-{args.timestep_respacing}: "
          f"{elapsed:.3f}s ({args.burst / elapsed:.1f} clips/s), submit drain "
          f"{t_submitted:.3f}s, occupancy {st['mean_batch_occupancy']:.1f}/{args.max_batch}, "
          f"p50={st['latency_ms_p50']:.0f}ms p95={st['latency_ms_p95']:.0f}ms "
          f"p99={st['latency_ms_p99']:.0f}ms")
    return summary


if __name__ == "__main__":
    main()
