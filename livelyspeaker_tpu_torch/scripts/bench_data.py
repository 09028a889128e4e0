"""Input-pipeline throughput benchmark.

Port of the JAX package's ``scripts/bench_data.py``: whether the data path
alone (memory-mapped record shards, the numpy batch gather, the background
prefetch thread and, on the card, the pinned copy) can feed the train step.
Batches go to the card, as ``train_rag``'s loader sends them, unless
``--device cpu`` keeps them on the host.

Prints one JSON line per run (the training fields, all fields, the training
fields from PCM16-audio records):
    {"metric": "ted_loader_clips_per_sec_train_fields", "value": ...,
     "unit": "clips/s", "train_step_demand": ..., "headroom_x": ...}

    python -m livelyspeaker_tpu_torch.scripts.bench_data [--batch 512] [--epochs 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import torch

__all__ = ["main", "TRAIN_STEP_DEMAND"]

# clips/s of the fused TED train step at batch 512 on one fixed batch
# (chip_smoke.py's training run on an NVIDIA H100 80GB HBM3 at 700 W)
TRAIN_STEP_DEMAND = 9709.5


def _records(data_dir: str, **cfg_kw) -> str:
    from ..data.synthetic import build_synthetic_ted_records
    from ..data.ted import TedConfig

    if not os.path.exists(os.path.join(data_dir, "meta.json")):
        print(f"building synthetic records in {data_dir}...", file=sys.stderr)
        build_synthetic_ted_records(data_dir, n_clips=24, clip_seconds=60,
                                    cfg=TedConfig(**cfg_kw))
    return data_dir


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Benchmark as ``argv`` says; returns the rows printed."""
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--data_dir", type=str, default="",
                   help="records to read; without it synthetic ones (f32 and PCM16 audio) "
                        "are built once under --synthetic_dir")
    p.add_argument("--synthetic_dir", type=str, default=tempfile.gettempdir())
    p.add_argument("--train_step_demand", type=float, default=TRAIN_STEP_DEMAND,
                   help="clips/s the train step consumes (default: the fused TED step at "
                        "batch 512 on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' keeps the batches on the host; the default sends them to "
                        "the card")
    args = p.parse_args(argv)

    from ..data import DataLoader, TedWindowDataset

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("bench_data delivers batches to an NVIDIA GPU by default and "
                           "torch.cuda.is_available() is False; pass --device cpu")
    device = torch.device(args.device or "cuda")
    tmp = args.synthetic_dir
    ds = TedWindowDataset(args.data_dir or _records(os.path.join(tmp, "ls_torch_bench_data")))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def measure(fields, d):
        loader = DataLoader(d, batch_size=args.batch, shuffle=True, drop_last=True, seed=0,
                            fields=fields, device=device)
        for _ in loader:  # warm: page cache, thread start, pinned buffers
            pass
        sync()
        t0 = time.perf_counter()
        clips = 0
        for _ in range(args.epochs):
            for batch in loader:
                clips += batch["motion"].shape[0]
        sync()
        return clips / (time.perf_counter() - t0)

    print(f"dataset: {len(ds)} windows at batch {args.batch}", file=sys.stderr)
    runs = [("train_fields", ("motion", "audio", "vid"), ds), ("all_fields", None, ds)]
    if not args.data_dir:  # PCM16 audio: lossless against 16-bit WAVs, half the bytes
        ds16 = TedWindowDataset(_records(os.path.join(tmp, "ls_torch_bench_data_i16"),
                                         audio_dtype="int16"))
        runs.append(("train_fields_pcm16", ("motion", "audio", "vid"), ds16))
    rows = []
    for name, fields, d in runs:
        rate = measure(fields, d)
        rows.append({
            "metric": f"ted_loader_clips_per_sec_{name}",
            "value": round(rate, 1),
            "unit": "clips/s",
            "train_step_demand": args.train_step_demand,
            "headroom_x": round(rate / args.train_step_demand, 2),
            "batch_ms": round(1e3 * args.batch / rate, 2),
        })
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
