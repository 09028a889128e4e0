"""Flagship-scale training soak with a mid-run kill and resume, and FGD from
the raw and the EMA params, on the card.

Port of the JAX package's ``scripts/soak_flagship.py``. It runs the whole
training harness at the real configuration (latent 512, 8 mixer blocks,
batch 512) with the EMA, the loss-second-moment timestep sampler and the
quartile logging on (the reference's TrainLoop protocol,
scripts/train_utils/train_loop.py:108-225):

1. run A ("full"): ``--epochs`` epochs in one process;
2. run B ("split"): the same seed, ``--epochs // 2`` epochs, then a fresh
   process resumes from the checkpoint and finishes;
3. the two final param sets must be bit-identical (a resume replays the
   uninterrupted run: per-step generators, an epoch-seeded loader, and the
   sampler's history and the EMA in the checkpoint);
4. FGD against a frozen fixture embedder from both the raw and the EMA
   params of run A; with ``--ema_warmup`` the EMA must score within
   ``--ema_fgd_factor`` of the raw params.

Each run is ``python -m livelyspeaker_tpu_torch.scripts.train_rag`` in a
process of its own, with cuDNN pinned to deterministic algorithms
(``torch.backends.cudnn.deterministic = True``, ``benchmark = False``) in
each of the three: cuDNN's default algorithms may sum a weight gradient in
another order from run to run. The records are built in this process
(``data/synthetic.py``, PCM16 on TED). Prints one JSON line, returned by
:func:`main`; raises on a mismatch.

    python -m livelyspeaker_tpu_torch.scripts.soak_flagship [--epochs 1500] \\
        [--batch_size 512] [--fused_train] [--out /tmp/soak] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .eval_common import final_npz, fixture_evaluator, fixture_fgd, run_train_rag
from ..utils.device import resolve_device

__all__ = ["main", "parse_args", "build_records", "train_runs", "train_argv", "param_delta"]


def train_argv(save_dir: str, epochs: int, data_dir: str, a,
               resume: bool = False) -> List[str]:
    argv = [
        "--dataset", a.dataset, "--data_dir", data_dir,
        "--latent_dim", str(a.latent_dim), "--layers", str(a.layers),
        "--batch_size", str(a.batch_size), "--epochs", str(epochs),
        "--save_dir", save_dir, "--save_interval", str(a.save_interval),
        "--log_interval", str(a.log_interval),
        "--schedule_sampler", "loss-second-moment",
        # the EMA horizon must fit the run: at rate r the init keeps weight
        # r^steps (0.9999^3000 = 0.74, an EMA still mostly the random init;
        # 0.999^3000 = 0.05); the reference's 0.9999 presumes 100k+ steps
        "--ema_rate", str(a.ema_rate),
        "--device_resident", "1",
        "--seed", "233",
    ]
    if a.ema_warmup:
        argv.append("--ema_warmup")
    if a.fused_train:
        argv.append("--fused_train")
    if a.audio_bf16:
        argv.append("--audio_bf16")
    if resume:
        argv += ["--resume_checkpoint", "1"]
    return argv


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=1500)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--save_interval", type=int, default=100)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--n_clips", type=int, default=40)
    p.add_argument("--ema_rate", type=float, default=0.999)
    p.add_argument("--ema_warmup", action=argparse.BooleanOptionalAction, default=True,
                   help="warmed-up EMA decay (training/trainer.py): a soak whose EMA "
                        "checkpoint scores far off the raw params validates nothing "
                        "(--no-ema_warmup keeps the raw decay's lag)")
    p.add_argument("--ema_fgd_factor", type=float, default=5.0,
                   help="fail unless fgd_ema <= factor * max(fgd_raw, 1e-3)")
    p.add_argument("--fused_train", action="store_true",
                   help="soak the fused training kernels (the resume must be bit-exact "
                        "there too)")
    p.add_argument("--audio_bf16", action="store_true",
                   help="soak with the bf16 WavEncoder")
    p.add_argument("--out", type=str, default="/tmp/soak_flagship")
    p.add_argument("--dataset", type=str, default="ted", choices=["ted", "beat"],
                   help="beat soaks the scripts_beat protocol: 47x6 rot6d, seq 36, "
                        "emotion token, kld weight 0")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' trains and scores on the CPU; the default is the card")
    return p.parse_args(argv)


def build_records(a) -> str:
    """The soak's synthetic records (20 s clips; PCM16 on TED, the storage
    format the WavEncoder decodes on the device), built once."""
    data_dir = os.path.join(a.out, f"records_{a.dataset}")
    if not os.path.exists(os.path.join(data_dir, "meta.json")):
        print(f"building {a.n_clips}-clip synthetic records...", file=sys.stderr)
        if a.dataset == "beat":
            from ..data.synthetic import build_synthetic_beat_records

            build_synthetic_beat_records(data_dir, n_clips=a.n_clips, clip_seconds=20)
        else:
            from ..data.synthetic import build_synthetic_ted_records
            from ..data.ted import TedConfig

            build_synthetic_ted_records(data_dir, n_clips=a.n_clips, clip_seconds=20,
                                        cfg=TedConfig(audio_dtype="int16"))
    return data_dir


def param_delta(path_a: str, path_b: str):
    """(max |a - b| over every leaf of two npz checkpoints, the leaf where
    it is largest)."""
    pa, pb = np.load(path_a), np.load(path_b)
    if sorted(pa.files) != sorted(pb.files):
        raise AssertionError("the two runs saved other param trees")
    worst, leaf = 0.0, None
    for k in sorted(pa.files):
        d = float(np.max(np.abs(pa[k] - pb[k]))) if pa[k].size else 0.0
        if leaf is None or d > worst:
            worst, leaf = d, k
    return worst, leaf


def train_runs(a, data_dir: str, cudnn_deterministic: bool = True) -> Dict:
    """The full run and the split run with its resume; their params
    compared. Returns the run directories, the full run's seconds and the
    largest param difference with its leaf."""
    full_dir, split_dir = f"{a.out}/full", f"{a.out}/split"
    run = lambda argv: run_train_rag(argv, device=a.device,
                                     cudnn_deterministic=cudnn_deterministic)
    t0 = time.time()
    run(train_argv(full_dir, a.epochs, data_dir, a))
    t_full = time.time() - t0
    run(train_argv(split_dir, a.epochs // 2, data_dir, a))
    run(train_argv(split_dir, a.epochs, data_dir, a, resume=True))
    max_delta, leaf = param_delta(final_npz(full_dir), final_npz(split_dir))
    print(f"resume exactness: max|delta|={max_delta} at {leaf}", file=sys.stderr)
    return {"full_dir": full_dir, "split_dir": split_dir, "full_run_seconds": t_full,
            "max_delta": max_delta, "leaf": leaf}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Soak as ``argv`` says; returns the printed summary."""
    a = parse_args(argv)
    device = resolve_device(a.device, "soak_flagship")
    os.makedirs(a.out, exist_ok=True)
    data_dir = build_records(a)
    runs = train_runs(a, data_dir)
    bit_exact = runs["max_delta"] == 0.0

    from ..models import RAG, RAGConfig

    if a.dataset == "beat":
        from ..data.beat import BeatWindowDataset

        dataset = BeatWindowDataset(data_dir)
        cfg = RAGConfig.beat(njoints=dataset.cfg.njoints, latent_dim=a.latent_dim,
                             num_layers=a.layers)
    else:
        from ..data import TedWindowDataset

        dataset = TedWindowDataset(data_dir)
        cfg = RAGConfig.ted(latent_dim=a.latent_dim, num_layers=a.layers)
    model = RAG(cfg)
    fixture = fixture_evaluator(cfg.njoints * cfg.nfeats, device=device)
    fgd_raw = fixture_fgd(model, dataset, final_npz(runs["full_dir"]), fixture, device=device)
    fgd_ema = fixture_fgd(model, dataset, final_npz(runs["full_dir"], prefix="model_ema"),
                          fixture, device=device)

    out = {
        "epochs": a.epochs,
        "batch_size": a.batch_size,
        "full_run_seconds": round(runs["full_run_seconds"], 1),
        "resume_bit_exact": bit_exact,
        "resume_max_param_delta": runs["max_delta"],
        "resume_worst_leaf": runs["leaf"],
        "fgd_raw": fgd_raw,
        "fgd_ema": fgd_ema,
        "ema_warmup": a.ema_warmup,
    }
    print(json.dumps(out))
    if not bit_exact:
        raise AssertionError(f"flagship-scale resume is not bit-exact: max|delta| "
                             f"{runs['max_delta']} at {runs['leaf']}")
    if a.ema_warmup:
        lim = a.ema_fgd_factor * max(fgd_raw, 1e-3)
        if not fgd_ema <= lim:
            raise AssertionError(
                f"EMA checkpoint unusable: fgd_ema={fgd_ema:.4g} > "
                f"{a.ema_fgd_factor} x max(fgd_raw, 1e-3) = {lim:.4g}")
    return out


if __name__ == "__main__":
    main()
