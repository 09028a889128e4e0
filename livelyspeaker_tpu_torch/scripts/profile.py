"""Capture a profile of the hot paths (sampling, training).

Port of the JAX package's ``scripts/profile.py``: writes a ``torch.profiler``
trace (Chrome trace format, ``<trace_dir>/trace.json``: chrome://tracing or
Perfetto) of the sampler or the train step at the TED configuration
(``RAGConfig.ted()``), so the card's kernels and the host's Python loop
between them can be read on one timeline; the counterpart of the bench
scripts' wall-clock numbers. One call is made outside the trace first, so
the trace holds no build or first-call work.

    python -m livelyspeaker_tpu_torch.scripts.profile --what sampler --trace_dir /tmp/ls_trace
    python -m livelyspeaker_tpu_torch.scripts.profile --what train --batch 512

The sampler runs each denoise step through the fused TransMLP kernel unless
``--no_fused``; the train step runs the eager backbone, as the JAX script's
does. It runs on the card unless ``--device`` says otherwise (``--device
cpu`` traces the plain versions on the CPU). The reference has no profiling
tooling (its eval scripts time nothing).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..models import RAG, RAGConfig, audio_samples_for_frames
from ..utils.device import place_model
from ..utils.profiling import TRACE_FILE, device_trace

__all__ = ["main", "profile_sampler", "profile_train"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model(cfg: RAGConfig) -> RAG:
    return RAG(cfg, generator=torch.Generator().manual_seed(0))


def profile_sampler(args) -> str:
    """``--iters`` sampled batches of ``--batch`` under the trace; returns
    the trace file."""
    from ..pipeline import RAGSampler

    cfg = RAGConfig.ted()
    model = _model(cfg)
    sampler = RAGSampler(
        model,
        steps=args.steps,
        timestep_respacing=args.timestep_respacing or None,
        method=args.sampler,
        use_fused=not args.no_fused,
        device=args.device,
    )
    dev = sampler.device
    rng = np.random.default_rng(0)
    b = args.batch
    cond = {
        "audio": torch.from_numpy(
            rng.normal(size=(b, audio_samples_for_frames(cfg.nframes))).astype(np.float32)),
        "vid": torch.from_numpy(rng.integers(0, cfg.n_speakers, size=(b,))),
        "origin_x": torch.zeros((b, cfg.njoints, cfg.nfeats, cfg.nframes)),
    }
    cond = {k: v.to(dev) for k, v in cond.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    sampler(cond, gen)  # build and first call outside the trace
    _sync(dev)
    with device_trace(args.trace_dir):
        for _ in range(args.iters):
            sampler(cond, gen)
        _sync(dev)
    print(f"sampler trace ({args.iters} iters, batch {b}) -> {args.trace_dir}")
    return os.path.join(args.trace_dir, TRACE_FILE)


def profile_train(args) -> str:
    """``--iters`` train steps at ``--batch`` under the trace; returns the
    trace file."""
    from ..diffusion import DiffusionSchedule
    from ..training import TrainConfig, init_train_state, make_optimizer, make_train_step
    from ..training.loop import step_generator

    cfg = RAGConfig.ted()
    model = _model(cfg)
    dev = place_model(model, args.device, "profile --what train")
    model.train()
    rng = np.random.default_rng(0)
    b = args.batch
    batch = {
        "motion": rng.normal(size=(b, cfg.njoints, cfg.nfeats, cfg.nframes)).astype(np.float32),
        "audio": rng.normal(size=(b, audio_samples_for_frames(cfg.nframes))).astype(np.float32),
        "vid": rng.integers(0, cfg.n_speakers, size=(b,)),
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    sched = DiffusionSchedule.create(steps=1000, schedule="cosine")
    tcfg = TrainConfig(lr=1e-4)
    tx = make_optimizer(tcfg)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=tcfg, num_timesteps=1000)
    step = make_train_step(model, sched, tx, tcfg)
    state, _ = step(state, batch, step_generator(0, 0, dev))  # first call outside the trace
    _sync(dev)
    with device_trace(args.trace_dir):
        for i in range(args.iters):
            state, _ = step(state, batch, step_generator(0, i + 1, dev))
        _sync(dev)
    print(f"train trace ({args.iters} steps, batch {b}) -> {args.trace_dir}")
    return os.path.join(args.trace_dir, TRACE_FILE)


def main(argv: Optional[List[str]] = None) -> str:
    """Profile as ``argv`` says; returns the trace file written."""
    p = argparse.ArgumentParser()
    p.add_argument("--what", choices=["sampler", "train"], default="sampler")
    p.add_argument("--trace_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "ls_torch_trace"))
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--timestep_respacing", type=str, default="")
    p.add_argument("--sampler", type=str, default="ddpm",
                   choices=["ddpm", "ddim", "plms", "dpmpp"])
    p.add_argument("--no_fused", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' traces the plain versions on the CPU; the default is the card")
    args = p.parse_args(argv)
    return (profile_sampler if args.what == "sampler" else profile_train)(args)


if __name__ == "__main__":
    main()
