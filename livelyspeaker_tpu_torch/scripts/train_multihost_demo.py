"""N-process data-parallel training demo over ``torch.distributed``.

Port of the JAX package's ``scripts/train_multihost_demo.py``: N processes,
each with its own local shards and its own shard of the data stream, take
one data-parallel step together (``parallel.shard_train_step`` over a mesh
that spans the process group). Launch, e.g. two processes on the CPU:

    python -m livelyspeaker_tpu_torch.scripts.train_multihost_demo --platform cpu --process_id 0 &
    python -m livelyspeaker_tpu_torch.scripts.train_multihost_demo --platform cpu --process_id 1

(four processes: add ``--num_processes 4`` and launch ``--process_id
0..3``). Each process runs on card ``process_id % cards`` (NCCL by
default; ``--backend gloo`` lets two processes share one card, which NCCL
refuses), and without a card it raises; ``--platform cpu`` runs it on the
CPU over gloo. Each process prints the global loss of each
step, the same on every process, then ``multihost demo OK``. When the
window count does not divide the process count, the loader truncates every
host's share to the common minimum, so the epoch tail stays in lockstep
(``data/loader.py``).
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

from ..data.loader import DataLoader
from ..data.synthetic import build_synthetic_ted_records
from ..data.ted import TedWindowDataset
from ..diffusion import DiffusionSchedule
from ..models import RAG, RAGConfig
from ..parallel import create_mesh, global_batch, init_distributed, shard_train_step
from ..training import TrainConfig, init_train_state, make_optimizer

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--coordinator", type=str, default="localhost:12355")
    p.add_argument("--num_processes", type=int, default=2)
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--devices_per_process", type=int, default=4,
                   help="local shards a process (the CPU, or its card, named this often)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--local_batch", type=int, default=4)
    p.add_argument("--latent_dim", type=int, default=32)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--platform", type=str, default="cuda", choices=["cpu", "cuda"],
                   help="cuda (the default) raises without a card; cpu runs over gloo")
    p.add_argument("--backend", type=str, default=None, choices=["gloo", "nccl"],
                   help="the process group's transport; default nccl on cards, gloo on "
                        "the CPU")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Run this process's part of the demo; returns its printed losses."""
    args = parse_args(argv)
    on_card = args.platform == "cuda" and torch.cuda.is_available()
    ids = [args.process_id % torch.cuda.device_count()] if on_card else None
    local = init_distributed(args.coordinator, args.num_processes, args.process_id,
                             local_device_ids=ids, backend=args.backend,
                             device="cpu" if args.platform == "cpu" else None)
    rank, world = dist.get_rank(), dist.get_world_size()
    data_dir = tempfile.mkdtemp(prefix=f"livelyspeaker_mh_{rank}.")
    try:
        return _train(args, local[0], rank, world, data_dir)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(data_dir, ignore_errors=True)


def _train(args, device, rank: int, world: int, data_dir: str) -> List[float]:
    # one mesh over every process's shards; pure data parallelism
    mesh = create_mesh(devices=[device] * args.devices_per_process)
    print(f"[p{rank}] {mesh.size} local / {mesh.shape['data']} global devices, "
          f"mesh={mesh.shape}", flush=True)

    # every process builds the same small records (fixed seed), then the
    # loader takes its strided share of the shared index stream
    build_synthetic_ted_records(data_dir, n_clips=2, clip_seconds=10)
    ds = TedWindowDataset(data_dir)
    loader = DataLoader(ds, args.local_batch, shuffle=True, seed=233, host_id=rank,
                        num_hosts=world, fields=("motion", "audio", "vid"))

    cfg = RAGConfig.ted(latent_dim=args.latent_dim, num_layers=args.layers)
    model = RAG(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    sched = DiffusionSchedule.create(steps=50, schedule="cosine")
    tcfg = TrainConfig(lr=1e-3)
    tx = make_optimizer(tcfg)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=tcfg,
                             num_timesteps=sched.num_timesteps)
    step_fn = shard_train_step(model, sched, tx, tcfg, mesh)
    print(f"[p{rank}] {len(ds)} windows -> {len(loader)} local batches/epoch (host shard "
          f"truncated to {len(ds) // world}; uneven={len(ds) % world != 0})", flush=True)
    if len(loader) == 0:
        raise SystemExit(f"dataset too small for this process count: {len(ds)} windows -> "
                         f"{len(ds) // world} per host < local_batch {args.local_batch}; "
                         "reduce --num_processes or --local_batch")
    losses = []
    it = iter(loader)
    for step in range(args.steps):
        try:
            batch = next(it)
        except StopIteration:  # every process ends its epoch at the same step
            it = iter(loader)
            batch = next(it)
        state, metrics = step_fn(state, global_batch(batch, mesh),
                                 torch.Generator(device=device).manual_seed(step))
        losses.append(metrics["loss"])
        print(f"[p{rank}] step={step} global_batch={world * args.local_batch} "
              f"loss={metrics['loss']:.6f} grad_norm={metrics['grad_norm']:.6f}", flush=True)
    print(f"[p{rank}] multihost demo OK", flush=True)
    return losses


if __name__ == "__main__":
    main()
