"""Train a gesture autoencoder to serve as the FGD/FID evaluation fixture,
on the card.

Port of the JAX package's ``scripts/train_gesture_autoencoder.py``:

    python -m livelyspeaker_tpu_torch.scripts.train_gesture_autoencoder \\
        --dataset ted --data_dir RECORDS --batch_size 512 --epochs 100 \\
        --base 32 --save_dir /tmp/gesture_ae

The reference downloads its frozen TriModal autoencoder (README.md:72,
ted_evaluator.py:14-23); this trains an equivalent fixture from TED records
(``vec_seq``, [B, 34, 27]): ``models.embedding_net.GestureAutoencoder``,
the mean squared reconstruction error, Adam with optax's defaults (b1 0.9,
b2 0.999, eps 1e-8). It writes ``gesture_ae{step:09d}.npz`` in the JAX
script's layout: the flat ``{"params", "batch_stats"}`` tree of the Flax
module, which ``utils.convert.flax_variables_to_state_dict`` loads back.

Where the port differs: the run is on the card unless ``--device`` names
another device (``--device cpu`` for the CPU); the weights are initialised
from torch's generator seeded with ``--seed``, where the JAX script draws
them from ``jax.random``; the KV log also records ``elapsed_s`` at each line.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import DataLoader, TedWindowDataset
from ..models.embedding_net import GestureAutoencoder
from ..training.checkpoints import save_args
from ..training.logging import KVLogger
from ..utils.config import add_all_groups
from ..utils.convert import flatten_tree, state_dict_to_flax_variables
from ..utils.device import place_model
from .train_rag import synthetic_records_dir

__all__ = ["parse_args", "main", "save_autoencoder_npz"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a gesture autoencoder (FGD/FID fixture).")
    add_all_groups(p, training=True)
    g = p.add_argument_group("autoencoder")
    g.add_argument("--base", type=int, default=32)
    args = p.parse_args(argv)
    if args.ema_rate or args.ema_warmup:
        p.error("--ema_rate/--ema_warmup apply to the RAG trainer only; "
                "this loop keeps no EMA shadow")
    if args.pipeline_parallel:
        p.error("--pipeline_parallel applies to the RAG trainer only")
    return args


def save_autoencoder_npz(path: str, model: GestureAutoencoder) -> None:
    """``model`` as the JAX script's npz: ``params/...`` and
    ``batch_stats/...`` of the Flax ``GestureAutoencoder``."""
    np.savez(path, **flatten_tree(state_dict_to_flax_variables(model.state_dict(), model)))


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train as ``argv`` says; returns ``{"step", "losses", "model", "path"}``
    (``losses``: the logged reconstruction MSEs)."""
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dataset == "synthetic":
        args.data_dir = synthetic_records_dir()

    dataset = TedWindowDataset(args.data_dir)
    batch_size = min(args.batch_size, max(len(dataset) // 2, 1))
    model = GestureAutoencoder(pose_dim=args.njoints * args.nfeats, n_frames=args.n_poses,
                               base=args.base, generator=torch.Generator().manual_seed(args.seed))
    device = place_model(model, args.device, "train_gesture_autoencoder")
    model.train()
    loader = DataLoader(dataset, batch_size, shuffle=True, seed=args.seed, fields=("vec_seq",),
                        device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    logger = KVLogger(args.save_dir)
    os.makedirs(args.save_dir, exist_ok=True)
    save_args(args.save_dir, vars(args))

    t_start = time.time()
    step, losses = 0, []
    for _ in range(args.epochs):
        for batch in loader:
            poses = batch["vec_seq"]
            _, recon = model(poses)
            loss = torch.mean((recon - poses) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if step % args.log_interval == 0:
                losses.append(loss.item())
                logger.logkv("recon_mse", losses[-1])
                logger.logkv("step", step)
                logger.logkv("elapsed_s", time.time() - t_start)
                logger.dumpkvs()
            step += 1
    logger.close()
    path = os.path.join(args.save_dir, f"gesture_ae{step:09d}.npz")
    save_autoencoder_npz(path, model)
    print(f"done at step {step}")
    return {"step": step, "losses": losses, "model": model, "path": path}


if __name__ == "__main__":
    main()
