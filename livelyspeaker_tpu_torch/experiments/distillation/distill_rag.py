"""Progressively distill a trained RAG denoiser to fewer sampling steps, on
the card.

Port of the JAX package's ``experiments/distillation/distill_rag.py``. Each
round trains a student (a copy of the teacher) so that ONE of its DDIM
steps matches TWO of the teacher's, then halves the sampling grid and makes
the student the next teacher (Salimans and Ho 2022). From the eval grid
(ddim100) two rounds give a 25-step sampler.

    python -m livelyspeaker_tpu_torch.experiments.distillation.distill_rag \\
        --model_path save/RAG/model000100000.npz --data_dir datasets/ted_records \\
        --save_dir save/RAG_distilled --start_grid 100 --rounds 2 \\
        --steps_per_round 2000 [--device cpu]

``--model_path`` is a ``train_rag`` checkpoint (the portable npz, with its
``args.json``); each round writes ``model_distilled_x{k}.npz`` in the same
layout and the last ``args.json`` names the student's grid. The optimizer
is ``torch.optim.AdamW`` with ``optax.adamw``'s defaults (weight decay
1e-4); one ``torch.Generator`` seeded ``--seed`` draws every step, where the
JAX loop splits a key a step. The last line is a JSON summary, which
:func:`main` returns.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List, Optional

import torch

from ...diffusion import DiffusionSchedule
from ...models import RAG, RAGConfig
from ...training.checkpoints import load_args, save_args, save_params_npz
from ...utils import convert
from ...utils.checkpoints import load_params_npz
from ...utils.device import place_model
from .distill import make_distill_step

__all__ = ["main", "model_from_checkpoint", "OPTAX_ADAMW_WEIGHT_DECAY"]

OPTAX_ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def model_from_checkpoint(path: str) -> tuple:
    """(the RAG of a ``train_rag`` checkpoint with its weights, its saved
    args); the JAX script's defaults where there is no ``args.json``."""
    try:
        saved = load_args(path)
    except FileNotFoundError:
        saved = {}
    cfg = RAGConfig(
        njoints=saved.get("njoints", 9),
        nfeats=saved.get("nfeats", 3),
        nframes=saved.get("n_poses", 34),
        latent_dim=saved.get("latent_dim", 512),
        num_layers=saved.get("layers", 8),
        mlpact=saved.get("mlpact", "silu"),
        n_speakers=saved.get("n_speakers", 1400),
        num_emotions=saved.get("num_emotions", 0),
    )
    model = RAG(cfg)
    model.load_state_dict(convert.jax_params_to_state_dict(load_params_npz(path)))
    return model, saved


def main(argv: Optional[List[str]] = None) -> Dict:
    """Distill as ``argv`` says; returns the printed summary."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--dataset", choices=["ted", "beat"], default="ted")
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--start_grid", type=int, default=100,
                   help="the teacher's sampling grid (100: the reference's ddim100 "
                        "eval grid)")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps_per_round", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' distills on the CPU; the default is the card")
    args = p.parse_args(argv)

    teacher, saved = model_from_checkpoint(args.model_path)
    device = place_model(teacher, args.device, "distill_rag")
    from ...data import DataLoader

    if args.dataset == "beat":
        from ...data.beat import BeatWindowDataset

        dataset = BeatWindowDataset(args.data_dir)
        fields = ("motion", "audio", "vid", "emo")
    else:
        from ...data import TedWindowDataset

        dataset = TedWindowDataset(args.data_dir)
        fields = ("motion", "audio", "vid")
    loader = DataLoader(dataset, batch_size=min(args.batch_size, max(len(dataset), 1)),
                        shuffle=True, seed=args.seed, fields=fields, device=device)

    os.makedirs(args.save_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    grid, students = args.start_grid, []
    for rnd in range(args.rounds):
        sched = DiffusionSchedule.create(steps=args.diffusion_steps,
                                         schedule=args.noise_schedule,
                                         timestep_respacing=str(grid)).to(device)
        student = copy.deepcopy(teacher).requires_grad_(True)
        opt = torch.optim.AdamW(student.parameters(), lr=args.lr,
                                weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)
        step = make_distill_step(student, sched, opt, teacher)
        done = 0
        while done < args.steps_per_round:
            for batch in loader:
                if done >= args.steps_per_round:
                    break
                m = step(batch, generator)
                done += 1
                if done % args.log_interval == 0:
                    print(f"round {rnd} grid {grid} step {done}: loss={float(m['loss']):.5f} "
                          f"grad={float(m['grad_norm']):.3f}")
        grid //= 2
        teacher = student
        out = os.path.join(args.save_dir, f"model_distilled_x{args.start_grid // grid}.npz")
        save_params_npz(out, student.state_dict(), student)
        students.append(out)
        print(f"round {rnd} done -> {out} (sample with --timestep_respacing ddim{grid})")
    save_args(args.save_dir, {**saved, "timestep_respacing": f"ddim{grid}"})
    summary = {"students": students, "timestep_respacing": f"ddim{grid}",
               "steps_per_round": args.steps_per_round}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
