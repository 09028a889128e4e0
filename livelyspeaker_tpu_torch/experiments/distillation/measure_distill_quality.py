"""Quality against steps: the teacher, DPM-Solver++ and distilled students,
on the card.

Port of the JAX package's
``experiments/distillation/measure_distill_quality.py``: a self-contained
measurement on the synthetic TED fixture. It trains a small RAG, distills
it progressively, then scores every sampler variant's generations against
the real windows with a frozen embedder, one JSON line a row.

    python -m livelyspeaker_tpu_torch.experiments.distillation.measure_distill_quality \\
        --train_steps 400 --distill_steps 800 --rounds 2 [--device cpu]

The FGD scale depends on the fixed, seeded embedder
(``scripts/eval_common.fixture_evaluator``; the JAX script's
reference-format embedder needs the reference tree): the point of the
table is the relative cost of halving the sampler's steps with and without
distillation. The sampler is unfused, as the JAX ``RAGSampler`` defaults.
The last line gathers the rows; :func:`main` returns it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...utils.device import resolve_device
from .distill import make_distill_step
from .distill_rag import OPTAX_ADAMW_WEIGHT_DECAY

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> Dict:
    """Measure as ``argv`` says; returns ``{"rows": [...]}``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--train_steps", type=int, default=400)
    p.add_argument("--distill_steps", type=int, default=800)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--start_grid", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--latent_dim", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument("--modes", type=int, default=0,
                   help="K>0: a conditionally multimodal fixture (K sinusoid archetypes the "
                        "conditioning cannot identify), the regime where few-step DDIM "
                        "should degrade")
    p.add_argument("--n_pre_seq", type=int, default=4,
                   help="0 disables the seed-frame conditioning (RAGConfig(n_pre_seq=0) "
                        "zeroes the seed frames and the indicator bit): with --modes K the "
                        "posterior is then K-modal; 4 seed frames collapse it")
    p.add_argument("--mode_blind", action="store_true",
                   help="close the --modes fixture's other mode channels: audio pooled "
                        "orthogonally to the mode and the speaker id decorrelated "
                        "(synthetic_clips(mode_blind=True))")
    p.add_argument("--n_clips", type=int, default=0,
                   help="the fixture's clip count (default 4 * modes)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' trains and samples on the CPU; the default is the card")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "measure_distill_quality")

    from ...data import DataLoader, DeviceDataLoader, TedWindowDataset
    from ...data.synthetic import build_once, build_synthetic_ted_records
    from ...diffusion import DiffusionSchedule
    from ...models import RAG, RAGConfig
    from ...pipeline import RAGSampler
    from ...scripts.eval_common import fixture_evaluator, train_rag_steps

    if args.modes:
        blind = "b" if args.mode_blind else ""
        n_clips = args.n_clips or 4 * args.modes
        data_dir = build_once(
            f"livelyspeaker_tpu_torch_synth_m{args.modes}{blind}_n{n_clips}",
            lambda d: build_synthetic_ted_records(d, n_clips=n_clips, clip_seconds=20,
                                                  modes=args.modes,
                                                  mode_blind=args.mode_blind))
    else:
        from ...scripts.train_rag import synthetic_records_dir

        data_dir = synthetic_records_dir()  # 8 clips of 20 s
    dataset = TedWindowDataset(data_dir)

    cfg = RAGConfig(latent_dim=args.latent_dim, num_layers=args.layers,
                    n_pre_seq=args.n_pre_seq)
    teacher = RAG(cfg, generator=torch.Generator().manual_seed(10)).to(device)

    # ---- the teacher
    train_rag_steps(teacher, dataset, ("motion", "audio", "vid"), args.train_steps,
                    args.batch_size, args.lr, device)

    # ---- distill
    loader = DeviceDataLoader(dataset, batch_size=min(args.batch_size, len(dataset)),
                              shuffle=True, seed=233, fields=("motion", "audio", "vid"),
                              device=device)
    students, t_model, grid = {}, teacher, args.start_grid
    generator = torch.Generator(device=device).manual_seed(10_000)
    for rnd in range(args.rounds):
        sched = DiffusionSchedule.create(steps=1000, schedule="cosine",
                                         timestep_respacing=str(grid)).to(device)
        student = copy.deepcopy(t_model).requires_grad_(True)
        opt = torch.optim.AdamW(student.parameters(), lr=1e-4,
                                weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)
        dstep = make_distill_step(student, sched, opt, t_model)
        done, t0, dm = 0, time.time(), None
        while done < args.distill_steps:
            for batch in loader:
                if done >= args.distill_steps:
                    break
                dm = dstep(batch, generator)
                done += 1
        grid //= 2
        print(f"distill round {rnd}: grid->{grid} loss={float(dm['loss']):.5f} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr)
        students[grid] = student
        t_model = student

    # ---- score every variant
    evaluator = fixture_evaluator(27, device=device)
    eval_loader = DataLoader(dataset, batch_size=min(args.batch_size, len(dataset)),
                             shuffle=False, drop_last=True, seed=233)

    def score(model, respacing, method):
        sampler = RAGSampler(model, steps=1000, timestep_respacing=respacing, method=method,
                             device=device)
        evaluator.reset()
        gen = torch.Generator(device=device).manual_seed(233)
        for batch in eval_loader:
            b = batch["motion"].shape[0]
            cond = {"audio": batch["audio"], "vid": batch["vid"], "origin_x": batch["motion"]}
            cond = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in cond.items()}
            sample = sampler(cond, gen, guidance=args.guidance).cpu().numpy()
            evaluator.push_samples(sample.transpose(0, 3, 1, 2).reshape(b, cfg.nframes, -1),
                                   batch["vec_seq"])
        fgd, fd = evaluator.get_scores()
        return float(fgd), float(fd)

    variants = [("teacher", teacher, f"ddim{args.start_grid}", "ddim"),
                ("teacher", teacher, "ddim20", "dpmpp")]
    # the teacher and its distilled student head to head at every halved grid
    for grid_k, student in students.items():
        variants.append(("teacher", teacher, f"ddim{grid_k}", "ddim"))
        variants.append((f"distilled_x{args.start_grid // grid_k}", student,
                         f"ddim{grid_k}", "ddim"))
    rows = []
    for name, model, respacing, method in variants:
        fgd, fd = score(model, respacing, method)
        rows.append({"model": name, "sampler": method, "respacing": respacing,
                     "fgd": round(fgd, 6), "feat_dist": round(fd, 6)})
        print(json.dumps(rows[-1]))
    out = {"rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
