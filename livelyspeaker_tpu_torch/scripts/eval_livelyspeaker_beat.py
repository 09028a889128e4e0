"""The LivelySpeaker composition on BEAT, on the card: the SAG's sketch of
each window's sentence, refined by the RAG (skip 80), scored by FID, SRGR,
onset alignment and diversity over guidance (1.0, 1.5) (reference:
scripts_beat/test_LivelySpeaker_beat.py:77-177, skip 80 at :232, the sweep
at :234-237).

Port of the JAX package's ``scripts/eval_livelyspeaker_beat.py``:

    python -m livelyspeaker_tpu_torch.scripts.eval_livelyspeaker_beat \\
        --model_path rag_beat.npz --sag_path sag_beat.npz \\
        --data_dir ./datasets/beat_records --eval_model_path best_rec_200.bin --fused

FID needs the frozen BEAT autoencoder (``--eval_model_path``); without it
FID and diversity print as nan and the rest runs. The loaders, the device
and the time line as in ``eval_rag_beat``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data import DataLoader
from ..data.beat import BeatWindowDataset
from ..eval import SRGR, Alignment
from ..models import RAG, RAGConfig
from ..utils.config import generate_args
from .eval_common import PhaseClock, build_pipeline, load_beat_embedder, mesh_from_args
from .eval_rag_beat import beat_cond, fid_and_diversity, score_beat_batch
from .eval_rag_ted import load_rag_params

__all__ = ["main", "run_sweep", "load_beat_embedder"]


def run_sweep(dataset, loader, pipe, embed, n_joints: int, n_frames: int,
              guidances: Sequence[float] = (1.0, 1.5), clock: Optional[PhaseClock] = None):
    """The infer_from_testloader protocol (test_LivelySpeaker_beat.py:77-177)
    through ``pipe`` (the composition, on its device) and the FID embedder
    ``embed`` (or None): returns ``[(guidance, fid, align, diversity,
    srgr), ...]``. ``clock`` adds up where the time goes."""
    clock = clock or PhaseClock(pipe.device)
    aligner = Alignment(0.3, 2)  # BaseTrainer.__init__ :64
    results = []
    for guidance in guidances:
        generator = torch.Generator(device=pipe.device).manual_seed(233)
        lat_out, lat_ori = [], []
        align_sum, total = 0.0, 0
        srgr = SRGR(threshold=4.0, joints=n_joints)  # :65
        for batch in loader:
            b = batch["motion"].shape[0]
            cond = beat_cond(batch, pipe.device)
            sentences = batch.get("sentence") or ["a person is gesturing"] * b
            with clock("sampling"):
                sample = pipe(sentences, cond, generator, guidance=guidance).cpu()
            # rot6d -> euler degrees for SRGR and the alignment (:145-165)
            for score in score_beat_batch(sample, batch, embed, n_joints, n_frames, srgr,
                                          aligner, lat_out, lat_ori, clock):
                align_sum += score
            total += b
        fid, div = fid_and_diversity(lat_out, lat_ori, clock)
        align, srgr_avg = align_sum / max(total, 1), srgr.avg()
        results.append((guidance, fid, align, div, srgr_avg))
        print(
            f"skip={pipe.skip_timesteps} guidance={guidance}: FID={fid:.4f} "
            f"align={align:.4f} SRGR={srgr_avg:.4f} diversity={div:.4f}"
        )
    return results


def main(argv: Optional[List[str]] = None) -> List[tuple]:
    """Evaluate as ``argv`` says; returns :func:`run_sweep`'s list."""
    args = generate_args(argv)
    np.random.seed(233)

    dataset = BeatWindowDataset(args.data_dir)
    batch_size = min(args.batch_size, max(len(dataset), 1))
    mesh_from_args(args, batch_size=batch_size)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=233)

    cfg = RAGConfig.beat(
        njoints=dataset.cfg.njoints,
        latent_dim=args.latent_dim,
        num_layers=args.layers,
        mlpact=args.mlpact,
        n_speakers=max(args.n_speakers, 30),
        cond_mask_prob=args.cond_mask_prob,
    )
    model = RAG(cfg)
    args.num_emotions = 8
    args.njoints = cfg.njoints
    args.nfeats = cfg.nfeats
    model.load_state_dict(load_rag_params(args.model_path, args))

    pipe = build_pipeline(args, model, cfg.njoints, cfg.nfeats)
    clock = PhaseClock(pipe.device)
    embed = load_beat_embedder(args)
    results = run_sweep(dataset, loader, pipe, embed, cfg.njoints, cfg.nframes, clock=clock)
    for item in results:
        print(item)
    print(clock.report())
    return results


if __name__ == "__main__":
    main()
