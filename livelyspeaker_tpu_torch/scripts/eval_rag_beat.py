"""RAG-only BEAT evaluation on the card: FID, onset alignment, SRGR and
diversity over a guidance sweep (1.0, 1.5) (reference:
scripts_beat/test_RAG_beat.py).

Port of the JAX package's ``scripts/eval_rag_beat.py``:

    python -m livelyspeaker_tpu_torch.scripts.eval_rag_beat --model_path rag_beat.npz \\
        --data_dir ./datasets/beat_records --eval_model_path best_rec_200.bin --fused

FID needs the frozen BEAT autoencoder (``--eval_model_path``,
configs/beat.yaml:11); without it FID and diversity print as nan and the
rest runs. With ``--sag_path`` every batch is a LivelySpeaker composition
(test_LivelySpeaker_beat.py:119-130); ``eval_livelyspeaker_beat`` is the
dedicated sweep. The euler angles for SRGR and the alignment come from the
port's torch ``rot6d_to_euler_deg``.

Device, loader, generator and the closing time line as in
``eval_rag_ted``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..data import DataLoader
from ..data.beat import BeatWindowDataset, rot6d_to_euler_deg
from ..eval import SRGR, Alignment
from ..eval.fgd import diversity_score, frechet_from_samples
from ..models import RAG, RAGConfig
from ..utils.config import generate_args
from .eval_common import PhaseClock, build_pipeline, load_beat_embedder, mesh_from_args
from .eval_rag_ted import load_rag_params, sampler_from_args

__all__ = ["main", "beat_cond", "score_beat_batch"]

GUIDANCES = (1.0, 1.5)
N_FRAMES = 34  # the BEAT window (test_RAG_beat.py:124-134)


def beat_cond(batch, device):
    """The conditioning tensors of a host BEAT batch, on ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in ("audio", "vid", "emo")} | {
        "origin_x": torch.from_numpy(batch["motion"]).to(device)}


def score_beat_batch(sample: torch.Tensor, batch, embed, n_joints: int, n_frames: int,
                     srgr: SRGR, aligner: Alignment, lat_out, lat_ori, clock) -> List[float]:
    """One batch of the BEAT protocol (test_RAG_beat.py:124-165): the FID
    embeddings of the generated and real rot6d into ``lat_out`` /
    ``lat_ori``, SRGR over the euler degrees, and each clip's onset
    alignment, returned in order (the caller sums them one by one, as the
    JAX script does)."""
    b = sample.shape[0]
    gen_rot6d = sample.cpu().numpy().transpose(0, 3, 1, 2)  # [B, T, J, 6]
    tar_rot6d = batch["motion"].transpose(0, 3, 1, 2)
    if embed is not None:
        with clock("fid"):
            lat_out.append(embed(gen_rot6d.reshape(b, n_frames, -1)))
            lat_ori.append(embed(tar_rot6d.reshape(b, n_frames, -1)))
    with clock("euler"):
        gen_euler = rot6d_to_euler_deg(
            gen_rot6d.reshape(b, n_frames, n_joints, 6)).reshape(b, n_frames, -1)
        tar_euler = rot6d_to_euler_deg(
            tar_rot6d.reshape(b, n_frames, n_joints, 6)).reshape(b, n_frames, -1)
    with clock("srgr"):
        srgr.run(gen_euler, tar_euler, batch["sem"])
    with clock("align"):
        return [aligner.score(batch["audio"][i], gen_euler[i], pose_fps=15)
                for i in range(b)]


def fid_and_diversity(lat_out, lat_ori, clock):
    with clock("fid"):
        if lat_out:
            return (frechet_from_samples(np.concatenate(lat_out), np.concatenate(lat_ori)),
                    diversity_score(lat_out))
        return float("nan"), float("nan")


def main(argv: Optional[List[str]] = None) -> List[tuple]:
    """Evaluate as ``argv`` says; returns ``[(guidance, fid, align,
    diversity, srgr), ...]``."""
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
    model.load_state_dict(load_rag_params(args.model_path, args))
    sampler = sampler_from_args(model, args)
    device = sampler.device
    clock = PhaseClock(device)
    embed = load_beat_embedder(args)

    pipe = build_pipeline(args, model, cfg.njoints, cfg.nfeats) if args.sag_path else None

    aligner = Alignment(0.3, 2)  # test_RAG_beat.py:43
    n_joints = dataset.cfg.njoints
    results = []
    for guidance in GUIDANCES:
        generator = torch.Generator(device=device).manual_seed(233)
        lat_out, lat_ori = [], []
        align_sum, total = 0.0, 0
        srgr = SRGR(threshold=4.0, joints=n_joints)  # test_RAG_beat.py:44
        for batch in loader:
            b = batch["motion"].shape[0]
            cond = beat_cond(batch, device)
            with clock("sampling"):
                if pipe is not None:
                    sentences = batch.get("sentence", ["a person is gesturing"] * b)
                    sample = pipe(sentences, cond, generator, guidance=guidance)
                else:
                    sample = sampler(cond, generator, guidance=guidance)
                sample = sample.cpu()
            for score in score_beat_batch(sample, batch, embed, n_joints, N_FRAMES, srgr,
                                          aligner, lat_out, lat_ori, clock):
                align_sum += score
            total += b
        fid, div = fid_and_diversity(lat_out, lat_ori, clock)
        align, srgr_avg = align_sum / total, srgr.avg()
        print(
            f"guidance={guidance}: FID={fid:.4f} align={align:.4f} "
            f"SRGR={srgr_avg:.4f} diversity={div:.4f}"
        )
        results.append((guidance, fid, align, div, srgr_avg))
    print(clock.report())
    return results


if __name__ == "__main__":
    main()
