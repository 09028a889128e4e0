"""RAG-only TED evaluation on the card: FGD, beat-align and diversity over a
guidance sweep (1.0, 1.5, 2.0) (reference: scripts/test_RAG_ted.py).

Port of the JAX package's ``scripts/eval_rag_ted.py``:

    python -m livelyspeaker_tpu_torch.scripts.eval_rag_ted --model_path rag.npz \\
        --data_dir ./datasets/ted_records \\
        --eval_model_path gesture_autoencoder_checkpoint_best.bin --fused

``--model_path`` is the portable npz (``args.json`` beside it restores the
model options) or the reference's released torch checkpoint (``.pt``,
``.pth``, ``.bin``; converted on load). FGD needs the frozen TriModal
evaluator (``--eval_model_path``, the reference's fixture, README.md:72);
without it FGD, diversity and feat_dist print as nan and the rest runs.

The run is on the card unless ``--device`` says otherwise (``--device cpu``
runs the plain versions of the kernels on the CPU); ``--fused`` sends every
denoise step through the fused TransMLP kernel. Batches come from a host
loader (the JAX index stream: ``seed=233``, a new shuffle each guidance);
only the conditioning goes to the card, and the metrics read the host
arrays. Speakers are drawn at random (``random.seed(233)``,
test_RAG_ted.py:56). Where the JAX script splits a key a batch, one
``torch.Generator`` seeded 233 drives each guidance's chain. The last line
is where the time went (``PhaseClock``).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import DataLoader, TedWindowDataset
from ..eval import EmbeddingSpaceEvaluator, ted_beat_align_batch
from ..models import RAG, RAGConfig
from ..pipeline import RAGSampler
from ..utils.config import generate_args
from .eval_common import PhaseClock, mesh_from_args

__all__ = ["main", "load_rag_params", "sampler_from_args", "to_frames", "ted_cond",
           "score_ted_batch", "ted_scores"]

GUIDANCES = (1.0, 1.5, 2.0)


def load_rag_params(path: str, args) -> Dict[str, torch.Tensor]:
    """The RAG's state_dict from the portable npz, or from a reference
    torch checkpoint (``--layers``, ``--num_emotions``)."""
    from ..utils import convert

    if path.endswith(".npz"):
        from ..utils.checkpoints import load_params_npz

        return convert.jax_params_to_state_dict(load_params_npz(path))
    if path.endswith((".pt", ".pth", ".bin")):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        return convert.rag_state_dict_from_reference(
            sd, num_layers=args.layers, num_emotions=args.num_emotions)
    raise ValueError(f"unknown checkpoint format: {path}")


def sampler_from_args(model: RAG, args, mesh=None) -> RAGSampler:
    """The eval's sampler: the respacing, solver and guidance schedule of
    ``args``, on ``args.device``, or split over ``mesh``."""
    return RAGSampler(
        model,
        steps=args.diffusion_steps,
        schedule=args.noise_schedule,
        timestep_respacing=args.timestep_respacing or None,
        method=args.sampler or (
            "ddim" if args.timestep_respacing.startswith("ddim") else "ddpm"),
        use_fused=args.fused,
        guidance_schedule=args.guidance_schedule,
        device=None if mesh is not None else args.device,
        mesh=mesh,
    )


def to_frames(sample: torch.Tensor, n_frames: int) -> np.ndarray:
    """[B, J, F, T] on any device -> host [B, T, J*F]."""
    m = sample.cpu().numpy()
    return m.transpose(0, 3, 1, 2).reshape(m.shape[0], n_frames, -1)


def ted_cond(batch, speaker_ids, device) -> Dict[str, torch.Tensor]:
    """The conditioning of a host TED batch on ``device``, with speakers
    drawn at random from ``speaker_ids`` (test_RAG_ted.py:56)."""
    b = batch["motion"].shape[0]
    vid = np.array([random.choice(speaker_ids) for _ in range(b)], np.int32)
    return {"audio": torch.from_numpy(batch["audio"]).to(device),
            "vid": torch.from_numpy(vid).to(device),
            "origin_x": torch.from_numpy(batch["motion"]).to(device)}


def score_ted_batch(gen: np.ndarray, batch, evaluator, clock):
    """One batch of the TED protocol (test_RAG_ted.py:106-123): the FGD
    embeddings of the generated and real clips, and the batch's
    ``(score_sum, n_audio_beats, n_motion_beats)``."""
    if evaluator:
        with clock("fgd"):
            evaluator.push_samples(gen, batch["vec_seq"])
    with clock("beat_align"):
        return ted_beat_align_batch(gen, batch["audio"])


def ted_scores(evaluator, clock):
    """(FGD, feat_dist, diversity) of what ``evaluator`` holds; nan without
    one."""
    with clock("fgd"):
        if evaluator:
            fgd, feat_dist = evaluator.get_scores()
            return fgd, feat_dist, evaluator.get_diversity_scores()
        return float("nan"), float("nan"), float("nan")


def main(argv: Optional[List[str]] = None) -> List[tuple]:
    """Evaluate as ``argv`` says; returns ``[(guidance, fgd, beat_align,
    diversity), ...]``."""
    args = generate_args(argv)
    random.seed(233)
    np.random.seed(233)

    dataset = TedWindowDataset(args.data_dir)
    batch_size = min(args.batch_size, max(len(dataset), 1))
    mesh = mesh_from_args(args, batch_size=batch_size)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=233)

    cfg = RAGConfig(
        njoints=args.njoints,
        nfeats=args.nfeats,
        nframes=args.n_poses,
        latent_dim=args.latent_dim,
        num_layers=args.layers,
        mlpact=args.mlpact,
        n_pre_seq=getattr(args, "n_pre_poses", 4),
        n_speakers=args.n_speakers,
        num_emotions=args.num_emotions,
        cond_mask_prob=args.cond_mask_prob,
    )
    model = RAG(cfg)
    model.load_state_dict(load_rag_params(args.model_path, args))
    sampler = sampler_from_args(model, args, mesh)
    device = sampler.device
    clock = PhaseClock(device)

    evaluator = None
    if args.eval_model_path and os.path.exists(args.eval_model_path):
        evaluator = EmbeddingSpaceEvaluator.from_torch_checkpoint(args.eval_model_path,
                                                                  device=device)

    speaker_ids = (list(dataset.speaker_model.word2index.values())
                   if dataset.speaker_model else [0])

    results = []
    for guidance in GUIDANCES:
        if evaluator:
            evaluator.reset()
        generator = torch.Generator(device=device).manual_seed(233)
        score_sum = n_beats = motion_beats = 0
        for batch in loader:
            cond = ted_cond(batch, speaker_ids, device)
            with clock("sampling"):
                gen = to_frames(sampler(cond, generator, guidance=guidance), args.n_poses)
            s, nb, mb = score_ted_batch(gen, batch, evaluator, clock)
            score_sum += s
            n_beats += nb
            motion_beats += mb
        beat_score = score_sum / max(n_beats, 1)
        fgd, feat_dist, div = ted_scores(evaluator, clock)
        print(
            f"guidance={guidance}: FGD={fgd:.4f} beat_align={beat_score:.4f} "
            f"diversity={div:.4f} feat_dist={feat_dist:.4f} "
            f"motion_beats={motion_beats}"
        )
        results.append((guidance, fgd, beat_score, div))
    for r in results:
        print(r)
    print(clock.report())
    return results


if __name__ == "__main__":
    main()
