"""The LivelySpeaker composition on TED, on the card: the SAG's sketch of
each window's sentence, refined by the RAG over the last steps of the chain,
scored by FGD, beat-align and diversity over guidance (1.0, 1.5)
(reference: scripts/test_LivelySpeaker_ted.py).

Port of the JAX package's ``scripts/eval_livelyspeaker_ted.py``:

    python -m livelyspeaker_tpu_torch.scripts.eval_livelyspeaker_ted \\
        --model_path rag.npz --sag_path sag_best.npz --data_dir ./datasets/ted_records \\
        --eval_model_path gesture_autoencoder_checkpoint_best.bin --fused

``--sag_path`` is the SAG (the portable npz or the released ``SAG.pth``;
random without it), ``--clip_path`` OpenAI's CLIP ViT-B/32 weights (a
seeded random text tower without), ``--bpe_path`` CLIP's BPE merges (the
hash tokenizer without). The refinement runs the last 100 - ``--skip_steps``
(80 by default) steps of DDIM-100 through the fused kernel with
``--fused``. Device, loader, speakers, generator and the closing time line
as in ``eval_rag_ted``.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np
import torch

from ..data import DataLoader, TedWindowDataset
from ..eval import EmbeddingSpaceEvaluator
from ..models import RAG, RAGConfig
from ..utils.config import generate_args
from .eval_common import PhaseClock, build_pipeline, mesh_from_args
from .eval_rag_ted import load_rag_params, score_ted_batch, ted_cond, ted_scores, to_frames

__all__ = ["main"]

GUIDANCES = (1.0, 1.5)


def main(argv: Optional[List[str]] = None) -> List[tuple]:
    """Evaluate as ``argv`` says; returns ``[(guidance, fgd, beat_align,
    diversity), ...]``."""
    args = generate_args(argv)
    random.seed(233)
    np.random.seed(233)

    dataset = TedWindowDataset(args.data_dir)
    batch_size = min(args.batch_size, max(len(dataset), 1))
    mesh_from_args(args, batch_size=batch_size)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=233)

    cfg = RAGConfig(
        njoints=args.njoints, nfeats=args.nfeats, nframes=args.n_poses,
        latent_dim=args.latent_dim, num_layers=args.layers, mlpact=args.mlpact,
        n_speakers=args.n_speakers, num_emotions=args.num_emotions,
        cond_mask_prob=args.cond_mask_prob,
    )
    rag = RAG(cfg)
    rag.load_state_dict(load_rag_params(args.model_path, args))
    pipe = build_pipeline(args, rag, args.njoints, args.nfeats)
    device = pipe.device
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
                gen = to_frames(pipe(batch["sentence"], cond, generator, guidance=guidance),
                                args.n_poses)
            s, nb, mb = score_ted_batch(gen, batch, evaluator, clock)
            score_sum += s
            n_beats += nb
            motion_beats += mb
        beat_score = score_sum / max(n_beats, 1)
        fgd, _, div = ted_scores(evaluator, clock)
        print(f"skip={pipe.skip_timesteps} guidance={guidance}: FGD={fgd:.4f} "
              f"beat_align={beat_score:.4f} diversity={div:.4f}")
        results.append((guidance, fgd, beat_score, div))
    print(clock.report())
    return results


if __name__ == "__main__":
    main()
