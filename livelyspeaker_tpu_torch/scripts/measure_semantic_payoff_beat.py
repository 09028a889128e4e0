"""The BEAT twin of the semantic-payoff study, scored with SRGR. On the card.

Port of the JAX package's ``scripts/measure_semantic_payoff_beat.py``. The
reference composes SAG -> RAG on BEAT as on TED
(test_LivelySpeaker_beat.py:119-130) and ships a semantic metric: SRGR,
per-frame gesture recall weighted by the per-frame semantic relevance track
(scripts_beat/utils/metric.py:27-51). The fixture
(``data/synthetic.py: build_semantic_beat_records``) makes the text the
only signal that names the mode: audio, speaker, emotion and seed frames
are mode-blind, and the ``sem`` track marks exactly the archetype frames.

1. train a BEAT RAG (latent 512, 8 blocks, rot6d 47x6, the emotion token,
   kld weight 0) on the fixture;
2. train a SAG against a frozen random CLIP-layout text tower;
3. on a test split of another seed, generate RAG-only at DDIM-100 and as
   the SAG sketch plus a skip-80 refinement at guidance 1.0 and 1.5 (the
   reference's sweep, test_LivelySpeaker_beat.py:234-237), and with each
   ``--schedule_sweep`` guidance schedule;
4. score SRGR (threshold 4.0, 47 joints, euler degrees: the BaseTrainer
   protocol, scripts_beat/train.py:65), mode recall (nearest centroid on
   rot6d frames >= ``BEAT_SEM_ONSET``), and marginal and per-mode FID with
   a frozen ``BeatEmbeddingEncoder`` of seeded weights
   (``eval_common.fixture_evaluator(beat=True)``).

Training and sampling share one process (``HashTokenizer``'s ids are
salted per process); the sampler is unfused, as the JAX ``RAGSampler``
defaults. Each result prints as a JSON line; the last line gathers them,
and :func:`main` returns it.

    python -m livelyspeaker_tpu_torch.scripts.measure_semantic_payoff_beat \\
        [--rag_steps 12000] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .eval_common import fixture_evaluator, xt_boundary_probe
from .measure_semantic_payoff import add_study_args, centroid_classifier, study_models

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the study as ``argv`` says; returns the last printed line:
    ``{"header": ..., "rows": [...]}``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_study_args(p)
    p.add_argument("--schedule_sweep", type=str, nargs="*", default=[],
                   help="guidance schedules to score the composed path with")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "measure_semantic_payoff_beat")

    from ..data.beat import BeatWindowDataset, rot6d_to_euler_deg
    from ..data.synthetic import (
        BEAT_SEM_ONSET,
        build_once,
        build_semantic_beat_records,
        semantic_mode_of_sentence_prefix,
    )
    from ..diffusion import DiffusionSchedule
    from ..eval import SRGR
    from ..eval.fgd import frechet_from_samples
    from ..models import RAGConfig
    from ..pipeline import LivelySpeakerPipeline, RAGSampler
    from ..training.loop import step_generator

    K = args.modes
    J, F, T = 47, 6, 34

    def fixture(tag, n_clips, seed):
        return BeatWindowDataset(build_once(
            f"livelyspeaker_tpu_torch_sembeat_{tag}_k{K}_n{n_clips}_s{seed}_p{args.audio_pool}",
            lambda d: build_semantic_beat_records(d, n_clips=n_clips, modes=K, seed=seed,
                                                  audio_pool=args.audio_pool)))

    train_ds = fixture("train", args.train_clips, 233)
    test_ds = fixture("test", args.test_clips, 777)
    print(f"fixture: train={len(train_ds)} test={len(test_ds)} windows, K={K}",
          file=sys.stderr)

    # the BEAT TrainLoop contract (scripts_beat/train_RAG.py): the emotion
    # token, kld weight 0
    model, clip, sag, tokenizer = study_models(
        args, RAGConfig.beat(latent_dim=args.latent_dim, num_layers=args.layers, n_speakers=30),
        train_ds, ("motion", "audio", "vid", "emo"), device, kld_weight=0.0,
        njoints=J, nfeats=F)

    train_all = train_ds.batch(list(range(len(train_ds))), fields=("motion", "sentence"))
    train_modes = np.asarray([semantic_mode_of_sentence_prefix(s, K)
                              for s in train_all["sentence"]])
    classify = centroid_classifier(np.asarray(train_all["motion"]), train_modes, K,
                                   BEAT_SEM_ONSET)
    test_all = test_ds.batch(list(range(len(test_ds))),
                             fields=("motion", "audio", "vid", "emo", "sem", "sentence"))
    test_modes = np.asarray([semantic_mode_of_sentence_prefix(s, K)
                             for s in test_all["sentence"]])
    real_acc = float((classify(test_all["motion"]) == test_modes).mean())
    print(f"classifier on real test windows: {real_acc:.3f}", file=sys.stderr)

    # a frozen random BeatEmbeddingEncoder: FID differences between runs need
    # a fixed embedding map, not trained weights
    embedder = fixture_evaluator(beat=True, n_frames=T, device=device)

    def to_eval(m):  # [B, J, F, T] -> features of [B, T, 282]
        return embedder.embed(np.asarray(m).transpose(0, 3, 1, 2).reshape(-1, T, J * F))

    def to_euler(m):  # [B, J, F, T] -> [B, T, 141] euler degrees
        m = np.asarray(m)
        return rot6d_to_euler_deg(m.transpose(0, 3, 1, 2).reshape(-1, T, J, F)).reshape(
            m.shape[0], T, -1)

    real_emb = to_eval(test_all["motion"])
    tar_euler = to_euler(test_all["motion"])
    rag_sampler = RAGSampler(model, steps=1000, timestep_respacing=args.respacing,
                             method="ddim", device=device)
    pipes = {}

    def pipe_for(schedule):
        if schedule not in pipes:
            pipes[schedule] = LivelySpeakerPipeline(
                model, sag, clip, tokenizer, steps=1000, timestep_respacing=args.respacing,
                skip_timesteps=args.skip, method="ddim", guidance_schedule=schedule,
                device=device)
        return pipes[schedule]

    pipe = pipe_for(None)
    cond = {k: torch.from_numpy(np.asarray(test_all[k])).to(device)
            for k in ("audio", "vid", "emo", "motion")}
    cond["origin_x"] = cond.pop("motion")
    sentences = list(test_all["sentence"])

    sketch = pipe.semantic_sketch(sentences, cond["origin_x"])
    sketch_recall = float((classify(sketch.cpu().numpy()) == test_modes).mean())
    print(f"sketch recall: {sketch_recall:.3f}", file=sys.stderr)
    base_sched = DiffusionSchedule.create(steps=1000, schedule="cosine")
    t_boundary, x0_hat = xt_boundary_probe(pipe.rag_sampler.sched, base_sched, model,
                                           test_all["motion"], cond, args.skip)
    probe_recall = float((classify(x0_hat) == test_modes).mean())
    print(f"x0-hat recall at t={t_boundary} (x_t from real motion): {probe_recall:.3f}",
          file=sys.stderr)

    def run(path, guidance, schedule=None):
        use_pipe = pipe_for(schedule)
        S = args.samples_per_window
        gens = []
        for s in range(S):
            gen = step_generator(99, s, device)
            g = (use_pipe(sentences, cond, gen, guidance=guidance) if path == "full"
                 else rag_sampler(cond, gen, guidance=guidance))
            gens.append(g.cpu().numpy())
        gen = np.concatenate(gens)  # [S*B, J, F, T]
        modes_rep = np.tile(test_modes, S)
        recall = float((classify(gen) == modes_rep).mean())
        # SRGR, the BaseTrainer protocol: euler degrees, threshold 4.0,
        # weighted by the per-frame semantic track (metric.py:27-51)
        srgr = SRGR(threshold=4.0, joints=J)
        srgr.run(to_euler(gen), np.tile(tar_euler, (S, 1, 1)),
                 np.tile(np.asarray(test_all["sem"]), (S, 1)))
        gen_emb = to_eval(gen)
        fid = float(frechet_from_samples(gen_emb, np.tile(real_emb, (S, 1))))
        cond_fids = [float(frechet_from_samples(gen_emb[modes_rep == k],
                                                real_emb[test_modes == k])) for k in range(K)]
        row = {
            "path": path,
            "guidance": guidance,
            "mode_recall": round(recall, 4),
            "srgr": round(srgr.avg(), 4),
            "fid": round(fid, 6),
            "cond_fid_mean": round(float(np.mean(cond_fids)), 6),
        }
        if schedule is not None:
            row["guidance_schedule"] = schedule
        if path == "full":
            row["skip"] = args.skip
        return row

    # SRGR of the target against itself: the real-data ceiling, for scale
    ceil = SRGR(threshold=4.0, joints=J)
    ceil.run(tar_euler, tar_euler, np.asarray(test_all["sem"]))
    header = {
        "modes": K,
        "classifier_acc_on_real": round(real_acc, 4),
        "sketch_recall": round(sketch_recall, 4),
        "x0hat_recall_at_boundary": round(probe_recall, 4),
        "chance_recall": round(1.0 / K, 4),
        "srgr_ceiling": round(ceil.avg(), 4),
        "n_test_windows": len(test_ds),
        "samples_per_window": args.samples_per_window,
    }
    print(json.dumps(header))
    rows = []
    for guidance in (1.0, 1.5):
        for path in ("rag", "full"):
            rows.append(run(path, guidance))
            print(json.dumps(rows[-1]))
    for schedule in args.schedule_sweep:
        for guidance in (1.0, 1.5):
            rows.append(run("full", guidance, schedule=schedule))
            print(json.dumps(rows[-1]))
    out = {"header": header, "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
