"""The semantic-payoff study: does the SAG -> RAG composition help? On the
card.

Port of the JAX package's ``scripts/measure_semantic_payoff.py``. The
reference's defining claim is that the SAG text sketch with a skip-80 RAG
refinement improves on the RAG alone (test_LivelySpeaker_ted.py:102-113,
212-221 sweep exactly this). This measures its semantic value on a fixture
where the text is the only signal that names the mode
(``data/synthetic.py: build_semantic_ted_records``: the seed frames and the
audio are mode-blind by construction; the sentence template names the
archetype).

1. train a RAG (latent 512, 8 blocks) on the fixture;
2. train a SAG (512-d MotionCLIP) against a frozen random CLIP text tower
   (distinct sentences give distinct frozen embeddings; the released
   weights are not here, the mechanism is the same);
3. on a test split of another seed, generate RAG-only at DDIM-100 and as
   the SAG sketch plus a skip-80 refinement, at guidance 1.0 and 1.5 each;
4. score mode recall (a nearest-centroid classifier of the archetype from
   the training windows, frames >= 12 where the signature lives), marginal
   FGD and conditional FGD (per mode, averaged) against a frozen fixture
   embedder (``eval_common.fixture_evaluator``; the JAX script's
   reference-format embedder needs the reference tree), the sketch's own
   recall and the x_t probe at the skip boundary
   (``eval_common.xt_boundary_probe``).

The RAG alone cannot know the mode (recall about 1/K by construction); if
the composition carries the text through the refinement, its recall and
conditional FGD beat the RAG's. Both models train and sample in this one
process: ``HashTokenizer``'s ids are salted per process. The sampler is
unfused, as the JAX ``RAGSampler`` defaults. Each result prints as a JSON
line, as in the JAX script; the last line gathers them all, and
:func:`main` returns it.

    python -m livelyspeaker_tpu_torch.scripts.measure_semantic_payoff \\
        [--rag_steps 12000] [--sag_steps 2000] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .eval_common import fixture_evaluator, train_rag_steps, xt_boundary_probe

__all__ = ["main", "cached", "train_sag_steps", "centroid_classifier", "study_models",
           "add_study_args", "SIG_FROM"]

SIG_FROM = 12  # the mode signature is fully in by 15 fps frame 12


def cached(artifacts: str, name: str, module: torch.nn.Module, train_fn: Callable[[], None]):
    """Train ``module`` in place, or with ``artifacts`` load it from
    ``artifacts/{name}.npz`` where a run left it (the portable npz), and
    write it there after training."""
    from ..training.checkpoints import save_params_npz
    from ..utils import convert
    from ..utils.checkpoints import load_params_npz

    path = os.path.join(artifacts, f"{name}.npz") if artifacts else ""
    if path and os.path.exists(path):
        print(f"loading cached {name} from {path}", file=sys.stderr)
        module.load_state_dict(convert.jax_params_to_state_dict(load_params_npz(path)))
        return
    train_fn()
    if path:
        os.makedirs(artifacts, exist_ok=True)
        save_params_npz(path, module.state_dict(), module)


def train_sag_steps(sag, clip, tokenizer, train_ds, steps: int, batch_size: int, lr: float,
                    device) -> None:
    """``steps`` Adam steps of the SAG (in place) against the frozen text
    tower's features of each batch's sentences, dropout on (drawn from
    torch's default generator, seeded 3)."""
    from ..data import DataLoader
    from .train_sag import make_sag_train_step

    loader = DataLoader(train_ds, batch_size=min(batch_size, len(train_ds)), shuffle=True,
                        seed=34, fields=("motion", "sentence"))
    opt = torch.optim.Adam(sag.parameters(), lr=lr, eps=1e-8)  # optax.adam's defaults
    step = make_sag_train_step(sag, opt, lam_cos=1.0)
    torch.manual_seed(3)
    sag.train()
    done, t0, sl = 0, time.time(), None
    while done < steps:
        for batch in loader:
            if done >= steps:
                break
            with torch.no_grad():
                feats = clip(torch.from_numpy(tokenizer(list(batch["sentence"]))).to(device))
            sl = step(torch.from_numpy(batch["motion"]).to(device), feats)
            done += 1
    sag.eval()
    print(f"SAG trained: {done} steps loss={float(sl['sum']):.4f} "
          f"(cos={float(sl['clip_loss']):.4f}, {time.time() - t0:.0f}s)", file=sys.stderr)


def centroid_classifier(motion: np.ndarray, modes: np.ndarray, k: int, sig_from: int):
    """Nearest-centroid archetype classifier from windows [N, J, F, T] and
    their modes, on frames >= ``sig_from``: motions [B, J, F, T] -> [B]."""
    feats = motion[:, :, :, sig_from:].reshape(len(modes), -1)
    centroids = np.stack([feats[modes == i].mean(axis=0) for i in range(k)])

    def classify(motions):
        m = np.asarray(motions)
        f = m[:, :, :, sig_from:].reshape(m.shape[0], -1)
        return ((f[:, None] - centroids[None]) ** 2).sum(-1).argmin(axis=1)

    return classify


def study_models(args, rag_cfg, train_ds, fields, device, kld_weight, njoints=9, nfeats=3):
    """The trained RAG, the frozen text tower, the trained SAG and the
    tokenizer of both semantic-payoff studies (``--artifacts`` caches the
    two trained models)."""
    from ..data import HashTokenizer
    from ..models import RAG, SAG, CLIPTextConfig, CLIPTextEncoder
    from ..utils.device import place_model

    model = RAG(rag_cfg, generator=torch.Generator().manual_seed(10))
    place_model(model, device, "the semantic-payoff study")
    cached(args.artifacts, "rag", model, lambda: train_rag_steps(
        model, train_ds, fields, args.rag_steps, args.batch_size, args.lr, device, kld_weight))
    model.eval()
    tokenizer = HashTokenizer()
    clip = CLIPTextEncoder(CLIPTextConfig(layers=args.clip_layers, embed_dim=args.sag_latent),
                           generator=torch.Generator().manual_seed(0))
    clip = clip.to(device).eval().requires_grad_(False)
    sag = SAG(njoints=njoints, nfeats=nfeats, latent_dim=args.sag_latent,
              generator=torch.Generator().manual_seed(20)).to(device)
    cached(args.artifacts, "sag", sag, lambda: train_sag_steps(
        sag, clip, tokenizer, train_ds, args.sag_steps, args.batch_size, args.sag_lr, device))
    sag.eval()
    return model, clip, sag, tokenizer


def add_study_args(p: argparse.ArgumentParser) -> None:
    """The options both semantic-payoff studies take."""
    p.add_argument("--modes", type=int, default=4)
    p.add_argument("--train_clips", type=int, default=64)
    p.add_argument("--test_clips", type=int, default=64)
    p.add_argument("--rag_steps", type=int, default=12000,
                   help="must be past the x_t phase transition (about 7k steps at these "
                        "widths and lr: the denoiser first memorises x0 = f(cond), then "
                        "learns to read x_t; before it the composition shows no payoff, "
                        "as the refinement ignores the sketch)")
    p.add_argument("--sag_steps", type=int, default=2000)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--clip_layers", type=int, default=4)
    p.add_argument("--sag_latent", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--sag_lr", type=float, default=3e-4)
    p.add_argument("--respacing", type=str, default="ddim100")
    p.add_argument("--skip", type=int, default=80)
    p.add_argument("--samples_per_window", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--audio_pool", type=int, default=8,
                   help="shared audio streams paired orthogonally to the modes "
                        "(against memorisation; see synthetic_semantic_clips)")
    p.add_argument("--artifacts", type=str, default="",
                   help="directory to cache the trained RAG and SAG in, reused by "
                        "later runs")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' trains and samples on the CPU; the default is the card")


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the study as ``argv`` says; returns the last printed line:
    ``{"header": ..., "rows": [...]}`` (and ``"trajectory"``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_study_args(p)
    p.add_argument("--skip_sweep", type=int, nargs="*", default=[],
                   help="more skip_timesteps values to score the composed path at "
                        "(how much the refinement erodes the sketch's signal)")
    p.add_argument("--schedule_sweep", type=str, nargs="*", default=[],
                   help="guidance schedules (linear, cosine, step:100) to score the "
                        "composed path with at guidance 1.0 and 1.5")
    p.add_argument("--trajectory", action="store_true",
                   help="classify the denoiser's x0 at every refinement step of the "
                        "skip-SKIP composed path: where in the chain the sketch's signal "
                        "decays")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "measure_semantic_payoff")

    from ..data import TedWindowDataset
    from ..data.synthetic import (
        build_once,
        build_semantic_ted_records,
        semantic_mode_of_sentence,
    )
    from ..diffusion import DiffusionSchedule
    from ..eval.fgd import frechet_from_samples
    from ..models import RAGConfig
    from ..pipeline import LivelySpeakerPipeline, RAGSampler
    from ..training.loop import step_generator

    K = args.modes

    def fixture(tag, n_clips, seed):
        return TedWindowDataset(build_once(
            f"livelyspeaker_tpu_torch_sem2_{tag}_k{K}_n{n_clips}_s{seed}_p{args.audio_pool}",
            lambda d: build_semantic_ted_records(d, n_clips=n_clips, modes=K, seed=seed,
                                                 audio_pool=args.audio_pool)))

    train_ds = fixture("train", args.train_clips, 233)
    test_ds = fixture("test", args.test_clips, 777)
    print(f"fixture: train={len(train_ds)} test={len(test_ds)} windows, K={K}",
          file=sys.stderr)

    model, clip, sag, tokenizer = study_models(
        args, RAGConfig(latent_dim=args.latent_dim, num_layers=args.layers), train_ds,
        ("motion", "audio", "vid"), device, kld_weight=0.01)

    # ---- the centroid classifier from the training windows
    train_all = train_ds.batch(list(range(len(train_ds))), fields=("motion", "sentence"))
    train_modes = np.asarray([semantic_mode_of_sentence(s, K) for s in train_all["sentence"]])
    classify = centroid_classifier(np.asarray(train_all["motion"]), train_modes, K, SIG_FROM)
    test_all = test_ds.batch(list(range(len(test_ds))),
                             fields=("motion", "audio", "vid", "sentence"))
    test_modes = np.asarray([semantic_mode_of_sentence(s, K) for s in test_all["sentence"]])
    real_acc = float((classify(test_all["motion"]) == test_modes).mean())
    print(f"classifier on real test windows: {real_acc:.3f}", file=sys.stderr)

    # ---- generate and score
    evaluator = fixture_evaluator(27, device=device)
    nf = model.cfg.nframes

    def to_eval(m):
        m = np.asarray(m)
        return m.transpose(0, 3, 1, 2).reshape(m.shape[0], nf, -1)

    real_emb = evaluator.embed(to_eval(test_all["motion"]))
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
            for k in ("audio", "vid", "motion")}
    cond["origin_x"] = cond.pop("motion")
    sentences = list(test_all["sentence"])

    # the raw SAG sketch: did the SAG learn text -> archetype at all?
    sketch = pipe.semantic_sketch(sentences, cond["origin_x"])
    sketch_recall = float((classify(sketch.cpu().numpy()) == test_modes).mean())
    print(f"sketch recall: {sketch_recall:.3f}", file=sys.stderr)
    base_sched = DiffusionSchedule.create(steps=1000, schedule="cosine")
    t_boundary, x0_hat = xt_boundary_probe(pipe.rag_sampler.sched, base_sched, model,
                                           test_all["motion"], cond, args.skip)
    probe_recall = float((classify(x0_hat) == test_modes).mean())
    print(f"x0-hat recall at t={t_boundary} (x_t from real motion): {probe_recall:.3f}",
          file=sys.stderr)

    def run(path, guidance, skip=None, schedule=None):
        use_pipe = pipe_for(schedule)
        gens = []
        for s in range(args.samples_per_window):
            gen = step_generator(99, s, device)
            if path == "full":
                if skip is not None and skip != use_pipe.skip_timesteps:
                    sk = use_pipe.semantic_sketch(sentences, cond["origin_x"])
                    g = use_pipe.rag_sampler(cond, gen, guidance=guidance,
                                             skip_timesteps=skip, init_image=sk)
                else:
                    g = use_pipe(sentences, cond, gen, guidance=guidance)
            else:
                g = rag_sampler(cond, gen, guidance=guidance)
            gens.append(g.cpu().numpy())
        gen = np.concatenate(gens)  # [S*B, J, F, T]
        modes_rep = np.tile(test_modes, args.samples_per_window)
        recall = float((classify(gen) == modes_rep).mean())
        gen_emb = evaluator.embed(to_eval(gen))
        real_rep = np.tile(real_emb, (args.samples_per_window, 1))
        fgd = float(frechet_from_samples(gen_emb, real_rep))
        cond_fgds = [float(frechet_from_samples(gen_emb[modes_rep == k],
                                                real_emb[test_modes == k])) for k in range(K)]
        row = {
            "path": path,
            "guidance": guidance,
            "mode_recall": round(recall, 4),
            "fgd": round(fgd, 6),
            "cond_fgd_mean": round(float(np.mean(cond_fgds)), 6),
            "cond_fgd_per_mode": [round(v, 6) for v in cond_fgds],
        }
        if skip is not None:
            row["skip"] = skip
        if schedule is not None:
            row["guidance_schedule"] = schedule
        return row

    header = {
        "modes": K,
        "classifier_acc_on_real": round(real_acc, 4),
        "sketch_recall": round(sketch_recall, 4),
        "x0hat_recall_at_boundary": round(probe_recall, 4),
        "chance_recall": round(1.0 / K, 4),
        "n_test_windows": len(test_ds),
        "samples_per_window": args.samples_per_window,
    }
    print(json.dumps(header))
    rows = []
    for guidance in (1.0, 1.5):
        for path in ("rag", "full"):
            rows.append(run(path, guidance, skip=args.skip if path == "full" else None))
            print(json.dumps(rows[-1]))
    for skip in args.skip_sweep:
        rows.append(run("full", 1.0, skip=skip))
        print(json.dumps(rows[-1]))
    for schedule in args.schedule_sweep:
        for guidance in (1.0, 1.5):
            rows.append(run("full", guidance, skip=args.skip, schedule=schedule))
            print(json.dumps(rows[-1]))
    out = {"header": header, "rows": rows}

    if args.trajectory:
        # the per-step erosion curve: the skip-SKIP refinement once, the
        # denoiser's x0 classified at every step (step 0 the highest t)
        from ..diffusion.sampling import sample_loop
        from ..models.cfg import make_cfg_denoiser

        with torch.no_grad():
            traj = sample_loop(make_cfg_denoiser(model, cond, 1.0), pipe.rag_sampler.sched,
                               tuple(sketch.shape), step_generator(99, 0, device),
                               method="ddim", skip_timesteps=args.skip, init_image=sketch,
                               return_trajectory="pred_xstart")[1].cpu().numpy()
        out["trajectory"] = {
            "trajectory_skip": args.skip,
            "guidance": 1.0,
            "x0hat_recall_per_step": [round(float((classify(traj[s]) == test_modes).mean()), 4)
                                      for s in range(traj.shape[0])],
        }
        print(json.dumps(out["trajectory"]))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
