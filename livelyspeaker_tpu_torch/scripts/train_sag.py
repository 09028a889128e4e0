"""Train the SAG (MotionCLIP) semantic generator from TED records, on the
card.

Port of the JAX package's ``scripts/train_sag.py``:

    python -m livelyspeaker_tpu_torch.scripts.train_sag --dataset synthetic \\
        --epochs 3 --batch_size 64 --clip_layers 2 --save_dir /tmp/sag_synth

The loss of a batch is recon MSE + velocity MSE + lam_cos * (1 - cos(z,
clip_text_z)), with the CLIP text tower frozen (random at ``--clip_layers``
without ``--clip_path``), stepped with Adam. Every ``--eval_interval``
epochs the FGD hook autoencodes the dataset, embeds decoded and real clips
with the frozen evaluator (random without ``--eval_model_path``), logs the
FGD and keeps the best parameters as ``sag_best.npz``; ``sag{step:09d}.npz``
is written every ``--save_interval`` epochs. Both are the JAX package's flat
npz, which the JAX package and the port's ``scripts/serve.py --sag_path``
read.

Where the port differs: the run is on the card unless ``--device`` names
another device (``--device cpu`` for the CPU; a list of devices raises: the
JAX script has no mesh either); dropout draws from torch's
default generator, seeded from ``--seed``, where the JAX script splits
``jax.random`` keys; ``HashTokenizer``'s ids are salted per process, as in
the JAX package. The KV log also records ``elapsed_s`` at each line.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data import CLIPTokenizer, DataLoader, HashTokenizer, TedWindowDataset
from ..models import SAG, CLIPTextConfig, CLIPTextEncoder, sag_losses
from ..training.checkpoints import save_args, save_params_npz
from ..training.logging import KVLogger
from ..utils.config import add_all_groups
from ..utils.device import place_model
from .train_rag import refuse_device_list, refuse_mesh_options, synthetic_records_dir

__all__ = ["main", "parse_args", "make_sag_train_step"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    add_all_groups(p, training=True)
    g = p.add_argument_group("sag")
    g.add_argument("--lam_cos_loss", type=float, default=1.0)
    g.add_argument("--clip_path", type=str, default="")
    g.add_argument("--bpe_path", type=str, default="")
    g.add_argument("--clip_layers", type=int, default=12,
                   help="text-tower depth; lower for smoke runs")
    g.add_argument("--eval_model_path", type=str, default="",
                   help="frozen gesture-autoencoder checkpoint for the FGD hook "
                        "(random evaluator if absent)")
    g.add_argument("--eval_interval", type=int, default=100,
                   help="epochs between in-training FGD evaluations with the frozen "
                        "evaluator; 0 disables")
    args = p.parse_args(argv)
    if args.ema_rate or args.ema_warmup:
        p.error("--ema_rate/--ema_warmup apply to the RAG trainer only; "
                "this loop keeps no EMA shadow")
    if args.pipeline_parallel:
        p.error("--pipeline_parallel applies to the RAG trainer only")
    return args


def make_sag_train_step(model: SAG, opt: torch.optim.Optimizer,
                        lam_cos: float) -> Callable[[torch.Tensor, torch.Tensor],
                                                    Dict[str, torch.Tensor]]:
    """``step(motion, text_feats) -> losses``: one Adam step of ``model`` on
    ``sag_losses`` of its autoencoding of ``motion`` [B, J, F, T] against
    the frozen text features [B, D]. Dropout follows the model's mode
    (``train()`` on, ``eval()`` off). The gradients stay in ``.grad``; the
    losses come back detached, on the device."""

    def step(motion: torch.Tensor, text_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = model(motion)
        losses = sag_losses(motion, out["output"], out["z"], text_feats, lam_cos=lam_cos)
        opt.zero_grad(set_to_none=True)
        losses["sum"].backward()
        opt.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def _clip_tower(args, device) -> CLIPTextEncoder:
    """The frozen text tower: OpenAI's weights with ``--clip_path``, else
    seeded random at ``--clip_layers``, its embedding at the SAG's width."""
    from ..utils.convert import clip_text_state_dict_from_openai

    # real OpenAI weights fix the text embedding at 512 (the reference SAG's
    # latent); a random tower follows --latent_dim
    clip = CLIPTextEncoder(CLIPTextConfig(
        layers=args.clip_layers, embed_dim=512 if args.clip_path else args.latent_dim),
        generator=torch.Generator().manual_seed(0))
    if args.clip_path:
        sd = torch.load(args.clip_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        clip.load_state_dict(clip_text_state_dict_from_openai(sd, layers=args.clip_layers))
        print(f"loaded CLIP text tower from {args.clip_path}")
    else:
        print("WARNING: random frozen CLIP text tower (no --clip_path)")
    return clip.to(device).eval().requires_grad_(False)


def _evaluator(args, device):
    """The frozen FGD evaluator: the reference's checkpoint with
    ``--eval_model_path``, else seeded random."""
    from ..eval import EmbeddingSpaceEvaluator
    from ..models.embedding_net import TedEmbeddingEncoder

    if args.eval_model_path and os.path.exists(args.eval_model_path):
        return EmbeddingSpaceEvaluator.from_torch_checkpoint(args.eval_model_path, device=device)
    pose_dim = args.njoints * args.nfeats
    enc = TedEmbeddingEncoder(pose_dim=pose_dim, n_frames=args.n_poses,
                              generator=torch.Generator().manual_seed(1))
    print("WARNING: random frozen FGD evaluator (no --eval_model_path)")
    return EmbeddingSpaceEvaluator(enc.state_dict(), pose_dim=pose_dim,
                                   n_frames=args.n_poses, device=device)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train as ``argv`` says; returns ``{"step", "best_fgd", "model"}``."""
    args = parse_args(argv)
    refuse_mesh_options(args)
    refuse_device_list(args, "the SAG")
    torch.manual_seed(args.seed)  # the dropout masks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dataset == "synthetic":
        args.data_dir = synthetic_records_dir()

    dataset = TedWindowDataset(args.data_dir)
    batch_size = min(args.batch_size, max(len(dataset) // 2, 1))
    model = SAG(njoints=args.njoints, nfeats=args.nfeats, latent_dim=args.latent_dim,
                n_pre_poses=args.n_pre_poses,
                generator=torch.Generator().manual_seed(args.seed))
    device = place_model(model, args.device, "train_sag")
    model.train()
    print(f"Total params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    fields = ("motion", "sentence")
    loader = DataLoader(dataset, batch_size, shuffle=True, seed=args.seed, fields=fields,
                        device=device)
    tokenizer = CLIPTokenizer(args.bpe_path) if args.bpe_path else HashTokenizer()
    clip = _clip_tower(args, device)

    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    train_step = make_sag_train_step(model, opt, args.lam_cos_loss)
    logger = KVLogger(args.save_dir)
    os.makedirs(args.save_dir, exist_ok=True)
    save_args(args.save_dir, vars(args))

    evaluator = _evaluator(args, device) if args.eval_interval else None
    eval_loader = DataLoader(dataset, batch_size, shuffle=False, seed=args.seed,
                             fields=("motion",), device=device)

    @torch.no_grad()
    def eval_fgd() -> float:
        model.eval()
        evaluator.reset()
        to_eval = lambda m: m.permute(0, 3, 1, 2).reshape(m.shape[0], args.n_poses, -1)
        for batch in eval_loader:
            real = batch["motion"]  # [B, J, F, T]
            evaluator.push_samples(to_eval(model(real)["output"]), to_eval(real))
        model.train()
        fgd, _ = evaluator.get_scores()
        return float(fgd)

    def save(name: str) -> None:
        save_params_npz(os.path.join(args.save_dir, name), model.state_dict(), model)

    t_start = time.time()
    step = 0
    best_fgd = float("inf")
    for epoch in range(args.epochs):
        for batch in loader:
            with torch.no_grad():
                tokens = torch.from_numpy(tokenizer(batch["sentence"])).to(device)
                text_feats = clip(tokens)
            losses = train_step(batch["motion"], text_feats)
            if step % args.log_interval == 0:
                host = torch.stack(list(losses.values())).tolist()
                for k, v in zip(losses, host):
                    logger.logkv_mean(k, v)
                logger.logkv("step", step)
                logger.logkv("elapsed_s", time.time() - t_start)
                logger.dumpkvs()
            step += 1
        if evaluator is not None and (epoch % args.eval_interval == 0
                                      or epoch == args.epochs - 1):
            fgd = eval_fgd()
            logger.logkv("eval_fgd", fgd)
            logger.logkv("step", step)
            logger.logkv("elapsed_s", time.time() - t_start)
            logger.dumpkvs()
            if fgd < best_fgd:
                best_fgd = fgd
                save("sag_best.npz")
                print(f"epoch {epoch}: new best FGD {fgd:.6g} -> sag_best.npz")
        if epoch % args.save_interval == 0 or epoch == args.epochs - 1:
            save(f"sag{step:09d}.npz")
    logger.close()
    print(f"done at step {step}; best FGD "
          f"{best_fgd if best_fgd < float('inf') else 'n/a'}")
    return {"step": step, "best_fgd": best_fgd, "model": model}


if __name__ == "__main__":
    main()
