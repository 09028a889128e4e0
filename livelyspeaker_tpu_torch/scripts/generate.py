"""Generate a gesture clip from audio (and optionally a transcript) and
export it.

Port of the JAX package's ``scripts/generate.py``, the user-facing demo
path: load a trained RAG (and optionally a SAG and CLIP for the full
LivelySpeaker composition), condition on a waveform, sample, and write the
raw motion npz (``motion`` [T, J*F], ``audio``) and, for TED, a rendered
GIF or mp4.

    # RAG-only from a 16 kHz float waveform in an .npy
    python -m livelyspeaker_tpu_torch.scripts.generate --model_path rag.npz \\
        --audio my16k.npy --out /tmp/clip --fused

    # the full composition with text
    python -m livelyspeaker_tpu_torch.scripts.generate --model_path rag.npz \\
        --sag_path sag.npz --text 'we should protect the oceans' --audio my16k.npy \\
        --skip_steps 80

``--clip_path`` takes OpenAI's CLIP state dict (loaded into the port's
``CLIPTextEncoder``; a seeded random text tower without it), ``--bpe_path``
the BPE merges (the hash tokenizer without it). ``--long`` covers the whole
audio with windows chained by their seed frames. One ``torch.Generator``
seeded 0 drives the chain (the JAX script's ``PRNGKey(0)``). It runs on the
card unless ``--device`` says otherwise (``--device cpu`` runs the plain
versions on the CPU); ``--fused`` sends every denoise step through the fused
TransMLP kernel.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.ted import PROMPT, make_audio_fixed_length
from ..models import RAG, RAGConfig, audio_samples_for_frames
from ..pipeline import RAGSampler, generate_long_form
from ..utils.config import add_all_groups, apply_saved_args
from ..utils.visualize import render_ted_clip
from .eval_common import build_pipeline
from .eval_rag_ted import load_rag_params

__all__ = ["main", "run", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    add_all_groups(p, training=False)
    g = p.add_argument_group("generate")
    g.add_argument("--audio", type=str, default="",
                   help="16 kHz waveform .npy (random if omitted)")
    g.add_argument("--text", type=str, default="")
    g.add_argument("--speaker", type=int, default=0)
    g.add_argument("--emotion", type=int, default=0,
                   help="emotion id for BEAT emotion-conditioned models "
                        "(--num_emotions > 0); ignored for TED")
    g.add_argument("--out", type=str,
                   default=os.path.join(tempfile.gettempdir(), "generated_clip"))
    g.add_argument("--render", action="store_true", default=True)
    g.add_argument("--long", action="store_true",
                   help="long form: stitch windows over the whole audio through "
                        "seed-frame conditioning (pipeline.generate_long_form)")
    return apply_saved_args(p.parse_args(argv), p)


def run(args: argparse.Namespace) -> Tuple[np.ndarray, np.ndarray]:
    """Sample as ``args`` says: (motion [T, J*F], the waveform it was
    conditioned on: the whole audio with ``--long``, else the window)."""
    cfg = RAGConfig(
        njoints=args.njoints, nfeats=args.nfeats, nframes=args.n_poses,
        latent_dim=args.latent_dim, num_layers=args.layers,
        mlpact=args.mlpact, n_speakers=args.n_speakers,
        num_emotions=args.num_emotions, cond_mask_prob=args.cond_mask_prob,
    )
    model = RAG(cfg)
    model.load_state_dict(load_rag_params(args.model_path, args))

    n_samples = audio_samples_for_frames(args.n_poses)
    if args.audio:
        full_wav = np.load(args.audio).astype(np.float32).reshape(-1)
    else:
        print("no --audio given; using noise")
        full_wav = (np.random.default_rng(0).normal(size=n_samples) * 0.1).astype(np.float32)
    wav = make_audio_fixed_length(full_wav, n_samples)

    if args.sag_path:
        pipe = build_pipeline(args, model, cfg.njoints, cfg.nfeats)
        sampler, dev = pipe.rag_sampler, pipe.rag_sampler.device
    else:
        pipe = None
        sampler = RAGSampler(
            model,
            steps=args.diffusion_steps,
            timestep_respacing=args.timestep_respacing or "ddim100",
            use_fused=args.fused,
            guidance_schedule=args.guidance_schedule,
            device=args.device,
        )
        dev = sampler.device
    generator = torch.Generator(device=dev).manual_seed(0)

    if args.long:
        sentences = [PROMPT + '"' + (args.text or "hello world") + '"'] if pipe else None
        sample = generate_long_form(
            sampler, full_wav, args.speaker, generator, guidance=args.guidance_param,
            emotion=args.emotion, pipeline=pipe, sentences=sentences)[None]
    else:
        cond = {
            "audio": torch.from_numpy(wav)[None].to(dev),
            "vid": torch.tensor([args.speaker], device=dev),
            "origin_x": torch.zeros((1, cfg.njoints, cfg.nfeats, cfg.nframes), device=dev),
        }
        if cfg.num_emotions:
            cond["emo"] = torch.tensor([args.emotion], device=dev)
        if pipe is not None:
            sentence = PROMPT + '"' + (args.text or "hello world") + '"'
            sample = pipe([sentence], cond, generator, guidance=args.guidance_param)
        else:
            sample = sampler(cond, generator, guidance=args.guidance_param)
        sample = sample.cpu().numpy()

    n_frames_out = sample.shape[-1]
    motion = sample[0].reshape(-1, n_frames_out).T  # [T, J*F]
    return motion, full_wav if args.long else wav


def main(argv: Optional[List[str]] = None) -> str:
    """Generate as ``argv`` says: writes ``<out>.npz`` (and renders a TED
    clip to ``<out>.mp4``, or ``.gif`` without ffmpeg); returns the npz
    path."""
    args = parse_args(argv)
    motion, out_wav = run(args)
    path = args.out + ".npz"
    np.savez(path, motion=motion, audio=out_wav)
    print(f"wrote {path}  motion shape {motion.shape}")
    if args.render and args.njoints == 9:
        rendered = render_ted_clip(motion, args.out + ".mp4", title=args.text, audio=out_wav)
        print(f"rendered {rendered}")
    return path


if __name__ == "__main__":
    main()
