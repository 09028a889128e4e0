"""What the eval entry points share: the SAG, CLIP and tokenizer loaders, the
two-stage pipeline, the BEAT FID embedder, the latest checkpoint of a run,
the data-parallel guard, and a clock of where an eval's time goes.

Port of the JAX package's ``scripts/eval_common.py`` (the reference repeats
this loading in each eval script: ``scripts/test_LivelySpeaker_ted.py:38-54``,
``scripts_beat/test_LivelySpeaker_beat.py:33-41``). The weights live in the
modules; every model goes to ``args.device``, which is the card unless it
says otherwise (``utils/device.py``'s rule). The JAX module's
``fixture_fgd`` and ``xt_boundary_probe`` serve its measurement studies only
and are not ported.
"""

from __future__ import annotations

import glob
import os
import sys
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["load_sag_params", "load_clip", "load_tokenizer", "build_pipeline",
           "load_beat_embedder", "mesh_from_args", "final_npz", "PhaseClock"]


def mesh_from_args(args, batch_size: Optional[int] = None):
    """The mesh of ``--data_parallel``: None at 1; above 1 the first N
    cards (``--device cpu``: the CPU N times), over which the sampler splits
    each batch. Raises where there are fewer cards, or where N does not
    divide ``batch_size``, the batch the sampler sees (``args.batch_size``
    by default), as the JAX function does."""
    from ..parallel.mesh import data_parallel_mesh

    dp = getattr(args, "data_parallel", 1)
    if dp <= 1:
        return None
    eff = batch_size if batch_size is not None else getattr(args, "batch_size", None)
    if eff and eff % dp:
        raise SystemExit(f"batch size {eff} must be a multiple of --data_parallel {dp}")
    try:
        return data_parallel_mesh(dp, args.device)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"--data_parallel {dp}: {e}") from e


def load_sag_params(path: str) -> Dict[str, torch.Tensor]:
    """The SAG's state_dict from the portable npz or the released torch
    ``.pth`` (test_LivelySpeaker_ted.py:40-47)."""
    from ..utils import convert

    if path.endswith(".npz"):
        from ..utils.checkpoints import load_params_npz

        return convert.jax_params_to_state_dict(load_params_npz(path))
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return convert.sag_state_dict_from_reference(sd)


def load_clip(args):
    """The frozen CLIP ViT-B/32 text tower (motionclip.py:96-104): OpenAI's
    weights from ``--clip_path``, else a seeded random tower that keeps the
    pipeline runnable without them."""
    from ..models import CLIPTextEncoder
    from ..utils.convert import clip_text_state_dict_from_openai

    if getattr(args, "clip_path", ""):
        clip = CLIPTextEncoder()
        sd = torch.load(args.clip_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        clip.load_state_dict(clip_text_state_dict_from_openai(sd, layers=clip.cfg.layers))
        return clip
    print("WARNING: random frozen CLIP text tower (no --clip_path)")
    return CLIPTextEncoder(generator=torch.Generator().manual_seed(1))


def load_tokenizer(args):
    from ..data import CLIPTokenizer, HashTokenizer

    return (CLIPTokenizer(args.bpe_path) if getattr(args, "bpe_path", "")
            else HashTokenizer())


def build_pipeline(args, rag, njoints: int, nfeats: int, mesh=None):
    """The two-stage composition: the SAG's sketch, q-sampled to T - skip,
    refined by ``rag`` under CFG (test_LivelySpeaker_ted.py:85-113,
    test_LivelySpeaker_beat.py:101-130), on ``args.device``, or split over
    ``mesh``."""
    from ..models import SAG
    from ..pipeline import LivelySpeakerPipeline

    sag = SAG(njoints=njoints, nfeats=nfeats, latent_dim=512,  # = CLIP's text width
              generator=torch.Generator().manual_seed(0))
    if getattr(args, "sag_path", ""):
        sag.load_state_dict(load_sag_params(args.sag_path))
    else:
        print("WARNING: random-init SAG (no --sag_path)")
    clip = load_clip(args)
    tokenizer = load_tokenizer(args)
    if (getattr(args, "guidance_param", 1.0) > 1.0
            and not getattr(args, "guidance_schedule", None)):
        # measured in the JAX package (BASELINE.md, DESIGN §18-19): at
        # guidance > 1 constant CFG erodes the sketch's text-borne signal in
        # the low-t refinement steps; the reference's own sweep hits this
        print(
            f"WARNING: composition at guidance={args.guidance_param} with "
            "constant CFG erodes the SAG sketch's semantic contribution; "
            "pass --guidance_schedule cosine to preserve it "
            "(measured: BASELINE.md 'guidance schedules')",
            file=sys.stderr,
        )
    return LivelySpeakerPipeline(
        rag, sag, clip, tokenizer,
        steps=args.diffusion_steps,
        timestep_respacing=args.timestep_respacing or "ddim100",
        skip_timesteps=args.skip_steps or 80,  # test_LivelySpeaker_beat.py:232
        guidance_schedule=getattr(args, "guidance_schedule", None),
        use_fused=getattr(args, "fused", False),
        device=None if mesh is not None else args.device,
        mesh=mesh,
    )


def load_beat_embedder(args) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """The frozen HalfEmbeddingNet FID embedder (other_tools.py:76-79) from
    ``--eval_model_path`` on ``args.device``, or None without one: a
    function of host poses [B, T, 282] to host features."""
    from ..models.embedding_net import BeatEmbeddingEncoder
    from ..utils.convert import pose_embedding_state_dict_from_torch
    from ..utils.device import place_model

    if not (args.eval_model_path and os.path.exists(args.eval_model_path)):
        return None
    ckpt = torch.load(args.eval_model_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state") or ckpt.get("state_dict") or ckpt
    enc = BeatEmbeddingEncoder()
    enc.load_state_dict(pose_embedding_state_dict_from_torch(sd))
    device = place_model(enc.eval(), args.device, "the BEAT FID embedder")

    @torch.no_grad()
    def embed(poses: np.ndarray) -> np.ndarray:
        return enc(torch.as_tensor(poses).to(device, torch.float32)).cpu().numpy()

    return embed


def final_npz(save_dir: str, prefix: str = "model") -> str:
    """The latest ``{prefix}*.npz`` of a training save_dir (``"model"``
    leaves out the ``model_ema*`` exports, ``"model_ema"`` picks them)."""
    paths = sorted(
        p for p in glob.glob(os.path.join(save_dir, f"{prefix}*.npz"))
        if "ema" not in os.path.basename(p) or prefix.endswith("ema")
    )
    if not paths:
        raise FileNotFoundError(f"no {prefix}*.npz in {save_dir}")
    return paths[-1]


class PhaseClock:
    """Host seconds an eval spends by phase (sampling, and each metric's
    scoring). A phase ends with a device synchronise, so the card's queued
    work is charged to the phase that queued it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self._start = time.perf_counter()

    @contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds[phase] = self.seconds.get(phase, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        """``seconds: wall=... sampling=... <metric>=...``: the wall since
        construction and each phase's sum, on the host clock."""
        wall = time.perf_counter() - self._start
        return "seconds: " + " ".join(
            f"{k}={v:.3f}" for k, v in [("wall", wall)] + list(self.seconds.items()))
