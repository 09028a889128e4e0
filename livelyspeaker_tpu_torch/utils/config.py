"""Grouped CLI argument system with checkpoint-args restoration.

Port of ``livelyspeaker_tpu/utils/config.py``: the same option groups,
names and defaults, the ``-c/--config`` YAML (or JSON) layer, and
``apply_saved_args``. One deliberate difference: ``--device`` is the port's
device string, and its default ``None`` means the card (``--device cpu``
runs the plain versions of the kernels on the CPU); the JAX package's is a
device index.

It follows the reference's ``scripts/mdm_utils/parser_util.py``: grouped
argparse options
with the reference's defaults (diffusion_steps=1000, cosine schedule,
latent 512, 8 layers, cond_mask_prob 0.1, lambda_vel 1.0, batch 512, lr 1e-4,
epochs 1501, n_pre_poses 4 — parser_util.py:67-135, 252-274), plus
``apply_saved_args``: at generate time, model/diffusion/data args are
restored from the args.json written at train time (parser_util.py:7-39).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from ..training.checkpoints import load_args

__all__ = ["add_all_groups", "train_args", "generate_args", "apply_saved_args"]

RESTORED_GROUPS = ("dataset", "model", "diffusion")


def add_base_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("base")
    g.add_argument("--seed", type=int, default=10)
    g.add_argument("--batch_size", type=int, default=512)
    g.add_argument("--num_workers", type=int, default=0)
    g.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the plain versions of the kernels on the CPU; "
                        "the default is the card")


def add_diffusion_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("diffusion")
    g.add_argument("--noise_schedule", type=str, default="cosine",
                   choices=["linear", "cosine"])
    g.add_argument("--diffusion_steps", type=int, default=1000)
    g.add_argument("--sigma_small", action="store_true", default=True)


def add_model_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--latent_dim", type=int, default=512)
    g.add_argument("--layers", type=int, default=8)
    g.add_argument("--cond_mask_prob", type=float, default=0.1)
    g.add_argument("--lambda_vel", type=float, default=1.0)
    g.add_argument("--mlpact", type=str, default="silu")
    g.add_argument("--njoints", type=int, default=9)
    g.add_argument("--nfeats", type=int, default=3)
    g.add_argument("--num_emotions", type=int, default=0)
    g.add_argument("--n_speakers", type=int, default=1400)


def add_data_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("dataset")
    g.add_argument("--dataset", type=str, default="ted",
                   choices=["ted", "beat", "synthetic"])
    g.add_argument("--data_dir", type=str, default="./datasets/ted_records")
    g.add_argument("--n_poses", type=int, default=34)
    g.add_argument("--n_pre_poses", type=int, default=4)


def add_training_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("training")
    g.add_argument("--save_dir", type=str, default="./save/exp")
    g.add_argument("--exp", type=str, default="exp")
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--lr_anneal_steps", type=int, default=0)
    g.add_argument("--epochs", type=int, default=1501)
    g.add_argument("--log_interval", type=int, default=100)
    g.add_argument("--save_interval", type=int, default=100)
    g.add_argument("--resume_checkpoint", type=str, default="")
    g.add_argument("--overwrite", action="store_true")
    g.add_argument("--schedule_sampler", type=str, default="uniform",
                   choices=["uniform", "loss-second-moment"],
                   help="timestep sampler (resample.py:8-58)")
    g.add_argument("--ema_rate", type=float, default=0.0,
                   help="EMA decay for shadow params; 0 disables "
                        "(diffusion/nn.py:56-66). RAG trainer only; "
                        "train_sag.py / train_gesture_autoencoder.py "
                        "reject non-default values")
    g.add_argument("--ema_warmup", action="store_true",
                   help="warm the EMA decay in as min(rate, (1+t)/(10+t)) "
                        "so the shadow is useful on short runs too "
                        "(removes the r^N init weight, DESIGN.md §13). "
                        "RAG trainer only")
    g.add_argument("--fused_train", action="store_true",
                   help="run the mixer backbone through the fused CUDA "
                        "training kernels with their hand-written backward "
                        "(ops/fused_mlp_train.py; f32)")
    g.add_argument("--audio_bf16", action="store_true",
                   help="bf16 activations for the WavEncoder conv stack "
                        "(params and features stay f32; the mixer is "
                        "unaffected, models/audio_encoder.py)")
    g.add_argument("--pipeline_parallel", type=int, default=0,
                   help="GPipe stages of the JAX package's mesh; the port "
                        "trains on one card and refuses a value above 1")
    g.add_argument("--fsdp", action="store_true",
                   help="fully sharded parameters in the JAX package's "
                        "mesh; the port trains on one card and refuses it")
    g.add_argument("--device_resident", type=int, default=0,
                   help="1: stage the whole dataset in device memory once "
                        "and gather batches there by index (the host sends "
                        "a [B] index vector a step; for datasets that fit)")


def add_sampling_options(p: argparse.ArgumentParser):
    g = p.add_argument_group("sampling")
    g.add_argument("--model_path", type=str, required=True)
    g.add_argument("--guidance_param", type=float, default=1.5)
    g.add_argument("--timestep_respacing", type=str, default="ddim100")
    g.add_argument("--skip_steps", type=int, default=0)
    g.add_argument("--guidance_schedule", type=str, default=None,
                   help="per-step CFG decay over the refinement window "
                        "('const'|'linear'|'cosine'|'step:<t0>'); preserves "
                        "the SAG sketch's semantic signal at guidance>1 — "
                        "measured in scripts/measure_semantic_payoff.py "
                        "(DESIGN §18-19)")
    g.add_argument("--sag_path", type=str, default="")
    g.add_argument("--clip_path", type=str, default="")
    g.add_argument("--bpe_path", type=str, default="")
    g.add_argument("--eval_model_path", type=str, default="")
    g.add_argument("--fused", action="store_true",
                   help="sample through the fused TransMLP CUDA kernel")
    g.add_argument("--data_parallel", type=int, default=1,
                   help="devices an eval batch is split over: the first N "
                        "cards, or the CPU N times with --device cpu")
    g.add_argument("--sampler", type=str, default="",
                   choices=["", "ddpm", "ddim", "plms", "dpmpp"],
                   help="override the sampler (default: ddim when respaced, "
                        "ddpm otherwise; dpmpp enables 10-20 step sampling)")


def add_all_groups(p: argparse.ArgumentParser, training: bool):
    add_base_options(p)
    add_diffusion_options(p)
    add_model_options(p)
    add_data_options(p)
    if training:
        add_training_options(p)
    else:
        add_sampling_options(p)


def _apply_yaml_defaults(
    p: argparse.ArgumentParser, argv: Optional[Sequence[str]]
) -> Optional[Sequence[str]]:
    """BEAT-style YAML config layer (scripts_beat parser_util.py:231-238:
    ``-c configs/beat.yaml`` sets defaults, CLI flags override)."""
    import sys

    argv = list(argv if argv is not None else sys.argv[1:])
    cfg_path = None
    for flag in ("-c", "--config"):
        if flag in argv:
            i = argv.index(flag)
            cfg_path = argv[i + 1]
            del argv[i : i + 2]
    if cfg_path:
        try:
            import yaml

            with open(cfg_path) as f:
                loaded = yaml.safe_load(f) or {}
        except ImportError:
            import json

            with open(cfg_path) as f:
                loaded = json.load(f)
        known = {a.dest for a in p._actions}
        p.set_defaults(**{k: v for k, v in loaded.items() if k in known})
    return argv


def train_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    add_all_groups(p, training=True)
    argv = _apply_yaml_defaults(p, argv)
    return p.parse_args(argv)


def generate_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    add_all_groups(p, training=False)
    argv = _apply_yaml_defaults(p, argv)
    args = p.parse_args(argv)
    return apply_saved_args(args, p)


def apply_saved_args(
    args: argparse.Namespace, parser: argparse.ArgumentParser
) -> argparse.Namespace:
    """Overwrite model/diffusion/data args from the checkpoint's args.json
    (parse_and_load_from_model, parser_util.py:7-39)."""
    try:
        saved: Dict = load_args(args.model_path)
    except FileNotFoundError:
        return args
    for group in parser._action_groups:
        if group.title not in RESTORED_GROUPS:
            continue
        for action in group._group_actions:
            name = action.dest
            if name in saved:
                setattr(args, name, saved[name])
    return args
