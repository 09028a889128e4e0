"""Train the RAG diffusion denoiser from TED or BEAT records, on the card.

Port of the JAX package's ``scripts/train_rag.py``:

    # synthetic records, built once into a temporary directory
    python -m livelyspeaker_tpu_torch.scripts.train_rag --dataset synthetic \\
        --fused_train --epochs 2 --batch_size 32 --save_dir /tmp/rag_synth

    # records built by data.ted.build_ted_records; the whole dataset staged on the
    # card and batches gathered there
    python -m livelyspeaker_tpu_torch.scripts.train_rag --dataset ted \\
        --data_dir ./datasets/ted_records --fused_train --device_resident 1

The same options, datasets, save schedule (``model{step:09d}.npz`` in the
JAX package's flat npz, ``args.json``, whole-state checkpoints) and resume
as the JAX script. ``--fused_train`` runs the mixer backbone through the
fused CUDA training kernels. The run is on the card unless ``--device``
names another device; ``--device cpu`` runs the plain versions on the CPU.

The JAX script's mesh options have no counterpart on one card and raise:
``--pipeline_parallel`` above 1, ``--fsdp``, and a ``--device`` that names
more than one device.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional

import torch

from ..data import DataLoader, DeviceDataLoader, TedWindowDataset
from ..diffusion import DiffusionSchedule
from ..models import RAG, RAGConfig
from ..training import TrainConfig
from ..training.loop import TrainLoop
from ..utils.config import train_args
from ..utils.device import place_model

__all__ = ["main", "synthetic_records_dir", "refuse_mesh_options", "TRAIN_FIELDS"]

# the record fields a training step reads
TRAIN_FIELDS = {"ted": ("motion", "audio", "vid"), "beat": ("motion", "audio", "vid", "emo")}
SYNTHETIC_DIR = "livelyspeaker_tpu_torch_synth"


def synthetic_records_dir() -> str:
    """The synthetic TED records of ``--dataset synthetic`` (8 clips of
    20 s), built once into the temporary directory. A build goes to a
    directory of its own and is renamed into place, so concurrent runs
    never read a half-written set."""
    from ..data.synthetic import build_synthetic_ted_records

    data_dir = os.path.join(tempfile.gettempdir(), SYNTHETIC_DIR)
    if not os.path.exists(os.path.join(data_dir, "meta.json")):
        print("building synthetic records...")
        tmp = tempfile.mkdtemp(prefix=SYNTHETIC_DIR + ".")
        build_synthetic_ted_records(tmp, n_clips=8, clip_seconds=20)
        try:
            os.rename(tmp, data_dir)
        except OSError:  # another run put its copy there first
            shutil.rmtree(tmp, ignore_errors=True)
    return data_dir


def refuse_mesh_options(args) -> None:
    """The JAX script's mesh options: each raises, none falls back."""
    if args.pipeline_parallel > 1:
        raise SystemExit(
            f"--pipeline_parallel {args.pipeline_parallel}: the port trains on one card; "
            "pipeline stages over a mesh are not ported")
    if args.fsdp:
        raise SystemExit("--fsdp: the port trains on one card; sharded parameters are "
                         "not ported")
    devices = [d for d in (args.device or "").replace(",", " ").split() if d]
    if len(devices) > 1:
        raise SystemExit(f"--device {args.device!r} names {len(devices)} devices: the port "
                         "trains on one card; data-parallel training is not ported")


def _dataset(args):
    """(dataset, n_speakers); sets the BEAT model options from the records."""
    if args.dataset == "beat":
        from ..data.beat import BeatWindowDataset

        # BEAT: the records' joints, rot6d, 8 emotions, at least 30 speakers
        dataset = BeatWindowDataset(args.data_dir)
        args.njoints = dataset.cfg.njoints
        args.nfeats = 6
        if args.num_emotions == 0:
            args.num_emotions = 8
        return dataset, max(args.n_speakers, 30)
    dataset = TedWindowDataset(args.data_dir)
    vocab = dataset.speaker_model.n_words if dataset.speaker_model else 0
    return dataset, max(args.n_speakers, vocab)


def main(argv: Optional[List[str]] = None) -> TrainLoop:
    """Train as ``argv`` says; returns the finished loop."""
    args = train_args(argv)
    refuse_mesh_options(args)
    if args.dataset == "synthetic":
        args.data_dir = synthetic_records_dir()
    dataset, n_speakers = _dataset(args)

    cfg = RAGConfig(
        njoints=args.njoints,
        nfeats=args.nfeats,
        nframes=args.n_poses,
        latent_dim=args.latent_dim,
        num_layers=args.layers,
        mlpact=args.mlpact,
        n_pre_seq=args.n_pre_poses,
        n_speakers=n_speakers,
        num_emotions=args.num_emotions,
        cond_mask_prob=args.cond_mask_prob,
        fused_train_backbone=bool(args.fused_train),
        audio_bf16=bool(args.audio_bf16),
    )
    model = RAG(cfg, generator=torch.Generator().manual_seed(args.seed))
    device = place_model(model, args.device, "train_rag")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total params: {n_params / 1e6:.2f}M")

    fields = TRAIN_FIELDS["beat" if args.dataset == "beat" else "ted"]
    batch_size = min(args.batch_size, max(len(dataset) // 2, 1))
    if args.device_resident:
        loader = DeviceDataLoader(dataset, batch_size, shuffle=True, seed=args.seed,
                                  fields=fields, device=device)
    else:
        loader = DataLoader(dataset, batch_size, shuffle=True, seed=args.seed,
                            fields=fields, device=device)

    sched = DiffusionSchedule.create(steps=args.diffusion_steps, schedule=args.noise_schedule)
    tcfg = TrainConfig(
        lr=args.lr,
        weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps,
        lambda_vel=args.lambda_vel,
        schedule_sampler=args.schedule_sampler,
        ema_rate=args.ema_rate,
        ema_warmup=args.ema_warmup,
        kld_weight=0.0 if args.dataset == "beat" else 0.01,
    )
    loop = TrainLoop(
        model,
        sched,
        None,
        loader,
        cfg=tcfg,
        save_dir=args.save_dir,
        num_epochs=args.epochs,
        log_interval=args.log_interval,
        save_after_epoch=600 if args.epochs > 600 else -1,
        save_every_epochs=args.save_interval,
        seed=args.seed,
        args_to_save=vars(args),
        resume=bool(args.resume_checkpoint),
        device=device,
    )
    loop.run_loop()
    print(f"done at step {loop.step}")
    return loop


if __name__ == "__main__":
    main()
