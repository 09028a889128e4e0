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
fused CUDA training kernels.

Where it runs, as the JAX script's mesh (``scripts/train_rag.py:88-135``):
by default every local card, data-parallel when there are several
(``parallel.shard_train_step``: each card a slice of the batch, the
gradients averaged); ``--device cpu`` one CPU shard; a list such as
``--device cpu,cpu`` or ``--device cuda:0,cuda:1`` names the mesh's
devices (a device may repeat). The batch must be a multiple of the
mesh's size. ``--pipeline_parallel`` above 1 and ``--fsdp`` (with or
without ``--fused_train``) are later slices of the port and raise.
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
from ..parallel import create_mesh
from ..training.loop import TrainLoop
from ..utils.config import train_args
from ..utils.device import place_model

__all__ = ["main", "synthetic_records_dir", "refuse_mesh_options", "refuse_device_list",
           "mesh_from_devices", "TRAIN_FIELDS"]

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
    """The JAX script's mesh options that are later slices of the port:
    each raises, none falls back."""
    if args.pipeline_parallel > 1:
        raise SystemExit(
            f"--pipeline_parallel {args.pipeline_parallel}: pipeline stages over a mesh are "
            "not ported yet; the port trains data-parallel only")
    if args.fsdp:
        raise SystemExit("--fsdp: sharded parameters are not ported yet; the port trains "
                         "data-parallel over replicated parameters only")


def _device_names(args) -> List[str]:
    return [d for d in (args.device or "").replace(",", " ").split() if d]


def refuse_device_list(args, what: str) -> None:
    """The SAG and the gesture autoencoder train on one device, as in the
    JAX scripts, which have no mesh."""
    names = _device_names(args)
    if len(names) > 1:
        raise SystemExit(f"--device {args.device!r} names {len(names)} devices: the JAX "
                         f"script trains {what} on one device, and so does the port")


def mesh_from_devices(args):
    """The training mesh of ``--device``: the devices of a list; by default
    every local card when there are several; else None (one device)."""
    names = _device_names(args)
    try:
        if len(names) > 1:
            return create_mesh(devices=names)
        if not names and torch.cuda.device_count() > 1:
            return create_mesh()
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"--device {args.device!r}: {e}") from e
    return None


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
    mesh = mesh_from_devices(args)
    device = place_model(model, mesh.devices[0] if mesh is not None else args.device,
                         "train_rag")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total params: {n_params / 1e6:.2f}M")

    fields = TRAIN_FIELDS["beat" if args.dataset == "beat" else "ted"]
    batch_size = min(args.batch_size, max(len(dataset) // 2, 1))
    if mesh is not None and batch_size % mesh.size:
        raise SystemExit(f"batch size {batch_size} must be a multiple of the {mesh.size} "
                         "devices of the mesh")
    place = dict(device=None, mesh=mesh) if mesh is not None else dict(device=device)
    if args.device_resident:
        loader = DeviceDataLoader(dataset, batch_size, shuffle=True, seed=args.seed,
                                  fields=fields, **place)
    else:
        loader = DataLoader(dataset, batch_size, shuffle=True, seed=args.seed,
                            fields=fields, **place)

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
        **place,
    )
    loop.run_loop()
    print(f"done at step {loop.step}")
    return loop


if __name__ == "__main__":
    main()
