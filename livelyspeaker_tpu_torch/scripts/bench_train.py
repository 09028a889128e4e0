"""Training-step throughput benchmark (the TED RAG configuration).

Port of the JAX package's ``scripts/bench_train.py``. It times the whole
train step (loss, backward, AdamW, the non-finite guard) as ``TrainLoop``
runs it: ``--steps`` steps one after another, then one
``torch.cuda.synchronize()`` and the loss read before the clock stops. The
first step (the kernels' build, cuDNN's plans) is timed apart as
``compile_s``.

Prints one JSON line per dtype:
    {"metric": "ted_rag_train_step_ms", "value": ..., "unit": "ms",
     "batch": 512, "compute_dtype": "...", "clips_per_sec": ...,
     "tflops": ..., "pct_f32_peak": ...}

``tflops`` is the step's matmul work (``train_step_matmul_flops``) over its
time, and ``pct_f32_peak`` its share of the H100's f32 peak outside the
tensor cores (67 TFLOP/s; TF32 stays off). ``--loaders`` adds the step fed
by the streaming ``DataLoader`` and by the ``DeviceDataLoader`` over
synthetic TED records.

    python -m livelyspeaker_tpu_torch.scripts.bench_train --dtypes float32 --fused_train
    python -m livelyspeaker_tpu_torch.scripts.bench_train --dtypes bfloat16 --batch 512 --steps 30

It runs on the card unless ``--device`` says otherwise (``--device cpu`` runs
the plain versions on the CPU). With ``--fused_train`` the mixer backbone
runs the fused training kernels; under bfloat16 they compute in f32 on the
bf16 values and return bf16, as the JAX kernel does.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import RAG, RAGConfig, audio_samples_for_frames
from ..utils.device import place_model

__all__ = ["main", "bench_dtype", "bench_loaders", "train_step_matmul_flops",
           "wav_encoder_flops", "denoiser_matmul_flops", "F32_PEAK_FLOPS"]

F32_PEAK_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)


def wav_encoder_flops(n_samples: int, batch: int) -> float:
    """Matmul-equivalent FLOPs of the WavEncoder conv stack: 2 * L_out * k *
    c_in * c_out a conv."""
    total = 0.0
    length = n_samples
    for cin, cout, k, s, pad in ((1, 32, 15, 5, 1600), (32, 64, 15, 6, 0),
                                 (64, 128, 15, 6, 0), (128, 256, 15, 6, 0)):
        length = (length + 2 * pad - k) // s + 1
        total += 2.0 * length * k * cin * cout
    return total * batch


def denoiser_matmul_flops(cfg: RAGConfig, batch: int) -> float:
    """Matmul FLOPs of one denoiser forward at ``batch`` (the audio frontend,
    the LayerNorms and the activations left out)."""
    t, s, d, nif = cfg.nframes, cfg.seq_len, cfg.latent_dim, cfg.input_feats
    in_feats = 2 * nif + 1 + 256
    return (2.0 * batch * t * in_feats * d  # input_mapping
            + 2.0 * batch * 256 * d * 2  # speaker mu/logvar heads
            + 2.0 * batch * d * d * 2  # timestep-embed MLP
            + cfg.num_layers * (2.0 * batch * s * s * d + 2.0 * batch * s * d * d)
            + 2.0 * batch * t * d * nif)  # pose_final


def train_step_matmul_flops(cfg: RAGConfig, batch: int) -> float:
    """One training step: the forward at ``batch`` (with the WavEncoder) and
    a backward of twice its work."""
    fwd = denoiser_matmul_flops(cfg, batch) + wav_encoder_flops(
        audio_samples_for_frames(cfg.nframes), batch)
    return 3.0 * fwd


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_parts(cfg: RAGConfig, device, compute_dtype: str = "float32"):
    """(model on its device, the step, its first state, the device)."""
    from ..diffusion import DiffusionSchedule
    from ..training import TrainConfig, init_train_state, make_optimizer, make_train_step

    model = RAG(cfg, generator=torch.Generator().manual_seed(0))
    dev = place_model(model, device, "bench_train")
    model.train()
    sched = DiffusionSchedule.create(steps=1000, schedule="cosine")
    tcfg = TrainConfig(lr=1e-4, compute_dtype=compute_dtype)
    tx = make_optimizer(tcfg)
    step_fn = make_train_step(model, sched, tx, tcfg)

    def fresh_state():
        return init_train_state(dict(model.named_parameters()), tx, cfg=tcfg,
                                num_timesteps=1000)

    return model, step_fn, fresh_state, dev


def bench_dtype(compute_dtype: str, batch: int, steps: int, latent: int, layers: int,
                fused_train: bool = False, audio_bf16: bool = False, device=None) -> dict:
    """The train step at ``batch`` on one fixed seeded batch."""
    from ..training.loop import step_generator

    cfg = RAGConfig.ted(latent_dim=latent, num_layers=layers,
                        fused_train_backbone=fused_train, audio_bf16=audio_bf16)
    _, step_fn, fresh_state, dev = _train_parts(cfg, device, compute_dtype)
    rng = np.random.default_rng(0)
    nf = cfg.nframes
    batch_dict = {
        "motion": rng.normal(size=(batch, cfg.njoints, cfg.nfeats, nf)).astype(np.float32),
        "audio": rng.normal(size=(batch, audio_samples_for_frames(nf))).astype(np.float32),
        "vid": rng.integers(0, cfg.n_speakers, size=(batch,)),
    }
    batch_dict = {k: torch.from_numpy(v).to(dev) for k, v in batch_dict.items()}
    state = fresh_state()

    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch_dict, step_generator(1, 0, dev))
    _sync(dev)
    compile_s = time.perf_counter() - t0

    # steady state: the steps back to back, one sync and the loss at the end
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step_fn(state, batch_dict, step_generator(1, i + 1, dev))
    _sync(dev)
    loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / steps
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss under {compute_dtype}")

    tflops = train_step_matmul_flops(cfg, batch) / dt / 1e12
    return {
        "metric": "ted_rag_train_step_ms",
        "value": round(dt * 1e3, 2),
        "unit": "ms",
        "batch": batch,
        "compute_dtype": compute_dtype,
        "fused_train": fused_train,
        "audio_bf16": audio_bf16,
        "clips_per_sec": round(batch / dt, 1),
        "tflops": round(tflops, 2),
        "pct_f32_peak": round(100.0 * tflops * 1e12 / F32_PEAK_FLOPS, 2),
        "compile_s": round(compile_s, 1),
        "final_loss": round(loss, 4),
    }


def synthetic_loader_records(data_dir: Optional[str] = None) -> str:
    """Synthetic TED records with PCM16 audio (40 clips of 20 s), built
    once into ``data_dir`` (a directory under the temp dir by default)."""
    from ..data.synthetic import build_synthetic_ted_records
    from ..data.ted import TedConfig

    data_dir = data_dir or os.path.join(tempfile.gettempdir(), "ls_torch_synth_bench")
    if not os.path.exists(os.path.join(data_dir, "meta.json")):
        build_synthetic_ted_records(data_dir, n_clips=40, clip_seconds=20,
                                    cfg=TedConfig(audio_dtype="int16"))
    return data_dir


def bench_loaders(batch: int, steps: int, latent: int, layers: int, device=None,
                  data_dir: Optional[str] = None) -> list:
    """The train step fed by each loader (streaming ``DataLoader`` and
    ``DeviceDataLoader``) on the synthetic record set: the data path end to
    end."""
    from ..data import DataLoader, DeviceDataLoader, TedWindowDataset
    from ..training.loop import step_generator

    dataset = TedWindowDataset(synthetic_loader_records(data_dir))
    fields = ("motion", "audio", "vid")
    batch = min(batch, len(dataset) // 2)
    cfg = RAGConfig.ted(latent_dim=latent, num_layers=layers)
    _, step_fn, fresh_state, dev = _train_parts(cfg, device)

    rows = []
    for name, loader in (
        ("streaming", DataLoader(dataset, batch_size=batch, shuffle=True, seed=7,
                                 fields=fields, device=dev)),
        ("device_resident", DeviceDataLoader(dataset, batch_size=batch, shuffle=True,
                                             seed=7, fields=fields, device=dev)),
    ):
        state = fresh_state()
        for b in loader:  # one warm step
            state, metrics = step_fn(state, b, step_generator(1, 0, dev))
            break
        _sync(dev)
        done = 0
        t0 = time.perf_counter()
        while done < steps:
            for b in loader:
                if done >= steps:
                    break
                state, metrics = step_fn(state, b, step_generator(1, done + 1, dev))
                done += 1
        _sync(dev)
        float(metrics["loss"])
        dt = (time.perf_counter() - t0) / steps
        rows.append({
            "metric": "ted_rag_train_e2e_step_ms",
            "loader": name,
            "value": round(dt * 1e3, 2),
            "unit": "ms",
            "batch": batch,
            "clips_per_sec": round(batch / dt, 1),
        })
    return rows


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Benchmark as ``argv`` says; returns the rows printed."""
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--dtypes", type=str, nargs="+", default=["float32", "bfloat16"])
    p.add_argument("--fused_train", action="store_true",
                   help="mixer backbone through the fused training kernels "
                        "(hand-written backward)")
    p.add_argument("--audio_bf16", action="store_true",
                   help="bf16 activations for the WavEncoder conv stack "
                        "(params and features stay f32)")
    p.add_argument("--loaders", action="store_true",
                   help="also measure the step fed by the streaming and the "
                        "device-resident loaders")
    p.add_argument("--data_dir", type=str, default="",
                   help="where --loaders builds (or finds) its synthetic records")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the plain versions on the CPU; the default is the card")
    args = p.parse_args(argv)

    rows = []
    for dt in args.dtypes:
        rows.append(bench_dtype(dt, args.batch, args.steps, args.latent_dim, args.layers,
                                fused_train=args.fused_train, audio_bf16=args.audio_bf16,
                                device=args.device))
        print(json.dumps(rows[-1]))
    if args.loaders:
        for r in bench_loaders(args.batch, args.steps, args.latent_dim, args.layers,
                               device=args.device, data_dir=args.data_dir or None):
            rows.append(r)
            print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
