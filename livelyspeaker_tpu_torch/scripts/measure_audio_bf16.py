"""Does training with the bf16 WavEncoder converge like f32? Measured, on
the card.

Port of the JAX package's ``scripts/measure_audio_bf16.py``. The flagship
TED configuration trains twice from the same seed on synthetic records
(each run ``python -m livelyspeaker_tpu_torch.scripts.train_rag`` in a
process of its own, ``--fused_train`` by default): once f32 throughout,
once with ``--audio_bf16`` (bf16 activations in the WavEncoder's conv stack
only, ``models/audio_encoder.py``). Then FGD of both checkpoints against one
frozen fixture embedder, and each run's last logged loss (the ``| loss |``
row of ``train_rag``'s key-value table). The step's speed is
``bench_train``'s to measure; this is the quality half: the flag is only
worth recommending if the bf16-trained checkpoint scores as f32's does.
``--noise_floor`` adds a third run (f32, seed 234) for the seed-to-seed
spread the difference must be read against.

Prints one JSON line, returned by :func:`main`:
``{"fgd_f32": ..., "fgd_bf16": ..., "final_loss_f32": ..., ...}``.

    python -m livelyspeaker_tpu_torch.scripts.measure_audio_bf16 [--epochs 500] \\
        [--out /tmp/abf16] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional

from .eval_common import final_npz, fixture_evaluator, fixture_fgd, run_train_rag
from ..utils.device import resolve_device

__all__ = ["main", "train", "last_loss"]


def last_loss(text: str) -> float:
    """The last mean loss of a ``train_rag`` run's key-value tables."""
    losses = re.findall(r"\|\s*loss\s*\|\s*([0-9.eE+-]+)", text)
    return float(losses[-1]) if losses else float("nan")


def train(save_dir: str, data_dir: str, a, audio_bf16: bool, seed: int = 233) -> float:
    argv = [
        "--dataset", "ted", "--data_dir", data_dir,
        "--latent_dim", str(a.latent_dim), "--layers", str(a.layers),
        "--batch_size", str(a.batch_size), "--epochs", str(a.epochs),
        "--save_dir", save_dir, "--save_interval", "100000",
        "--log_interval", str(a.log_interval),
        "--device_resident", "1",
        "--seed", str(seed),
    ]
    if a.fused_train:
        argv.append("--fused_train")
    if audio_bf16:
        argv.append("--audio_bf16")
    proc = run_train_rag(argv, device=a.device, capture=True)
    return last_loss(proc.stdout + proc.stderr)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Measure as ``argv`` says; returns the printed line."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--n_clips", type=int, default=40)
    p.add_argument("--fused_train", action="store_true", default=True)
    p.add_argument("--no_fused_train", dest="fused_train", action="store_false")
    p.add_argument("--noise_floor", action="store_true",
                   help="also train a third run (f32, seed + 1): the seed-to-seed FGD "
                        "spread the bf16 difference is read against")
    p.add_argument("--out", type=str, default="/tmp/audio_bf16_study")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' trains and scores on the CPU; the default is the card")
    a = p.parse_args(argv)
    device = resolve_device(a.device, "measure_audio_bf16")

    os.makedirs(a.out, exist_ok=True)
    data_dir = os.path.join(a.out, "records")
    if not os.path.exists(os.path.join(data_dir, "meta.json")):
        from ..data.synthetic import build_synthetic_ted_records
        from ..data.ted import TedConfig

        print(f"building {a.n_clips}-clip synthetic records...", file=sys.stderr)
        build_synthetic_ted_records(data_dir, n_clips=a.n_clips, clip_seconds=20,
                                    cfg=TedConfig(audio_dtype="int16"))

    loss_f32 = train(f"{a.out}/f32", data_dir, a, audio_bf16=False)
    loss_bf16 = train(f"{a.out}/bf16", data_dir, a, audio_bf16=True)
    loss_seed2 = (train(f"{a.out}/f32_seed2", data_dir, a, audio_bf16=False, seed=234)
                  if a.noise_floor else None)

    from ..data import TedWindowDataset
    from ..models import RAG, RAGConfig

    dataset = TedWindowDataset(data_dir)
    # the eval runs the f32 model: audio_bf16 is a training option, and the
    # checkpoint's tree is the same either way
    model = RAG(RAGConfig.ted(latent_dim=a.latent_dim, num_layers=a.layers))
    fixture = fixture_evaluator(27, device=device)

    def eval_fgd(save_dir):
        return fixture_fgd(model, dataset, final_npz(save_dir), fixture, device=device)

    fgd_f32 = eval_fgd(f"{a.out}/f32")
    fgd_bf16 = eval_fgd(f"{a.out}/bf16")
    out = {
        "epochs": a.epochs,
        "batch_size": a.batch_size,
        "fused_train": a.fused_train,
        "final_loss_f32": loss_f32,
        "final_loss_bf16": loss_bf16,
        "fgd_f32": fgd_f32,
        "fgd_bf16": fgd_bf16,
        "fgd_rel_delta": abs(fgd_bf16 - fgd_f32) / max(abs(fgd_f32), 1e-12),
    }
    if a.noise_floor:
        fgd_seed2 = eval_fgd(f"{a.out}/f32_seed2")
        out["final_loss_f32_seed2"] = loss_seed2
        out["fgd_f32_seed2"] = fgd_seed2
        out["fgd_seed_rel_delta"] = abs(fgd_seed2 - fgd_f32) / max(abs(fgd_f32), 1e-12)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
