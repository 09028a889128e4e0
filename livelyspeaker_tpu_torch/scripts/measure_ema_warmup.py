"""Does ``--ema_warmup`` fix the EMA-horizon pitfall? Measured, on the card.

Port of the JAX package's ``scripts/measure_ema_warmup.py``. With plain EMA
at the guided-diffusion default rate 0.9999, a short run's shadow params
are mostly the random init (weight r^N: 0.9999^800 = 0.92), so the EMA
checkpoint is useless. The warmed-up decay min(rate, (1+t)/(10+t)) is meant
to remove exactly that weight.

The flagship TED configuration trains twice from the same seed on
synthetic records at ``--ema_rate`` (each run ``python -m
livelyspeaker_tpu_torch.scripts.train_rag`` in a process of its own,
``--fused_train`` by default), once plain and once with ``--ema_warmup``;
then FGD from the raw and the EMA params of both runs against one frozen
fixture embedder. The fix is real iff plain: fgd_ema >> fgd_raw (the
pitfall shows), warmup: fgd_ema ~= fgd_raw, and fgd_raw the same in both
(the EMA only observes the trajectory).

Prints one JSON line with the four FGDs, returned by :func:`main`.

    python -m livelyspeaker_tpu_torch.scripts.measure_ema_warmup [--epochs 400] \\
        [--out /tmp/emaw] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from .eval_common import final_npz, fixture_evaluator, fixture_fgd, run_train_rag
from ..utils.device import resolve_device

__all__ = ["main", "train"]


def train(save_dir: str, data_dir: str, a, warmup: bool) -> None:
    argv = [
        "--dataset", "ted", "--data_dir", data_dir,
        "--latent_dim", str(a.latent_dim), "--layers", str(a.layers),
        "--batch_size", str(a.batch_size), "--epochs", str(a.epochs),
        "--save_dir", save_dir, "--save_interval", "100000",
        "--log_interval", str(a.log_interval),
        "--ema_rate", str(a.ema_rate),
        "--device_resident", "1",
        "--seed", "233",
    ]
    if a.fused_train:
        argv.append("--fused_train")
    if warmup:
        argv.append("--ema_warmup")
    run_train_rag(argv, device=a.device, capture=True)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Measure as ``argv`` says; returns the printed line."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--n_clips", type=int, default=40)
    p.add_argument("--ema_rate", type=float, default=0.9999,
                   help="the reference's (guided-diffusion's) default: exactly the rate "
                        "the pitfall bites at on short runs")
    p.add_argument("--fused_train", action="store_true", default=True)
    p.add_argument("--no_fused_train", dest="fused_train", action="store_false")
    p.add_argument("--out", type=str, default="/tmp/ema_warmup_study")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' trains and scores on the CPU; the default is the card")
    a = p.parse_args(argv)
    device = resolve_device(a.device, "measure_ema_warmup")

    os.makedirs(a.out, exist_ok=True)
    data_dir = os.path.join(a.out, "records")
    if not os.path.exists(os.path.join(data_dir, "meta.json")):
        from ..data.synthetic import build_synthetic_ted_records
        from ..data.ted import TedConfig

        print(f"building {a.n_clips}-clip synthetic records...", file=sys.stderr)
        build_synthetic_ted_records(data_dir, n_clips=a.n_clips, clip_seconds=20,
                                    cfg=TedConfig(audio_dtype="int16"))

    plain_dir, warm_dir = f"{a.out}/plain", f"{a.out}/warmup"
    train(plain_dir, data_dir, a, warmup=False)
    train(warm_dir, data_dir, a, warmup=True)

    from ..data import TedWindowDataset
    from ..models import RAG, RAGConfig

    dataset = TedWindowDataset(data_dir)
    model = RAG(RAGConfig.ted(latent_dim=a.latent_dim, num_layers=a.layers))
    fixture = fixture_evaluator(27, device=device)
    out = {"epochs": a.epochs, "ema_rate": a.ema_rate}
    for name, d in (("plain", plain_dir), ("warmup", warm_dir)):
        out[f"fgd_raw_{name}"] = fixture_fgd(model, dataset, final_npz(d), fixture,
                                             device=device)
        out[f"fgd_ema_{name}"] = fixture_fgd(model, dataset, final_npz(d, prefix="model_ema"),
                                             fixture, device=device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
