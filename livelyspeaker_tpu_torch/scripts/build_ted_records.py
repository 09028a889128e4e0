"""Build TED training records from raw clip data, on the host.

Port of the JAX package's ``scripts/build_ted_records.py``:

    python -m livelyspeaker_tpu_torch.scripts.build_ted_records \\
        --clips_dir CLIPS --out ./datasets/ted_records [--audio_dtype int16]

Input, one of:

- ``--clips_dir DIR``: per-clip ``.npz`` files, each holding ``vid`` (str),
  ``skeletons`` [F, 10, 3], ``audio`` (16 kHz f32), ``words`` (a list of
  [word, start, end]), ``start_time`` and ``end_time``;
- ``--lmdb_dir DIR``: the original TED youtube-gesture-dataset LMDB, which
  needs the ``lmdb`` package and a pyarrow old enough to have
  ``pyarrow.deserialize``; without them it exits with the JAX script's
  message.

Output: sharded records and the speaker vocab under ``--out``, the layout
both packages' ``train_rag --dataset ted --data_dir OUT`` read. Nothing here
runs on a device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..data.ted import TedConfig, build_ted_records
from ..data.vocab import Vocab

__all__ = ["clips_from_npz_dir", "clips_from_reference_lmdb", "parse_args", "main"]


def clips_from_npz_dir(d: str) -> Iterator[Dict]:
    """The clips of ``d``'s ``.npz`` files, in name order."""
    for name in sorted(os.listdir(d)):
        if not name.endswith(".npz"):
            continue
        z = np.load(os.path.join(d, name), allow_pickle=True)
        yield {
            "vid": str(z["vid"]),
            "skeletons": z["skeletons"],
            "audio": z["audio"].astype(np.float32),
            "words": z["words"].tolist(),
            "start_time": float(z["start_time"]),
            "end_time": float(z["end_time"]),
        }


def clips_from_reference_lmdb(d: str) -> Iterator[Dict]:
    """The clips of the original TED LMDB (video -> clips), if the legacy
    toolchain is installed (the source format of the reference's
    lmdb_data_loader.py and data_preprocessor.py)."""
    try:
        import lmdb
    except ImportError as e:
        raise SystemExit(
            "reading the TED LMDB needs the `lmdb` package; use --clips_dir "
            "with exported npz clips instead"
        ) from e
    try:
        from pyarrow import deserialize  # removed in modern pyarrow
    except ImportError as e:
        raise SystemExit(
            "the TED LMDB uses legacy pyarrow serialization "
            "(pyarrow.deserialize, removed since pyarrow 2.0). Export clips "
            "to npz with an old environment, then use --clips_dir."
        ) from e

    env = lmdb.open(d, readonly=True, lock=False)
    with env.begin() as txn:
        for _, value in txn.cursor():
            video = deserialize(value)
            for clip in video["clips"]:
                yield {
                    "vid": video["vid"],
                    "skeletons": np.asarray(clip["skeletons_3d"]),
                    "audio": np.asarray(clip["audio_raw"], np.float32),
                    "words": clip["words"],
                    "start_time": float(clip["start_time"]),
                    "end_time": float(clip["end_time"]),
                }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Build TED records from raw clips.")
    p.add_argument("--clips_dir", type=str, default="")
    p.add_argument("--lmdb_dir", type=str, default="")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--n_poses", type=int, default=34)
    p.add_argument("--stride", type=int, default=10)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--disable_filtering", action="store_true")
    p.add_argument("--audio_dtype", type=str, default="float32",
                   choices=["float32", "int16"],
                   help="int16 = PCM16 records: lossless against 16-bit source "
                        "WAVs, about 2.3x the loader's throughput (decoded on the device)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Tuple[int, Vocab]:
    """Build the records ``argv`` asks for; returns (windows, speaker vocab)."""
    args = parse_args(argv)
    if bool(args.clips_dir) == bool(args.lmdb_dir):
        raise SystemExit("give exactly one of --clips_dir / --lmdb_dir")
    clips = (
        clips_from_npz_dir(args.clips_dir)
        if args.clips_dir
        else clips_from_reference_lmdb(args.lmdb_dir)
    )
    cfg = TedConfig(
        n_poses=args.n_poses, subdivision_stride=args.stride, fps=args.fps,
        audio_dtype=args.audio_dtype,
    )
    n, vocab = build_ted_records(
        cfg, clips, args.out, disable_filtering=args.disable_filtering
    )
    print(f"wrote {n} windows, {vocab.n_words} speakers -> {args.out}")
    return n, vocab


if __name__ == "__main__":
    main()
