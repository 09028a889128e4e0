"""Build BEAT records from the raw BEAT release, on the host: one command
in place of the reference's three-stage preprocessing chain.

Port of the JAX package's ``scripts/build_beat_records.py``:

  preprocess_0.py  (120->15 fps BVH subsample, 141-d joint projection,
                    wav->16 kHz, facial 60->15 fps)
  preprocess_1.py  (official train/val/test split with 30 s / 300 s a/b cuts)
  process_cache.py (euler -> rot6d aux)
  beat.py cache_generation (per-frame word/emotion/semantic tracks)

Raw layout (beat_english_v0.2.0): <raw_dir>/<speaker>/<name>.{wav|npy, bvh,
TextGrid, json, txt, csv}; name like ``2_scott_0_1_1``.

    python -m livelyspeaker_tpu_torch.scripts.build_beat_records \
        --raw_dir .../beat_english_v0.2.0 --out ./datasets/beat_records \
        --split train --speakers 2 4 6 8 [--vocab VOCAB.pkl] [--audio_dtype int16]

The records and ``vocab.pkl`` are the layout both packages'
``train_rag --dataset beat --data_dir OUT`` read. Nothing here runs on a
device.

Reference: scripts_beat/data_libs/preprocess_0.py:171-267,
preprocess_1.py:239-347, scripts_beat/dataloaders/beat.py:181-328.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import wave
from typing import List, Optional

import numpy as np

from ..data.beat import (
    BeatConfig,
    beat_official_split,
    build_beat_records,
    bvh_to_joint_channels,
)
from ..data.bvh import parse_bvh
from ..data.textgrid import parse_textgrid
from ..data.vocab import Vocab

__all__ = ["load_wav_16k", "per_frame_track", "read_emo_csv", "read_sem_txt", "read_words",
           "word_ids_track", "read_facial", "iter_clips", "parse_args", "main"]


def load_wav_16k(path: str) -> np.ndarray:
    """16 kHz mono float waveform from .wav (stdlib) or .npy
    (preprocess_0.py:218 caches librosa.load(sr=16000) as npy)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32).reshape(-1)
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        a = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        a = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        a = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if ch > 1:
        a = a.reshape(-1, ch).mean(axis=1)
    if sr != 16000:
        x_new = np.arange(0, len(a), sr / 16000.0)
        a = np.interp(x_new, np.arange(len(a)), a).astype(np.float32)
    return a


def per_frame_track(intervals, values, n_frames, fps, default):
    """First-matching-interval per-frame lookup (beat.py:254-305: frame i at
    time i/fps takes the first interval with start<=t<=end, else default)."""
    out = np.full(n_frames, default)
    found = np.zeros(n_frames, bool)
    t = np.arange(n_frames) / fps
    for (s, e), v in zip(intervals, values):
        m = (~found) & (t >= s) & (t <= e)
        out[m] = v
        found |= m
    return out


def read_emo_csv(path: str, n_frames: int, fps: int) -> np.ndarray:
    """name,start,end,duration,score rows -> per-frame emotion label
    (beat.py:272-287; default 0)."""
    iv, vals = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 5:
                continue
            try:
                iv.append((float(parts[1]), float(parts[2])))
                vals.append(int(float(parts[4])))
            except ValueError:
                continue
    return per_frame_track(iv, vals, n_frames, fps, 0).astype(np.int32)


def read_sem_txt(path: str, n_frames: int, fps: int) -> np.ndarray:
    """tab-separated name,start,end,duration,score[,word] -> per-frame
    semantic score (beat.py:291-305; default 0.0)."""
    iv, vals = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 5:
                continue
            try:
                iv.append((float(parts[1]), float(parts[2])))
                vals.append(float(parts[4]))
            except ValueError:
                continue
    return per_frame_track(iv, vals, n_frames, fps, 0.0).astype(np.float32)


def read_words(path: str):
    """TextGrid tier 0 -> timed (word, start, end) triples (beat.py:252)."""
    tiers = parse_textgrid(path)
    if not tiers:
        return []
    return [(i.mark, i.xmin, i.xmax) for i in tiers[0].intervals]


def word_ids_track(words, vocab: Vocab, n_frames: int, fps: int) -> np.ndarray:
    """Per-frame word index: "" -> PAD, gap -> UNK (beat.py:254-269)."""
    iv = [(s, e) for _, s, e in words]
    vals = [
        vocab.PAD_token if w == "" else vocab.get_word_index(w)
        for w, _, _ in words
    ]
    return per_frame_track(
        iv, vals, n_frames, fps, vocab.UNK_token
    ).astype(np.int32)


def read_facial(path: str, n_frames: int, fps: int) -> np.ndarray:
    """facial52 json -> [n_frames, 52] at pose fps (preprocess_0.py:228-240
    downsample; rate inferred from frame times like beat.py:242)."""
    with open(path) as f:
        data = json.load(f)
    frames = data.get("frames", [])
    if not frames:
        return np.zeros((n_frames, 52), np.float32)
    if len(frames) > 20 and "time" in frames[10]:
        dt = (frames[20]["time"] - frames[10]["time"]) / 10.0
        src_fps = 1.0 / max(dt, 1e-6)
    else:
        src_fps = fps
    step = max(int(round(src_fps / fps)), 1)
    w = np.asarray([fr["weights"] for fr in frames[::step]], np.float32)
    if len(w) >= n_frames:
        return w[:n_frames]
    return np.pad(w, ((0, n_frames - len(w)), (0, 0)), mode="edge")


def iter_clips(args, cfg: BeatConfig, vocab: Vocab):
    for speaker in args.speakers:
        sdir = os.path.join(args.raw_dir, str(speaker))
        for wav_path in sorted(
            glob.glob(os.path.join(sdir, "*.wav"))
            + glob.glob(os.path.join(sdir, "*.npy"))
        ):
            name = os.path.basename(wav_path).rsplit(".", 1)[0]
            stem = os.path.join(sdir, name)
            bvh_path = stem + ".bvh"
            if not os.path.exists(bvh_path):
                print(f"skip {name}: no bvh", file=sys.stderr)
                continue
            euler = bvh_to_joint_channels(
                parse_bvh(bvh_path), target_fps=cfg.pose_fps
            )
            n_frames = len(euler)
            duration = n_frames / cfg.pose_fps
            ranges = beat_official_split(name, duration)[args.split]
            if not ranges:
                continue
            audio = load_wav_16k(wav_path)
            words = (
                read_words(stem + ".TextGrid")
                if os.path.exists(stem + ".TextGrid")
                else []
            )
            word_ids = word_ids_track(words, vocab, n_frames, cfg.pose_fps)
            emo = (
                read_emo_csv(stem + ".csv", n_frames, cfg.pose_fps)
                if os.path.exists(stem + ".csv")
                else np.zeros(n_frames, np.int32)
            )
            sem = (
                read_sem_txt(stem + ".txt", n_frames, cfg.pose_fps)
                if os.path.exists(stem + ".txt")
                else np.zeros(n_frames, np.float32)
            )
            facial = (
                read_facial(stem + ".json", n_frames, cfg.pose_fps)
                if os.path.exists(stem + ".json")
                else None
            )
            for t0, t1 in ranges:
                f0, f1 = int(t0 * cfg.pose_fps), int(t1 * cfg.pose_fps)
                a0, a1 = int(t0 * cfg.sr), int(t1 * cfg.sr)
                clip = {
                    "vid": speaker,
                    "euler141": euler[f0:f1],
                    "audio": audio[a0:a1],
                    "word_ids": word_ids[f0:f1],
                    "emo": emo[f0:f1],
                    "sem": sem[f0:f1],
                    "words": [
                        (w, s - t0, e - t0)
                        for w, s, e in words
                        if s < t1 and e > t0
                    ],
                }
                if facial is not None:
                    clip["facial"] = facial[f0:f1]
                yield clip


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Build BEAT records from the raw release.")
    p.add_argument("--raw_dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--split", choices=["train", "val", "test"],
                   default="train")
    p.add_argument("--speakers", type=int, nargs="+", default=[2, 4, 6, 8])
    p.add_argument("--pose_fps", type=int, default=15)
    p.add_argument("--audio_dtype", type=str, default="float32",
                   choices=["float32", "int16"],
                   help="int16 = PCM16 records (lossless against source WAVs, "
                        "about 2x the loader's throughput; decoded on the device)")
    p.add_argument("--vocab", type=str, default="",
                   help="existing vocab pkl; built from the TextGrids if "
                        "omitted")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    """Build the records ``argv`` asks for; returns the number of windows."""
    args = parse_args(argv)
    cfg = BeatConfig(pose_fps=args.pose_fps, speakers=tuple(args.speakers),
                     audio_dtype=args.audio_dtype)
    if args.vocab:
        vocab = Vocab.load(args.vocab)
    else:
        vocab = Vocab("beat_words")
        for speaker in args.speakers:
            for tg in glob.glob(
                os.path.join(args.raw_dir, str(speaker), "*.TextGrid")
            ):
                for w, _, _ in read_words(tg):
                    if w:
                        vocab.index_word(w)
        print(f"built vocab: {vocab.n_words} words", file=sys.stderr)

    n = build_beat_records(cfg, iter_clips(args, cfg, vocab), args.out)
    vocab.save(os.path.join(args.out, "vocab.pkl"))
    print(f"wrote {n} windows -> {args.out}")
    return n


if __name__ == "__main__":
    main()
