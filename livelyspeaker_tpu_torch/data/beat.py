"""BEAT dataset pipeline (47 joints x rot6d full-body + fingers).

Port of ``livelyspeaker_tpu/data/beat.py`` (numpy, with the rot6d
conversions through the port's ``ops/rotation.py`` in torch f32, where the
JAX module goes through ``jnp`` f32: the two agree to rounding, not bit for
bit). It follows the reference's three-stage offline pipeline
(scripts_beat/data_libs/preprocess_0.py: 120->15 fps BVH downsample +
projection onto the 141-channel ``spine_neck_141`` joint subset;
preprocess_1.py: official train/val/test split; dataloaders/beat.py
cache_generation + data_libs/process_cache.py: 34-frame windows with
per-frame word/emotion/semantic alignment, euler z-scoring, euler->rot6d)
emitting sharded npy records, and of the online ``CustomDataset``
(dataloaders/beat.py:45-573).
"""

from __future__ import annotations

import math

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .records import ShardedDataset, ShardWriter
from .bvh import BvhData
from ..ops.rotation import (
    euler_angles_to_matrix,
    matrix_to_euler_angles,
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)

__all__ = [
    "SPINE_NECK_141_JOINTS",
    "BeatConfig",
    "euler_deg_to_rot6d",
    "rot6d_to_euler_deg",
    "bvh_to_joint_channels",
    "sample_windows_from_beat_clip",
    "build_beat_records",
    "BeatWindowDataset",
    "beat_official_split",
]

# The 47-joint / 141-channel body+fingers subset used by the BEAT tree
# (data_tools.py:107-154 "spine_neck_141").
SPINE_NECK_141_JOINTS = (
    "Spine", "Neck", "Neck1",
    "RShoulder", "RArm", "RArm1", "RHand",
    "RHandM1", "RHandM2", "RHandM3",
    "RHandR", "RHandR1", "RHandR2", "RHandR3",
    "RHandP", "RHandP1", "RHandP2", "RHandP3",
    "RHandI", "RHandI1", "RHandI2", "RHandI3",
    "RHandT1", "RHandT2", "RHandT3",
    "LShoulder", "LArm", "LArm1", "LHand",
    "LHandM1", "LHandM2", "LHandM3",
    "LHandR", "LHandR1", "LHandR2", "LHandR3",
    "LHandP", "LHandP1", "LHandP2", "LHandP3",
    "LHandI", "LHandI1", "LHandI2", "LHandI3",
    "LHandT1", "LHandT2", "LHandT3",
)


@dataclass
class BeatConfig:
    njoints: int = 47
    pose_length: int = 34  # frames per window (beat.yaml pose_length)
    stride: int = 10
    pose_fps: int = 15
    sr: int = 16000
    # "int16": PCM16 waveforms in the records (lossless against 16-bit
    # source WAVs, half the gather and copy bytes; decoded on the device,
    # see ted.py TedConfig.audio_dtype)
    audio_dtype: str = "float32"
    pre_frames: int = 4
    speakers: Tuple[int, ...] = (2, 4, 6, 8)
    rotation_order: str = "XYZ"  # BEAT BVH channel order is Xrot Yrot Zrot
    # z-score stats of the euler channels (computed per-dataset offline,
    # mirrors the mean/std pkl of the bvh_rot cache)
    pose_mean: Optional[np.ndarray] = None
    pose_std: Optional[np.ndarray] = None

    @property
    def pose_dims(self) -> int:
        return self.njoints * 3  # euler channels (141)

    @property
    def rot6d_dims(self) -> int:
        return self.njoints * 6  # 282

    @property
    def audio_length(self) -> int:
        return int(round(self.pose_length / self.pose_fps * self.sr))


def euler_deg_to_rot6d(
    euler_deg: np.ndarray, order: str = "XYZ"
) -> np.ndarray:
    """[..., J, 3] euler degrees -> [..., J, 6] rot6d
    (process_cache.py:16-56 semantics: deg->rad, euler->matrix->rot6d)."""
    rad = torch.as_tensor(np.asarray(euler_deg, np.float32)) * (np.pi / 180.0)
    m = euler_angles_to_matrix(rad, order)
    return matrix_to_rotation_6d(m).numpy()


def rot6d_to_euler_deg(rot6d: np.ndarray, order: str = "XYZ") -> np.ndarray:
    """[..., J, 6] rot6d -> [..., J, 3] euler degrees (used for BVH export
    and the euler-based metrics, test_RAG_beat.py:100-101)."""
    m = rotation_6d_to_matrix(torch.as_tensor(np.asarray(rot6d, np.float32)))
    rad = matrix_to_euler_angles(m, order)
    return rad.numpy() * (180.0 / np.pi)


def bvh_to_joint_channels(
    bvh: BvhData,
    joints: Sequence[str] = SPINE_NECK_141_JOINTS,
    target_fps: int = 15,
) -> np.ndarray:
    """BVH -> [T, len(joints)*3] euler-degree rotation channels at target fps
    (preprocess_0.py 120->15 fps subsampling + 141-d projection)."""
    sub = bvh.select_joints(list(joints))
    rot_cols = [
        i
        for i, (j, c) in enumerate(sub.channel_order)
        if c.endswith("rotation")
    ]
    rot = sub.frames[:, rot_cols]
    step = max(int(round(bvh.fps / target_fps)), 1)
    return rot[::step].astype(np.float32)


def sample_windows_from_beat_clip(
    cfg: BeatConfig,
    euler141: np.ndarray,  # [T, 141] euler degrees at pose_fps
    audio: np.ndarray,  # 16 kHz waveform
    word_ids: Optional[np.ndarray] = None,  # [T] per-frame word indices
    emotion: Optional[np.ndarray] = None,  # [T] per-frame emotion labels
    semantic: Optional[np.ndarray] = None,  # [T] per-frame semantic scores
    facial: Optional[np.ndarray] = None,  # [T, 52] blendshape weights
    words: Optional[Sequence] = None,  # timed [word, start_s, end_s] triples
) -> Iterable[Dict]:
    """Slide pose_length windows at the configured stride
    (beat.py:_sample_from_clip :330-485); per-window sentences reconstructed
    from timed words for the SAG composition (beat.py:548-568 rebuilds them
    from word ids)."""
    t_total = len(euler141)
    n = cfg.pose_length
    num = math.floor((t_total - n) / cfg.stride) + 1
    samples_per_frame = cfg.sr // cfg.pose_fps
    for i in range(max(num, 0)):
        s = i * cfg.stride
        e = s + n
        a_s = s * samples_per_frame
        a_e = a_s + cfg.audio_length
        if a_e > len(audio):
            aud = np.pad(audio, (0, a_e - len(audio)), mode="symmetric")[a_s:a_e]
        else:
            aud = audio[a_s:a_e]
        win: Dict = {
            "euler": euler141[s:e].astype(np.float32),
            "audio": aud.astype(np.float32),
        }
        if word_ids is not None:
            win["word_ids"] = word_ids[s:e].astype(np.int32)
        if emotion is not None:
            win["emo"] = emotion[s:e].astype(np.int32)
        if semantic is not None:
            win["sem"] = semantic[s:e].astype(np.float32)
        if facial is not None:
            win["facial"] = facial[s:e].astype(np.float32)
        if words is not None:
            ws_t, we_t = s / cfg.pose_fps, e / cfg.pose_fps
            win["sentence"] = " ".join(
                w[0] for w in words if w[1] < we_t and w[2] > ws_t
            )
        yield win


def build_beat_records(
    cfg: BeatConfig,
    clips: Iterable[Dict],
    out_dir: str,
    shard_size: int = 1024,
) -> int:
    """clips: {vid:int, euler141 [T,141] deg, audio [L], word_ids?, emo?,
    sem?, facial?} -> sharded records with z-scored euler + rot6d.

    Computes the z-score stats over all clips first (two passes), mirroring
    the bvh_rot cache's mean/std normalisation.
    """
    clips = list(clips)
    all_euler = np.concatenate([c["euler141"] for c in clips], axis=0)
    mean = all_euler.mean(axis=0)
    std = all_euler.std(axis=0) + 1e-8

    writer = ShardWriter(out_dir, shard_size=shard_size)
    n = 0
    for clip in clips:
        for w in sample_windows_from_beat_clip(
            cfg,
            clip["euler141"],
            clip["audio"],
            clip.get("word_ids"),
            clip.get("emo"),
            clip.get("sem"),
            clip.get("facial"),
            clip.get("words"),
        ):
            euler = w["euler"]
            rot6d = euler_deg_to_rot6d(
                euler.reshape(cfg.pose_length, cfg.njoints, 3),
                cfg.rotation_order,
            ).reshape(cfg.pose_length, cfg.rot6d_dims)
            audio_out = w["audio"]
            if cfg.audio_dtype == "int16":
                from .ted import pcm16_encode

                audio_out = pcm16_encode(audio_out)
            fields = dict(
                pose=((euler - mean) / std).astype(np.float32),
                rot6d=rot6d.astype(np.float32),
                audio=audio_out,
                vid=np.int32(clip["vid"]),
                word_ids=w.get("word_ids", np.zeros(cfg.pose_length, np.int32)),
                emo=w.get("emo", np.zeros(cfg.pose_length, np.int32)),
                sem=w.get("sem", np.zeros(cfg.pose_length, np.float32)),
            )
            if "facial" in w:  # 52 blendshape weights (beat.py facial track)
                fields["facial"] = w["facial"]
            if "sentence" in w:
                fields["sentence"] = w["sentence"]
            writer.add(**fields)
            n += 1
    writer.finish(
        extra_meta={
            "dataset": "beat",
            "pose_length": cfg.pose_length,
            "njoints": cfg.njoints,
            "pose_mean": mean.tolist(),
            "pose_std": std.tolist(),
        }
    )
    return n


class BeatWindowDataset:
    """Online view: record -> training sample (beat.py:520-573 contract)."""

    def __init__(self, root: str, cfg: Optional[BeatConfig] = None):
        self.cfg = cfg or BeatConfig()
        self.records = ShardedDataset(root)
        meta = self.records.meta
        self.pose_mean = np.asarray(meta.get("pose_mean", []), np.float32)
        self.pose_std = np.asarray(meta.get("pose_std", []), np.float32)
        # speaker id -> contiguous index (beat speakers {2,4,6,8})
        self.speaker_index = {
            int(s): i for i, s in enumerate(self.cfg.speakers)
        }

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Dict:
        r = self.records[int(i)]
        cfg = self.cfg
        rot6d = np.asarray(r["rot6d"])  # [T, 282]
        motion = (
            rot6d.reshape(cfg.pose_length, cfg.njoints, 6)
            .transpose(1, 2, 0)
            .astype(np.float32)
        )  # [J, 6, T] (train_loop BEAT :120-123 layout)
        vid_raw = int(r["vid"])
        audio = np.asarray(r["audio"])
        if np.issubdtype(audio.dtype, np.integer):  # PCM16-stored records
            from .ted import pcm16_decode

            audio = pcm16_decode(audio)
        out = {
            "motion": motion,
            "pose": np.asarray(r["pose"], np.float32),
            "audio": audio.astype(np.float32),
            "vid": np.int32(self.speaker_index.get(vid_raw, vid_raw)),
            "emo": np.int32(np.asarray(r["emo"]).flat[0]),  # RAG.py beat :125
            "sem": np.asarray(r["sem"], np.float32),
            "word_ids": np.asarray(r["word_ids"], np.int32),
        }
        if "sentence" in r:
            out["sentence"] = str(r["sentence"])
        return out

    def batch(
        self, indices: Sequence[int], fields: Optional[Sequence[str]] = None
    ) -> Dict:
        """Vectorised batch assembly (one gather per field, the motion crop
        and transpose in the same pass), with the contract of per-row
        ``__getitem__``; see the TED twin (ted.py). ``fields`` restricts
        output (training: motion/audio/vid/emo)."""
        cfg = self.cfg
        if fields is not None:
            want = list(fields)
        else:
            want = ["motion", "pose", "audio", "vid", "emo", "sem", "word_ids"]
            if "sentence" in self.records.fields:
                want.append("sentence")
        g = self.records.gather_field
        out: Dict = {}
        if "motion" in want:
            m = g("rot6d", indices, transpose_crop=cfg.pose_length)
            out["motion"] = m.reshape(
                m.shape[0], cfg.njoints, 6, cfg.pose_length
            )  # [B, J, 6, T]
        if "pose" in want:
            out["pose"] = np.asarray(g("pose", indices), np.float32)
        if "audio" in want:
            a = g("audio", indices)
            out["audio"] = (
                a if np.issubdtype(a.dtype, np.integer)
                else np.asarray(a, np.float32)
            )
        if "vid" in want:
            v = np.asarray(g("vid", indices)).reshape(len(indices), -1)[:, 0]
            out["vid"] = np.asarray(
                [self.speaker_index.get(int(x), int(x)) for x in v], np.int32
            )
        if "emo" in want:
            e = np.asarray(g("emo", indices)).reshape(len(indices), -1)
            out["emo"] = np.asarray(e[:, 0], np.int32)
        if "sem" in want:
            out["sem"] = np.asarray(g("sem", indices), np.float32)
        if "word_ids" in want:
            out["word_ids"] = np.asarray(g("word_ids", indices), np.int32)
        if "sentence" in want:
            out["sentence"] = [
                str(s)
                for s in self.records.batch(indices, fields=["sentence"])[
                    "sentence"
                ]
            ]
        return out


# Official BEAT-english split tables (constant data that must match
# preprocess_1.py:175-238 ``split_rule_english``). Only the val/test lists
# matter: train is everything not moved out. "0_65_a"/"0_65_b" denote the
# first/second half of recording 0_65_65, cut at 30 s (300 s for 1_*) by
# cut_sequence (preprocess_1.py:239-284).
_BEAT_4H_SPEAKERS = frozenset({1, 2, 3, 4, 6, 7, 8, 9, 11, 21})
_BEAT_SPLIT_4H = {
    "val": frozenset(
        ["0_57_57", "0_58_58", "0_59_59", "0_60_60", "0_61_61", "0_62_62",
         "0_63_63", "0_64_64", "0_72_72", "0_80_80", "0_86_86", "0_94_94",
         "0_102_102", "0_110_110", "0_118_118", "1_12_12"]
    ),
    "test": frozenset(
        ["0_1_1", "0_2_2", "0_3_3", "0_4_4", "0_5_5", "0_6_6", "0_7_7",
         "0_8_8", "0_65_65", "0_73_73", "0_81_81", "0_87_87", "0_95_95",
         "0_103_103", "0_111_111", "1_1_1"]
    ),
}
_BEAT_SPLIT_1H = {
    "val": frozenset(
        ["0_5_5", "0_6_6", "0_7_7", "0_8_8", "0_65_b", "0_73_b", "0_81_b",
         "0_87_b", "0_95_b", "0_103_b", "0_111_b", "1_1_b"]
    ),
    "test": frozenset(
        ["0_1_1", "0_2_2", "0_3_3", "0_4_4", "0_65_a", "0_73_a", "0_81_a",
         "0_87_a", "0_95_a", "0_103_a", "0_111_a", "1_1_a"]
    ),
}


def beat_official_split(name: str, duration_s: float) -> Dict[str, List]:
    """Official BEAT split for one recording (preprocess_1.py:175-347).

    ``name`` is the raw recording name ``<speaker>_<alias>_<r0>_<r1>_<r2>``
    (e.g. ``2_scott_0_9_9``). Whole recordings listed in the speaker group's
    val/test table go there entirely; recordings with ``_a``/``_b`` halves
    in the tables (1-hour speakers only) are cut at 30 s (``0_*``) or 300 s
    (``1_*``): the head goes to test, the tail to val (cut_sequence
    :239-284 + the move loops :306-346). Everything else stays in train.

    Returns {'train': [(t0, t1)...], 'val': [...], 'test': [...]} second
    ranges.
    """
    base = name.split("/")[-1].split(".")[0]
    parts = base.split("_")
    if len(parts) >= 5 and parts[0].isdigit():
        speaker = int(parts[0])
        fid = "_".join(parts[2:5])
        rec = parts[2:5]
    else:  # bare file id like "0_65_65"
        speaker = 0
        fid = "_".join(parts[:3])
        rec = parts[:3]
    rule = (
        _BEAT_SPLIT_4H if speaker in _BEAT_4H_SPEAKERS else _BEAT_SPLIT_1H
    )
    out: Dict[str, List] = {"train": [], "val": [], "test": []}
    if fid in rule["test"]:
        out["test"] = [(0.0, duration_s)]
        return out
    if fid in rule["val"]:
        out["val"] = [(0.0, duration_s)]
        return out
    head = f"{rec[0]}_{rec[1]}"
    if f"{head}_a" in rule["test"]:
        cut = min(30.0 if rec[0] == "0" else 300.0, duration_s)
        out["test"] = [(0.0, cut)]
        if duration_s > cut:
            out["val"] = [(cut, duration_s)]
        return out
    out["train"] = [(0.0, duration_s)]
    return out
