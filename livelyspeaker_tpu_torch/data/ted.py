"""TED co-speech gesture data pipeline.

Port of ``livelyspeaker_tpu/data/ted.py`` (numpy; the same records, bit for
bit). Offline stage: resample skeletons to 15 fps, slide
n_poses*1.25-frame windows at stride 10, filter bad motion, convert to unit
direction vectors minus the dataset mean, crop the aligned raw-audio window,
and write them as sharded npy records (records.py).

Online stage: clip to 34 frames, fix the audio length, build frame-aligned
word indices and the 'A person is talking: "..."' prompt sentence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .records import ShardedDataset, ShardWriter
from .vocab import Vocab
from ..ops.skeleton import MEAN_DIR_VEC, MEAN_POSE

__all__ = [
    "TedConfig",
    "MotionFilter",
    "resample_pose_seq",
    "make_audio_fixed_length",
    "pcm16_encode",
    "pcm16_decode",
    "convert_pose_seq_to_dir_vec_np",
    "sample_windows_from_clip",
    "build_ted_records",
    "TedWindowDataset",
    "PROMPT",
]

PROMPT = 'A person is talking: '  # lmdb_data_loader.py:189


@dataclass
class TedConfig:
    n_poses: int = 34
    subdivision_stride: int = 10
    fps: int = 15
    sr: int = 16000
    # "int16" stores PCM16 waveforms in the records: lossless against the
    # 16-bit source WAVs, half the bytes through the gather and the
    # host-to-device copy; decoded to f32 by the consumers (the WavEncoder on
    # the device, the eval DSP on the host).
    audio_dtype: str = "float32"
    mean_dir_vec: np.ndarray = field(default_factory=lambda: MEAN_DIR_VEC.copy())
    mean_pose: np.ndarray = field(default_factory=lambda: MEAN_POSE.copy())

    @property
    def n_poses_extended(self) -> int:
        """Window length in the cache: 25% margin (lmdb_data_loader.py:88)."""
        return int(round(self.n_poses * 1.25))

    @property
    def audio_length(self) -> int:
        return int(round(self.n_poses / self.fps * self.sr))


def resample_pose_seq(poses: np.ndarray, duration_in_sec: float, fps: int) -> np.ndarray:
    """Linear-interp resampling to target fps (data_utils.py:46-56)."""
    n = len(poses)
    expected_n = duration_in_sec * fps
    x_new = np.arange(0, n, n / expected_n)
    x = np.arange(n)
    flat = poses.reshape(n, -1)
    out = np.empty((len(x_new), flat.shape[1]), dtype=np.float64)
    for d in range(flat.shape[1]):
        out[:, d] = np.interp(x_new, x, flat[:, d])
    return out.reshape((len(x_new),) + poses.shape[1:]).astype(poses.dtype)


# One scale everywhere (encode, decode, WavEncoder, stft_mag): the WAV
# loaders produce int16/32768 floats, so rounding at *32768 makes the
# stored-record round trip bit-lossless vs the 16-bit source.
PCM16_SCALE = 32768.0


def pcm16_encode(audio: np.ndarray) -> np.ndarray:
    """float waveform [-1, 1] -> PCM16 (the TED source WAVs' native width)."""
    return np.clip(
        np.round(np.asarray(audio, np.float64) * PCM16_SCALE), -32768, 32767
    ).astype(np.int16)


def pcm16_decode(audio: np.ndarray) -> np.ndarray:
    return np.asarray(audio, np.float32) * np.float32(1.0 / PCM16_SCALE)


def make_audio_fixed_length(audio: np.ndarray, expected: int) -> np.ndarray:
    """Pad (symmetric) or crop to the expected length (data_utils.py:68-74)."""
    n_pad = expected - len(audio)
    if n_pad > 0:
        return np.pad(audio, (0, n_pad), mode="symmetric")
    return audio[:expected]


def convert_pose_seq_to_dir_vec_np(pose: np.ndarray) -> np.ndarray:
    """numpy twin of ops.skeleton.convert_pose_seq_to_dir_vec for the offline
    pipeline (data_utils.py:101-120)."""
    from ..ops.skeleton import DIR_VEC_PAIRS

    if pose.shape[-1] != 3:
        pose = pose.reshape(pose.shape[:-1] + (-1, 3))
    parents = [p[0] for p in DIR_VEC_PAIRS]
    children = [p[1] for p in DIR_VEC_PAIRS]
    vec = pose[..., children, :] - pose[..., parents, :]
    norm = np.linalg.norm(vec, axis=-1, keepdims=True)
    return (vec / np.maximum(norm, 1e-12)).astype(np.float32)


def motion_fft_lowpass(vec_seq: np.ndarray, keep: int = 2) -> np.ndarray:
    """Low-pass rhythm conditioning: keep only the first ``keep`` temporal
    Fourier components (lmdb_data_loader.py:251-255 ``motion_fft``)."""
    f = np.fft.rfft(vec_seq, axis=0)
    f[keep:] = 0
    return np.fft.irfft(f, n=vec_seq.shape[0], axis=0).astype(vec_seq.dtype)


def motion_random_resample(
    vec_seq: np.ndarray, rng: np.random.Generator, n_splits=(2, 4),
    min_len: int = 3, max_len: int = 20,
) -> np.ndarray:
    """Random piecewise time-warp augmentation
    (lmdb_data_loader.py:224-249 ``randomSplit`` + ``motion_cs``)."""
    t = vec_seq.shape[0]
    n = int(rng.integers(n_splits[0], n_splits[1] + 1))

    def random_split(total):
        res, m, k = [], total, n
        while k > 0:
            lo = max(min_len, m - (k - 1) * max_len)
            hi = min(max_len, m - (k - 1) * min_len)
            num = int(rng.integers(lo, hi + 1))
            k -= 1
            m -= num
            res.append(num)
        return res

    src = random_split(t)
    tgt = random_split(t)
    cum = np.concatenate([[0], np.cumsum(src)])
    pieces = []
    for i in range(n):
        seg = vec_seq[cum[i] : cum[i + 1]]
        xi = np.linspace(0, len(seg) - 1, tgt[i])
        idx0 = np.floor(xi).astype(int)
        idx1 = np.minimum(idx0 + 1, len(seg) - 1)
        w = (xi - idx0)[:, None]
        pieces.append(seg[idx0] * (1 - w) + seg[idx1] * w)
    return np.concatenate(pieces, axis=0).astype(vec_seq.dtype)


class MotionFilter:
    """Window rejection rules (motion_preprocessor.py:4-87)."""

    def __init__(self, mean_pose: np.ndarray):
        self.mean_pose = np.asarray(mean_pose).reshape(-1, 3)

    def check(self, skeletons: np.ndarray) -> str:
        """Returns 'PASS' or the rejection reason."""
        sk = np.asarray(skeletons)
        if sk.ndim == 2:
            sk = sk.reshape(sk.shape[0], -1, 3)
        # too close to mean pose (th=0.02, motion_preprocessor.py:52-65)
        if np.mean(np.abs(sk - self.mean_pose)) < 0.02:
            return "pose"
        # implausible spine angle (:67-87)
        spine = sk[:, 1] - sk[:, 0]
        spine = spine / np.maximum(
            np.linalg.norm(spine, axis=-1, keepdims=True), 1e-12
        )
        angles = np.arccos(np.clip(-spine[:, 1], -1.0, 1.0))
        if np.rad2deg(angles.max()) > 30 or np.rad2deg(angles.mean()) > 20:
            return "spine angle"
        # static wrists (var < 0.0014, :32-50)
        lvar = np.sum(np.var(sk[:, 6], axis=0))
        rvar = np.sum(np.var(sk[:, 9], axis=0))
        if lvar < 0.0014 and rvar < 0.0014:
            return "motion"
        if np.isnan(sk).any():
            return "nan"
        return "PASS"


def get_words_in_time_range(word_list, start_time, end_time):
    """(data_preprocessor.py:173-188)"""
    words = []
    for word in word_list:
        _, ws, we = word[0], word[1], word[2]
        if ws >= end_time:
            break
        if we <= start_time:
            continue
        words.append(word)
    return words


def sample_windows_from_clip(
    cfg: TedConfig,
    vid: str,
    skeletons: np.ndarray,  # [F, 10, 3] at native fps
    audio_raw: np.ndarray,  # 16 kHz waveform
    words: Sequence[Tuple[str, float, float]],
    start_time: float,
    end_time: float,
    disable_filtering: bool = False,
) -> Iterable[Dict]:
    """Yield window samples from one clip (data_preprocessor.py:69-167)."""
    skel = resample_pose_seq(skeletons, end_time - start_time, cfg.fps)
    filt = MotionFilter(cfg.mean_pose)
    n_ext = cfg.n_poses_extended
    audio_len_ext = int(n_ext / cfg.fps * cfg.sr)

    num_subdivision = (
        math.floor((len(skel) - n_ext) / cfg.subdivision_stride) + 1
    )
    for i in range(max(num_subdivision, 0)):
        s = i * cfg.subdivision_stride
        e = s + n_ext
        window = skel[s:e]
        ws_t = start_time + s / cfg.fps
        we_t = start_time + e / cfg.fps
        sample_words = get_words_in_time_range(words, ws_t, we_t)
        if len(sample_words) < 2:
            continue
        verdict = filt.check(window)
        if verdict != "PASS" and not disable_filtering:
            continue
        a_s = math.floor(s / len(skel) * len(audio_raw))
        a_e = a_s + audio_len_ext
        if a_e > len(audio_raw):
            audio = np.pad(
                audio_raw, (0, a_e - len(audio_raw)), mode="symmetric"
            )[a_s:a_e]
        else:
            audio = audio_raw[a_s:a_e]
        dir_vec = convert_pose_seq_to_dir_vec_np(window)
        yield {
            "vid": vid,
            "pose_seq": window.astype(np.float32),
            "vec_seq": (dir_vec - cfg.mean_dir_vec.reshape(-1, 3)).astype(
                np.float32
            ),
            "audio": audio.astype(np.float32),
            "words": [list(w) for w in sample_words],
            "start_time": ws_t,
            "end_time": we_t,
        }


def build_ted_records(
    cfg: TedConfig,
    clips: Iterable[Dict],
    out_dir: str,
    shard_size: int = 2048,
    disable_filtering: bool = False,
) -> Tuple[int, Vocab]:
    """Offline converter: clips -> sharded records + speaker vocab.

    Each clip dict: {vid, skeletons [F,10,3], audio [L], words, start_time,
    end_time}.
    """
    writer = ShardWriter(out_dir, shard_size=shard_size)
    speaker_vocab = Vocab("vid", insert_default_tokens=False)
    n = 0
    for clip in clips:
        speaker_vocab.index_word(clip["vid"])
        for s in sample_windows_from_clip(
            cfg,
            clip["vid"],
            clip["skeletons"],
            clip["audio"],
            clip["words"],
            clip["start_time"],
            clip["end_time"],
            disable_filtering=disable_filtering,
        ):
            audio_out = s["audio"]
            if cfg.audio_dtype == "int16":
                audio_out = pcm16_encode(audio_out)
            writer.add(
                vec_seq=s["vec_seq"],
                pose_seq=s["pose_seq"],
                audio=audio_out,
                words=s["words"],
                vid=s["vid"],
                start_time=np.float64(s["start_time"]),
                end_time=np.float64(s["end_time"]),
            )
            n += 1
    writer.finish(
        extra_meta={
            "dataset": "ted",
            "n_poses": cfg.n_poses,
            "n_poses_extended": cfg.n_poses_extended,
            "fps": cfg.fps,
        }
    )
    import os

    speaker_vocab.save(os.path.join(out_dir, "speaker_model.pkl"))
    return n, speaker_vocab


class TedWindowDataset:
    """Online view: record -> training sample (lmdb_data_loader.py:121-198)."""

    def __init__(
        self,
        root: str,
        cfg: Optional[TedConfig] = None,
        lang_model: Optional[Vocab] = None,
        speaker_model: Optional[Vocab] = None,
    ):
        import os

        self.cfg = cfg or TedConfig()
        self.records = ShardedDataset(root)
        self.lang_model = lang_model
        sp = os.path.join(root, "speaker_model.pkl")
        self.speaker_model = speaker_model or (
            Vocab.load(sp) if os.path.exists(sp) else None
        )

    def __len__(self) -> int:
        return len(self.records)

    def _frame_word_indices(self, words, start_time, end_time) -> np.ndarray:
        """Frame-aligned word index track (extend_word_seq,
        lmdb_data_loader.py:130-155)."""
        n = self.cfg.n_poses
        out = np.zeros(n, np.int32)
        if self.lang_model is None:
            return out
        frame_dur = (end_time - start_time) / n
        for w in words:
            idx = max(0, int(np.floor((w[1] - start_time) / frame_dur)))
            if idx < n:
                out[idx] = self.lang_model.get_word_index(w[0])
        return out

    def __getitem__(self, i: int) -> Dict:
        r = self.records[int(i)]
        cfg = self.cfg
        vec_seq = np.asarray(r["vec_seq"])[: cfg.n_poses].reshape(cfg.n_poses, -1)
        pose_seq = np.asarray(r["pose_seq"])[: cfg.n_poses].reshape(
            cfg.n_poses, -1
        )
        n_total = len(np.asarray(r["vec_seq"]))
        duration = float(r["end_time"]) - float(r["start_time"])
        sample_end_time = float(r["start_time"]) + duration * cfg.n_poses / n_total
        audio = np.asarray(r["audio"])
        if np.issubdtype(audio.dtype, np.integer):  # PCM16-stored records
            audio = pcm16_decode(audio)
        audio = make_audio_fixed_length(audio, cfg.audio_length)
        words = r["words"]
        sentence = " ".join(w[0] for w in words)
        vid_idx = (
            self.speaker_model.get_word_index(r["vid"])
            if self.speaker_model
            else 0
        )
        return {
            "motion": vec_seq.reshape(cfg.n_poses, 9, 3)
            .transpose(1, 2, 0)
            .astype(np.float32),  # [J, F, T]
            "vec_seq": vec_seq.astype(np.float32),
            "pose_seq": pose_seq.astype(np.float32),
            "audio": audio.astype(np.float32),
            "vid": np.int32(vid_idx),
            "word_ids": self._frame_word_indices(
                words, float(r["start_time"]), sample_end_time
            ),
            "sentence": PROMPT + '"' + sentence + '"',
        }

    # record fields each output field needs assembled
    _RAW_DEPS = {
        "motion": ("vec_seq",),
        "vec_seq": ("vec_seq",),
        "pose_seq": ("pose_seq",),
        "audio": ("audio",),
        "vid": ("vid",),
        "word_ids": ("words", "start_time", "end_time"),
        "sentence": ("words",),
    }

    def batch(
        self, indices: Sequence[int], fields: Optional[Sequence[str]] = None
    ) -> Dict:
        """Vectorised batch assembly: one gather per record field, then
        batched slicing and reshaping, with the contract of per-row
        ``self[i]``. ``fields`` restricts output to what the consumer needs
        (training: motion/audio/vid; the word and sentence tracks are for
        evaluation). PCM16 audio stays int16: the WavEncoder decodes it."""
        cfg = self.cfg
        want = list(fields) if fields is not None else list(self._RAW_DEPS)
        json_needed = sorted(
            {r for f in want for r in self._RAW_DEPS[f]}
            & {"vid", "words", "start_time", "end_time"}
        )
        raw = self.records.batch(indices, fields=json_needed)
        n = cfg.n_poses
        out: Dict = {}

        if "motion" in want:
            # gather + 42->34 crop + [T,C]->[C,T] transpose
            m = self.records.gather_field(
                "vec_seq", indices, transpose_crop=n
            )  # [B, 27, n]
            out["motion"] = m.reshape(m.shape[0], 9, 3, n)
        if "vec_seq" in want:
            v = self.records.gather_field("vec_seq", indices, prefix=n)
            out["vec_seq"] = np.asarray(
                v.reshape(v.shape[0], n, -1), np.float32
            )
        if "pose_seq" in want:
            ps = self.records.gather_field("pose_seq", indices, prefix=n)
            out["pose_seq"] = np.asarray(
                ps.reshape(ps.shape[0], n, -1), np.float32
            )
        if "audio" in want:
            stored = self.records.row_shape("audio")[0]
            if stored >= cfg.audio_length:
                out["audio"] = self.records.gather_field(
                    "audio", indices, prefix=cfg.audio_length
                )
            else:
                a = self.records.gather_field("audio", indices)
                out["audio"] = np.pad(
                    a, ((0, 0), (0, cfg.audio_length - stored)),
                    mode="symmetric",
                )
        if "vid" in want:
            if self.speaker_model:
                out["vid"] = np.asarray(
                    [self.speaker_model.get_word_index(v) for v in raw["vid"]],
                    np.int32,
                )
            else:
                out["vid"] = np.zeros(len(indices), np.int32)
        if "word_ids" in want or "sentence" in want:
            n_total = self.records.row_shape("vec_seq")[0]
            wi, sents = [], []
            for k, words in enumerate(raw["words"]):
                if "sentence" in want:
                    sents.append(
                        PROMPT + '"' + " ".join(w[0] for w in words) + '"'
                    )
                if "word_ids" in want:
                    st = float(raw["start_time"][k])
                    dur = float(raw["end_time"][k]) - st
                    wi.append(
                        self._frame_word_indices(
                            words, st, st + dur * n / n_total
                        )
                    )
            if "word_ids" in want:
                out["word_ids"] = np.stack(wi)
            if "sentence" in want:
                out["sentence"] = sents
        return out
