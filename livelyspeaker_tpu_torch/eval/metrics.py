"""Gesture evaluation metrics: TED beat-align, BEAT SRGR, L1 diversity and
the onset alignment (GAHR), and the long-form seam report.

Port of ``livelyspeaker_tpu/eval/metrics.py``, the same numpy code, so the
numbers are the JAX package's bit for bit. Sources: the TED beat-align
scoring loop (scripts/test_RAG_ted.py:22-33, 88-126) and SRGR, L1div and
the alignment (scripts_beat/utils/metric.py). The reference's per-sample
Python loops are vectorised; the audio onsets come from ``eval.audio``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from .audio import frames_to_time, onset_backtrack, onset_detect, onset_strength, rms_from_stft, stft_mag
from ..ops.skeleton import MEAN_DIR_VEC

__all__ = [
    "TED_ANGLE_PAIRS",
    "TED_CHANGE_ANGLE",
    "motion_beat_times_ted",
    "ted_beat_align_batch",
    "SRGR",
    "L1Div",
    "Alignment",
    "long_form_seam_report",
]

# (test_RAG_ted.py:24-30)
TED_ANGLE_PAIRS = ((3, 4), (4, 5), (6, 7), (7, 8))
TED_CHANGE_ANGLE = (
    0.0034540758933871984,
    0.007043459918349981,
    0.003493624273687601,
    0.007205077446997166,
)


def _angle_diff_track(motions: np.ndarray) -> np.ndarray:
    """[B, T, 27] mean-subtracted dir-vec motions -> [B, T] normalised
    angle-velocity track (test_RAG_ted.py:88-104)."""
    b, t, _ = motions.shape
    vec = motions + MEAN_DIR_VEC[None, None, :]
    vec = vec.reshape(b, t, 9, 3)
    vec = vec / np.maximum(np.linalg.norm(vec, axis=-1, keepdims=True), 1e-12)
    diff = np.zeros((b, t - 1))
    for idx, (j1, j2) in enumerate(TED_ANGLE_PAIRS):
        inner = np.clip(np.sum(vec[:, :, j1] * vec[:, :, j2], axis=-1), -1, 1)
        angle = np.arccos(inner) / math.pi  # [B, T]
        diff += np.abs(np.diff(angle, axis=1)) / TED_CHANGE_ANGLE[idx] / len(
            TED_CHANGE_ANGLE
        )
    return np.concatenate([np.zeros((b, 1)), diff], axis=1)


def motion_beat_times_ted(
    motions: np.ndarray, fps: float = 15.0, thres: float = 0.03
) -> Sequence[np.ndarray]:
    """Per-sample motion beat times: strict local minima of the angle
    velocity with a drop >= thres (test_RAG_ted.py:106-111)."""
    ad = _angle_diff_track(motions)
    out = []
    for b in range(ad.shape[0]):
        times = []
        for t in range(2, ad.shape[1] - 1):
            if ad[b, t] < ad[b, t - 1] and ad[b, t] < ad[b, t + 1]:
                if (
                    ad[b, t - 1] - ad[b, t] >= thres
                    or ad[b, t + 1] - ad[b, t] >= thres
                ):
                    times.append(t / fps)
        out.append(np.asarray(times))
    return out


def ted_beat_align_batch(
    motions: np.ndarray,
    audios: np.ndarray,
    sr: int = 16000,
    sigma: float = 0.1,
    thres: float = 0.03,
) -> Tuple[float, int, int]:
    """One batch of the TED beat-align accumulation
    (test_RAG_ted.py:106-123): returns (score_sum, n_audio_beats,
    n_motion_beats)."""
    motion_beats = motion_beat_times_ted(motions, thres=thres)
    score_sum, n_beats, motion_total = 0.0, 0, 0
    for b in range(len(motion_beats)):
        mb = motion_beats[b]
        motion_total += len(mb)
        if len(mb) == 0:
            continue
        ab = onset_detect(np.asarray(audios[b]), sr=sr, units="time")
        for t_a in ab:
            score_sum += math.exp(
                -np.min((t_a - mb) ** 2) / (2 * sigma * sigma)
            )
        n_beats += len(ab)
    return score_sum, n_beats, motion_total


class SRGR:
    """Semantic-Relevant Gesture Recall (scripts_beat/utils/metric.py:27-51)."""

    def __init__(self, threshold: float = 0.3, joints: int = 47):
        self.threshold = threshold
        self.pose_dims = 3
        self.joints = joints
        self.counter = 0
        self.sum = 0.0

    def run(self, results, targets, semantic) -> float:
        results = np.asarray(results).reshape(-1, self.joints, self.pose_dims)
        targets = np.asarray(targets).reshape(-1, self.joints, self.pose_dims)
        semantic = np.asarray(semantic).reshape(-1)
        diff = np.sum(np.abs(results - targets), axis=2)
        success = np.where(diff < self.threshold, 1.0, 0.0)
        success = success * semantic[:, None] * (1 / 0.165)
        rate = success.mean()
        self.counter += success.shape[0]
        self.sum += rate * success.shape[0]
        return float(rate)

    def avg(self) -> float:
        return self.sum / self.counter if self.counter else 0.0


class L1Div:
    """L1 diversity accumulator (scripts_beat/utils/metric.py:12-24)."""

    def __init__(self):
        self.counter = 0
        self.sum = 0.0

    def run(self, results) -> None:
        results = np.asarray(results, np.float64)
        self.counter += results.shape[0]
        mean = results.mean(axis=0, keepdims=True)
        self.sum += float(np.sum(np.abs(results - mean)))

    def avg(self) -> float:
        return self.sum / self.counter if self.counter else 0.0


class Alignment:
    """Onset-vs-motion-beat alignment with Gaussian kernel (GAHR)
    (scripts_beat/utils/metric.py:53-193)."""

    def __init__(self, sigma: float = 0.3, order: int = 2):
        self.sigma = sigma
        self.order = order

    def audio_beats(self, wave: np.ndarray, sr: int = 16000) -> np.ndarray:
        """Backtracked-to-RMS-minimum onsets in seconds
        (metric.py:60-74, 186)."""
        oenv = onset_strength(wave, sr=sr)
        # metric.py:74 calls librosa.onset.onset_detect(onset_envelope=...)
        # WITHOUT sr=, so the peak-pick windows are sized with librosa's
        # default sr=22050 even though the envelope is 16 kHz audio; mirror
        # that quirk (frames_to_time below likewise uses the 22050 default).
        onset_raw = onset_detect(
            onset_envelope=oenv, sr=22050, backtrack=False
        )
        s = stft_mag(wave)
        rms = rms_from_stft(s)
        onset_bt_rms = onset_backtrack(onset_raw, rms)
        # librosa.frames_to_time default sr=22050 (metric.py:186 passes no sr)
        return frames_to_time(onset_bt_rms, sr=22050)

    def motion_beats(
        self, pose: np.ndarray, right_wrist_slice=(15, 18)
    ) -> np.ndarray:
        """Local minima of right-wrist velocity (metric.py:83-98, 189).

        pose: [T, D] with euler joint channels; the reference extracts
        channels [9:18] (right shoulder/arm/wrist) and [75:84] (left) then
        uses the right wrist = columns 6:9 of the first group.
        """
        from scipy.signal import argrelextrema

        sel = np.concatenate([pose[:, 9:18], pose[:, 75:84]], axis=1)
        vel = sel[1:] - sel[:-1]
        vel_right_wrist = np.linalg.norm(vel[:, 6:9], axis=1)
        (idx,) = argrelextrema(vel_right_wrist, np.less, order=self.order)
        return idx

    @staticmethod
    def GAHR(a: np.ndarray, b: np.ndarray, sigma: float) -> float:
        """sum_b exp(-min_a |a-b|^2 / 2 sigma^2) / len(b)
        (metric.py:163-174)."""
        if len(b) == 0:
            return 0.0
        total = 0.0
        a = np.asarray(a, np.float64)
        for b_each in np.asarray(b, np.float64):
            l2_min = np.min(np.abs(a - b_each)) if len(a) else np.inf
            total += math.exp(-(l2_min**2) / (2 * sigma**2))
        return total / len(b)

    def score(
        self, wave: np.ndarray, pose: np.ndarray, pose_fps: int = 15,
        sr: int = 16000
    ) -> float:
        audio_bt = self.audio_beats(wave, sr=sr)
        mb = self.motion_beats(pose)
        pose_bt = mb / pose_fps
        return self.GAHR(pose_bt, audio_bt, self.sigma)


def long_form_seam_report(
    motion: np.ndarray, nframes: int, n_pre_seq: int
) -> dict:
    """Quality of the long-form window seams (pipeline.generate_long_form).

    The reference never generates past one dataset window; its continuity
    story is the seed-frame mechanism (RAG.py:184-192) that our long-form
    path turns into an API: window w+1 is seeded with window w's last
    ``n_pre_seq`` generated frames.  A well-conditioned model should make
    the transition *into* each new window no jerkier than motion inside a
    window — this report quantifies that.

    Args:
      motion: [J, F, T] long-form output (``generate_long_form`` layout).
      nframes / n_pre_seq: the window grid parameters used to generate it
        (hop = nframes - n_pre_seq; window w>0's first kept frame lands at
        t = nframes + (w-1)*hop).

    Returns dict with per-frame velocity magnitudes split by boundary type:
      seam_mean/seam_p95: ||x[t]-x[t-1]|| over the seam crossings
        (last committed frame of window w -> first kept frame of w+1);
      within_mean/within_p95: same over every other frame boundary;
      ratio_p95: seam_p95 / within_p95 — ~1.0 means seams are
        indistinguishable from ordinary motion; >>1 means visible jerks.
    """
    motion = np.asarray(motion, np.float64)
    j, f, t = motion.shape
    hop = nframes - n_pre_seq
    vel = np.linalg.norm(
        np.diff(motion, axis=-1).reshape(j * f, t - 1), axis=0
    )  # vel[i] = ||x[i+1] - x[i]||
    seam_starts = [
        nframes + w * hop for w in range(((t - nframes) // hop) + 1)
        if nframes + w * hop < t
    ]
    seam_idx = np.asarray([s - 1 for s in seam_starts], np.intp)
    mask = np.zeros(t - 1, bool)
    mask[seam_idx] = True
    seam, within = vel[mask], vel[~mask]
    if not len(seam):
        return {
            "n_seams": 0,
            "seam_mean": float("nan"),
            "seam_p95": float("nan"),
            "within_mean": float(np.mean(within)),
            "within_p95": float(np.percentile(within, 95)),
            "ratio_p95": float("nan"),
        }
    within_p95 = float(np.percentile(within, 95))
    seam_p95 = float(np.percentile(seam, 95))
    return {
        "n_seams": int(len(seam)),
        "seam_mean": float(np.mean(seam)),
        "seam_p95": seam_p95,
        "within_mean": float(np.mean(within)),
        "within_p95": within_p95,
        "ratio_p95": seam_p95 / max(within_p95, 1e-12),
    }
