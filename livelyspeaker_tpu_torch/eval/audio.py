"""Audio DSP for the beat-alignment metrics, in numpy on the host.

Port of ``livelyspeaker_tpu/eval/audio.py``, the same code: librosa's
documented algorithms at librosa 0.9.2's defaults (librosa is not a
dependency). Hann STFT (n_fft 2048, hop 512, centred, reflect padding;
integer waves are PCM16 and scaled by 1/32768), the Slaney mel filterbank
(128 mels), the log-power spectral-flux onset envelope, librosa's
peak-picking rule with its slice-exclusive windows, backtracking to the
preceding energy minimum, and frame RMS. The reference computes its audio
beats through librosa (scripts/test_RAG_ted.py:113,
scripts_beat/utils/metric.py:60-74).

It stays numpy so that the metrics give the JAX package's numbers bit for
bit; it runs host-side in the eval loop, beside the card's sampling.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "stft_mag",
    "mel_filterbank",
    "melspectrogram",
    "power_to_db",
    "onset_strength",
    "peak_pick",
    "onset_detect",
    "onset_backtrack",
    "rms_from_stft",
    "frames_to_time",
]


def stft_mag(y: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """|STFT| with Hann window and centered reflect padding. [F, T]"""
    if np.issubdtype(np.asarray(y).dtype, np.integer):
        y = np.asarray(y, np.float32) * np.float32(1.0 / 32768.0)  # PCM16
    y = np.asarray(y, np.float32)
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect" if len(y) > pad else "constant")
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * window[None, :]
    return np.abs(np.fft.rfft(frames, axis=1)).T.astype(np.float32)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
    fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank [n_mels, 1+n_fft/2]."""
    fmax = fmax or sr / 2
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def melspectrogram(
    y: np.ndarray, sr: int = 16000, n_fft: int = 2048, hop: int = 512,
    n_mels: int = 128, power: float = 2.0
) -> np.ndarray:
    s = stft_mag(y, n_fft, hop) ** power
    return mel_filterbank(sr, n_fft, n_mels) @ s


def power_to_db(s: np.ndarray, ref=np.max, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    ref_value = ref(s) if callable(ref) else ref
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    log_spec -= 10.0 * np.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def onset_strength(
    y: np.ndarray, sr: int = 16000, n_fft: int = 2048, hop: int = 512,
    n_mels: int = 128, lag: int = 1
) -> np.ndarray:
    """Spectral-flux onset envelope (librosa.onset.onset_strength defaults:
    mel power-dB input, positive first difference, mean over bands, centered
    compensation shift of n_fft//(2*hop) frames)."""
    s = power_to_db(melspectrogram(y, sr, n_fft, hop, n_mels))
    diff = np.maximum(0.0, s[:, lag:] - s[:, :-lag])
    env = diff.mean(axis=0)
    pad = lag + n_fft // (2 * hop)  # lag + centered compensation
    env = np.concatenate([np.zeros(pad, env.dtype), env])
    return env[: s.shape[1]]


def peak_pick(
    x: np.ndarray, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
    delta: float, wait: int
) -> np.ndarray:
    """librosa.util.peak_pick (0.9.2): local-max + above-local-mean-by-delta
    + wait.  Windows are python-slice-exclusive — ``x[i-pre : i+post]`` — as
    in librosa's moving filters (max_length/avg_length = pre + post), with
    truncation at the boundaries; the wait rule keeps an onset only when
    ``i > last + wait``."""
    x = np.asarray(x, np.float64)
    n = len(x)
    peaks = []
    for i in range(n):
        lo_m = max(0, i - pre_max)
        hi_m = min(n, i + post_max)
        if x[i] != x[lo_m:hi_m].max():
            continue
        lo_a = max(0, i - pre_avg)
        hi_a = min(n, i + post_avg)
        if x[i] < x[lo_a:hi_a].mean() + delta:
            continue
        if peaks and i - peaks[-1] <= wait:
            continue
        peaks.append(i)
    return np.asarray(peaks, np.int64)


def onset_detect(
    y: np.ndarray | None = None,
    sr: int = 16000,
    hop: int = 512,
    onset_envelope: np.ndarray | None = None,
    backtrack: bool = False,
    units: str = "frames",
) -> np.ndarray:
    """librosa.onset.onset_detect with default peak-picking parameters."""
    if onset_envelope is None:
        onset_envelope = onset_strength(y, sr=sr, hop=hop)
    env = onset_envelope.astype(np.float64)
    if env.max() > 0:
        env = env / env.max()  # librosa normalizes
    fps_units = sr / hop
    onsets = peak_pick(
        env,
        pre_max=int(0.03 * fps_units),
        post_max=int(0.0 * fps_units) + 1,
        pre_avg=int(0.1 * fps_units),
        post_avg=int(0.1 * fps_units) + 1,
        delta=0.07,
        wait=int(0.03 * fps_units),
    )
    if backtrack:
        onsets = onset_backtrack(onsets, env)
    if units == "time":
        return frames_to_time(onsets, sr=sr, hop=hop)
    return onsets


def onset_backtrack(events: np.ndarray, energy: np.ndarray) -> np.ndarray:
    """Roll each onset back to the preceding local minimum of energy
    (librosa.onset.onset_backtrack)."""
    minima = np.flatnonzero(
        (energy[1:-1] <= energy[:-2]) & (energy[1:-1] < energy[2:])
    ) + 1
    minima = np.union1d([0], minima)
    out = np.empty_like(events)
    for i, e in enumerate(events):
        prior = minima[minima <= e]
        out[i] = prior[-1] if len(prior) else 0
    return out


def rms_from_stft(s_mag: np.ndarray, n_fft: int = 2048) -> np.ndarray:
    """librosa.feature.rms(S=...): frame RMS from an STFT magnitude."""
    power = s_mag.astype(np.float64) ** 2
    # account for one-sided spectrum (DC/nyquist not doubled)
    power[1:-1] *= 2
    return np.sqrt(power.sum(axis=0)) / n_fft


def frames_to_time(frames: np.ndarray, sr: int = 16000, hop: int = 512):
    return np.asarray(frames, np.float64) * hop / sr
