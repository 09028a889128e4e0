"""Synthetic TED-like clips for tests, smoke training and benchmarks.

Port of ``livelyspeaker_tpu/data/synthetic.py`` (numpy; the same seeds give
the same records). Generates kinematically-plausible skeletons (mean pose + smooth band-limited
arm motion, constant bone lengths) with matching 16 kHz audio and word
timings, then routes them through the *real* offline pipeline
(ted.build_ted_records), so windowing, filtering and dir-vec conversion run
exactly as they would on real TED data.

The port also writes raw inputs of the record-building scripts:
:func:`write_raw_ted_clips` (the per-clip npz files of
``scripts/build_ted_records.py --clips_dir``) and
:func:`write_raw_beat_recordings` (a raw BEAT directory for
``scripts/build_beat_records.py --raw_dir``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import wave
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np

from .ted import TedConfig, build_ted_records
from ..ops.skeleton import DIR_VEC_PAIRS, MEAN_DIR_VEC

__all__ = [
    "build_once",
    "synthetic_clips",
    "write_raw_ted_clips",
    "write_raw_beat_recordings",
    "build_synthetic_ted_records",
    "SEMANTIC_TEMPLATES",
    "synthetic_semantic_clips",
    "build_semantic_ted_records",
    "semantic_mode_of_sentence",
    "BEAT_SEM_ONSET",
    "semantic_mode_of_sentence_prefix",
    "synthetic_semantic_beat_clips",
    "build_semantic_beat_records",
]

_WORDS = (
    "the quick brown fox jumps over lazy dog people talk about ideas "
    "gesture motion speech rhythm semantic generation model hands arms"
).split()


def build_once(name: str, build: Callable[[str], object]) -> str:
    """Records under the temporary directory's ``name``, built once by
    ``build(dir)``: a build goes to a directory of its own and is renamed
    into place, so concurrent runs never read a half-written set."""
    d = os.path.join(tempfile.gettempdir(), name)
    if not os.path.exists(os.path.join(d, "meta.json")):
        tmp = tempfile.mkdtemp(prefix=name + ".")
        build(tmp)
        try:
            os.rename(tmp, d)
        except OSError:  # another run put its copy there first
            shutil.rmtree(tmp, ignore_errors=True)
    return d


def _smooth_noise(rng: np.random.Generator, n: int, dims: int, fps: int) -> np.ndarray:
    """Band-limited noise: random low-frequency Fourier components."""
    freqs = np.fft.rfftfreq(n, d=1.0 / fps)
    spec = rng.normal(size=(len(freqs), dims)) + 1j * rng.normal(
        size=(len(freqs), dims)
    )
    spec[freqs > 2.0] = 0  # keep <= 2 Hz components (gesture band)
    out = np.fft.irfft(spec, n=n, axis=0).real
    out /= max(np.abs(out).max(), 1e-6)
    return out


def _skeleton_from_dir_vecs(dir_vecs: np.ndarray) -> np.ndarray:
    """FK on [T, 9, 3] unit vectors -> [T, 10, 3] joints (numpy)."""
    t = dir_vecs.shape[0]
    joints = np.zeros((t, 10, 3), np.float64)
    for b, (parent, child, length) in enumerate(DIR_VEC_PAIRS):
        joints[:, child] = joints[:, parent] + length * dir_vecs[:, b]
    return joints


def synthetic_clips(
    n_clips: int = 4,
    clip_seconds: float = 12.0,
    native_fps: int = 20,
    n_speakers: int = 4,
    seed: int = 233,
    modes: int = 0,
    mode_blind: bool = False,
) -> Iterable[Dict]:
    """With ``modes=K>0`` the motion distribution is conditionally
    MULTIMODAL: each clip follows one of K fixed sinusoid archetypes (cycled
    per clip, independent of audio/speaker), plus small per-clip noise.
    The conditioning cannot identify the archetype, so p(motion | cond) has
    K distinct modes — the regime where few-step deterministic samplers
    degrade by averaging modes (used by the distillation quality study).

    ``mode_blind=True`` additionally removes two side channels that let a
    memorising model identify the archetype without reading x_t (the same
    leaks the semantic fixture closed, see :func:`synthetic_semantic_clips`):
    unique per-clip audio becomes a shared pool paired orthogonally to the
    mode (stream (c//modes) % n, so every stream co-occurs with every mode),
    and the speaker id — which with the default n_speakers == modes cycling
    equals ``c % modes``, i.e. the mode itself — is drawn from ``c //
    modes`` instead.  Default False preserves the historical fixtures
    byte-for-byte."""
    rng = np.random.default_rng(seed)
    mean_dv = MEAN_DIR_VEC.reshape(9, 3)
    audio_pool: List[np.ndarray] = []
    if mode_blind:
        arng = np.random.default_rng(seed + 5000)
        n_audio = int(clip_seconds * 16000)
        tg_a = np.linspace(0, clip_seconds, n_audio, endpoint=False)
        am = (0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * tg_a)).astype(np.float32)
        audio_pool = [
            (0.1 * arng.normal(size=n_audio)).astype(np.float32) * am
            for _ in range(max(n_speakers, 2))
        ]
    for c in range(n_clips):
        n_frames = int(clip_seconds * native_fps)
        # Perturb the mean direction vectors smoothly, renormalise.
        wob = _smooth_noise(rng, n_frames, 27, native_fps).reshape(
            n_frames, 9, 3
        )
        if modes:
            mrng = np.random.default_rng(1000 + c % modes)
            f = mrng.uniform(0.3, 1.8, size=27)
            ph = mrng.uniform(0, 2 * np.pi, size=27)
            amp = mrng.uniform(0.5, 1.0, size=27)
            tg = (np.arange(n_frames) / native_fps)[:, None]
            arch = (amp[None] * np.sin(2 * np.pi * f[None] * tg + ph[None]))
            wob = 0.85 * arch.reshape(n_frames, 9, 3) + 0.15 * wob
        dv = mean_dv[None] + 0.35 * wob
        dv /= np.maximum(np.linalg.norm(dv, axis=-1, keepdims=True), 1e-9)
        skeletons = _skeleton_from_dir_vecs(dv)

        if mode_blind:
            audio = audio_pool[(c // max(modes, 1)) % len(audio_pool)]
        else:
            audio = (
                0.1 * rng.normal(size=int(clip_seconds * 16000))
            ).astype(np.float32)
            # speech-ish amplitude modulation
            tgrid = np.linspace(0, clip_seconds, len(audio), endpoint=False)
            audio *= (
                0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * tgrid)
            ).astype(np.float32)

        words: List = []
        t0 = 0.2
        while t0 < clip_seconds - 0.5:
            dur = float(rng.uniform(0.15, 0.5))
            words.append([str(rng.choice(_WORDS)), t0, t0 + dur])
            t0 += dur + float(rng.uniform(0.02, 0.2))

        spk = (c // max(modes, 1)) if mode_blind else c
        yield {
            "vid": f"speaker_{spk % n_speakers:03d}",
            "skeletons": skeletons,
            "audio": audio,
            "words": words,
            "start_time": 0.0,
            "end_time": clip_seconds,
        }


def build_synthetic_beat_records(
    out_dir: str,
    n_clips: int = 4,
    clip_seconds: float = 16.0,
    seed: int = 233,
    cfg=None,
):
    """Synthetic BEAT-like clips (smooth euler tracks, audio, per-frame
    emotion/semantic labels) through the real BEAT record pipeline."""
    from .beat import BeatConfig, build_beat_records

    rng = np.random.default_rng(seed)
    cfg = cfg or BeatConfig()
    vocab = ("hello", "world", "this", "is", "a", "test", "gesture", "talk")
    clips = []
    for c in range(n_clips):
        t = int(clip_seconds * cfg.pose_fps)
        euler = 25.0 * _smooth_noise(rng, t, 141, cfg.pose_fps)
        audio = (0.1 * rng.normal(size=int(clip_seconds * cfg.sr))).astype(
            np.float32
        )
        # Timed [word, start_s, end_s] triples so windows carry sentences
        # for the SAG composition (beat.py:548-568 semantics).
        words = [
            [vocab[i % len(vocab)], 0.5 * i, 0.5 * i + 0.45]
            for i in range(int(clip_seconds * 2))
        ]
        clips.append(
            {
                "vid": int(cfg.speakers[c % len(cfg.speakers)]),
                "euler141": euler.astype(np.float32),
                "audio": audio,
                "emo": rng.integers(0, 8, size=t),
                "sem": rng.uniform(0, 1, size=t).astype(np.float32),
                "words": words,
            }
        )
    return build_beat_records(cfg, clips, out_dir)


def build_synthetic_ted_records(
    out_dir: str,
    n_clips: int = 4,
    clip_seconds: float = 12.0,
    seed: int = 233,
    cfg: TedConfig | None = None,
    modes: int = 0,
    mode_blind: bool = False,
):
    cfg = cfg or TedConfig()
    n, vocab = build_ted_records(
        cfg,
        synthetic_clips(
            n_clips=n_clips, clip_seconds=clip_seconds, seed=seed,
            modes=modes, mode_blind=mode_blind,
        ),
        out_dir,
        disable_filtering=False,
    )
    return n, vocab


# --- semantic-payoff fixture -------------------------------------------------
#
# The reference's defining claim is that the SAG text sketch + skip=80 RAG
# refinement IMPROVES on RAG alone (test_LivelySpeaker_ted.py:102-113,
# 212-221).  Proving that needs a fixture where text carries motion signal
# that nothing else carries: the `modes=K` fixture above fails for this
# because the eval protocol conditions the denoiser on the window's first
# 4 REAL frames, which identify the archetype (docs/DESIGN.md §9).
# Here every clip is exactly ONE window whose first ~8 frames follow a
# mode-independent base — the seeds and the audio are mode-blind by
# construction, and the sentence template is the ONLY mode-identifying
# signal.  Used by scripts/measure_semantic_payoff.py.

SEMANTIC_TEMPLATES = (
    "waving both hands high in the air",
    "pointing firmly to the left side",
    "folding the arms across the chest",
    "spreading the palms wide open outward",
    "raising one hand slowly above the head",
    "chopping downward with a flat hand",
    "circling the wrists in front of the body",
    "shrugging the shoulders with open hands",
)


def semantic_mode_of_sentence(sentence: str, modes: int) -> int:
    """Recover the archetype index from a dataset sentence (the window's
    sentence embeds the template verbatim)."""
    for k in range(modes):
        if SEMANTIC_TEMPLATES[k] in sentence:
            return k
    raise ValueError(f"no template in: {sentence!r}")


def synthetic_semantic_clips(
    n_clips: int = 32,
    modes: int = 4,
    seed: int = 233,
    n_speakers: int = 4,
    native_fps: int = 20,
    clip_seconds: float = 3.0,
    audio_pool: int = 8,
) -> Iterable[Dict]:
    """Text-identifies-motion clips: one 42-frame window per clip.

    Per clip with archetype ``k = c % modes``:
      * frames < 8 (at the 15 fps target): mode-independent smooth base —
        the eval protocol's 4 seed frames carry NO mode information;
      * frames 8-12 ramp in a fixed per-mode sinusoid archetype
        (rng 2000+k: frequencies/phases/amps over the 27 dir-vec dims);
      * audio: drawn from a SHARED ``audio_pool``-stream pool paired
        orthogonally to the mode (clip c uses stream (c//modes) %
        audio_pool, so every stream co-occurs with every mode).  Unique
        per-clip audio would let a small-scale model memorise
        audio -> x0 and never learn to read x_t — measured in the JAX package:
        with unique audio the trained denoiser's x0 prediction ignored
        REAL mode content in x_t (recall 0.297 ~ chance) and the skip=80
        refinement erased the SAG sketch; the pool makes p(x0 | cond)
        genuinely K-modal for memorisers too;
      * speaker: drawn independently of the mode;
      * words: the mode's SEMANTIC_TEMPLATES sentence, timed across the
        clip (>= 2 words per window, the dataset's filter threshold).
    """
    assert modes <= len(SEMANTIC_TEMPLATES), (modes, len(SEMANTIC_TEMPLATES))
    rng = np.random.default_rng(seed)
    mean_dv = MEAN_DIR_VEC.reshape(9, 3)
    arng = np.random.default_rng(seed + 5000)
    n_audio_samples = int(clip_seconds * 16000)
    ts = np.linspace(0, clip_seconds, n_audio_samples, endpoint=False)
    am = (0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * ts)).astype(np.float32)
    pool = [
        (0.1 * arng.normal(size=n_audio_samples)).astype(np.float32) * am
        for _ in range(max(audio_pool, 1))
    ]
    n_frames = int(clip_seconds * native_fps)
    wrng = np.random.default_rng(seed + 7000)
    wob_pool = [
        _smooth_noise(wrng, n_frames, 27, native_fps).reshape(n_frames, 9, 3)
        for _ in range(max(audio_pool, 1))
    ]
    for c in range(n_clips):
        k = c % modes
        tg = (np.arange(n_frames) / native_fps)[:, None]  # seconds
        # The seed frames show only the base wobble; draw its DOMINANT part
        # from the same orthogonally-paired pool as the audio (a unique
        # wobble would let the seeds identify the training clip — the same
        # memorisation leak as unique audio), keeping a small unique
        # residual so clips aren't exact duplicates.
        wob = (
            0.75 * wob_pool[(c // modes) % len(wob_pool)]
            + 0.25
            * _smooth_noise(rng, n_frames, 27, native_fps).reshape(
                n_frames, 9, 3
            )
        )
        mrng = np.random.default_rng(2000 + k)
        f = mrng.uniform(0.3, 1.5, size=27)
        ph = mrng.uniform(0, 2 * np.pi, size=27)
        amp = mrng.uniform(0.6, 1.0, size=27)
        arch = amp[None] * np.sin(2 * np.pi * f[None] * tg + ph[None])
        # zero until 15fps-frame 8 (0.53 s), fully in by frame 12
        onset = np.clip((tg * 15.0 - 8.0) / 4.0, 0.0, 1.0)
        sig = (onset * arch).reshape(n_frames, 9, 3)
        dv = mean_dv[None] + 0.35 * (0.85 * sig + 0.25 * wob)
        dv /= np.maximum(np.linalg.norm(dv, axis=-1, keepdims=True), 1e-9)
        skeletons = _skeleton_from_dir_vecs(dv)

        audio = pool[(c // modes) % len(pool)]

        words: List = []
        t0 = 0.15
        template = SEMANTIC_TEMPLATES[k].split()
        i = 0
        while t0 < clip_seconds - 0.4:
            dur = 0.25
            words.append([template[i % len(template)], t0, t0 + dur])
            t0 += dur + 0.1
            i += 1

        yield {
            "vid": f"speaker_{int(rng.integers(0, n_speakers)):03d}",
            "skeletons": skeletons,
            "audio": audio,
            "words": words,
            "start_time": 0.0,
            "end_time": clip_seconds,
        }


def build_semantic_ted_records(
    out_dir: str,
    n_clips: int = 32,
    modes: int = 4,
    seed: int = 233,
    cfg: TedConfig | None = None,
    audio_pool: int = 8,
):
    cfg = cfg or TedConfig()
    n, vocab = build_ted_records(
        cfg,
        synthetic_semantic_clips(
            n_clips=n_clips, modes=modes, seed=seed, audio_pool=audio_pool
        ),
        out_dir,
        # deterministic window count: one window per clip, never filtered
        disable_filtering=True,
    )
    return n, vocab


def semantic_mode_of_sentence_prefix(sentence: str, modes: int) -> int:
    """Mode matcher tolerant of clip-truncated sentences: the fixture's
    sentence is the template cycled from word 0, so the archetype is
    identified by the longest word-prefix agreement (template first words
    are pairwise distinct, so even one word decides)."""
    toks = sentence.split()
    best, best_n = None, -1
    for k in range(modes):
        tpl = SEMANTIC_TEMPLATES[k].split()
        n = 0
        while n < len(toks) and tpl[n % len(tpl)] == toks[n]:
            n += 1
        if n > best_n:
            best, best_n = k, n
    if best_n <= 0:
        raise ValueError(f"no template prefix in: {sentence!r}")
    return best


# --- BEAT semantic fixture --------------------------------------------------
#: Frame (at 15 fps) where the BEAT archetype signal STARTS ramping in:
#: onset weight is 0 at this frame and reaches 1 four frames later, at
#: BEAT_SEM_ONSET + 4.  Frames < BEAT_SEM_ONSET (seed frames included) are
#: fully mode-blind; the per-frame `sem` track flips to 0.9 from
#: BEAT_SEM_ONSET + 1 (the first frame with nonzero archetype weight), so
#: SRGR (scripts_beat/utils/metric.py:27-51) weighs the signal-carrying
#: frames, the metric's design intent.
BEAT_SEM_ONSET = 12


def synthetic_semantic_beat_clips(
    n_clips: int = 32,
    modes: int = 4,
    seed: int = 233,
    audio_pool: int = 8,
    cfg=None,
) -> Iterable[Dict]:
    """BEAT twin of :func:`synthetic_semantic_clips`: text identifies the
    motion archetype, every other conditioning channel is mode-blind.

    One ``pose_length``-frame window per clip with archetype ``k = c % modes``
    in 141-d euler-degree space:
      * frames < BEAT_SEM_ONSET: shared-pool smooth wobble only (the eval
        protocol's 4 seed frames carry NO mode information);
      * frames BEAT_SEM_ONSET..+4: a fixed per-mode sinusoid archetype
        (rng 3000+k over the 141 euler dims, 12-25 deg amplitude) ramps in —
        large vs the 3 deg wobble so the SRGR threshold (sum-|euler-diff| <
        4 deg per joint, metric.py:40-44) separates right-mode from
        wrong-mode generations;
      * `sem`: 0.05 before the onset, 0.9 after — the semantic frames;
      * audio / dominant wobble: shared ``audio_pool`` streams paired
        orthogonally to the mode (anti-memorisation, see the TED fixture);
      * speaker (vid in {2,4,6,8}) and emotion (0..7) cycle with the pool
        group, independent of the mode;
      * words: the mode's SEMANTIC_TEMPLATES sentence, timed.
    """
    from .beat import BeatConfig

    cfg = cfg or BeatConfig()
    assert modes <= len(SEMANTIC_TEMPLATES), (modes, len(SEMANTIC_TEMPLATES))
    rng = np.random.default_rng(seed)
    n_frames = cfg.pose_length
    clip_seconds = n_frames / cfg.pose_fps
    n_audio = int(np.ceil(clip_seconds * cfg.sr))
    arng = np.random.default_rng(seed + 5000)
    ts = np.linspace(0, clip_seconds, n_audio, endpoint=False)
    am = (0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * ts)).astype(np.float32)
    pool = [
        (0.1 * arng.normal(size=n_audio)).astype(np.float32) * am
        for _ in range(max(audio_pool, 1))
    ]
    wrng = np.random.default_rng(seed + 7000)
    wob_pool = [
        _smooth_noise(wrng, n_frames, cfg.pose_dims, cfg.pose_fps)
        for _ in range(max(audio_pool, 1))
    ]
    tg = (np.arange(n_frames) / cfg.pose_fps)[:, None]  # seconds
    onset = np.clip((np.arange(n_frames) - BEAT_SEM_ONSET) / 4.0, 0.0, 1.0)
    sem = np.where(onset > 0, 0.9, 0.05).astype(np.float32)
    for c in range(n_clips):
        k = c % modes
        group = c // modes
        wob = (
            0.75 * wob_pool[group % len(wob_pool)]
            + 0.25 * _smooth_noise(rng, n_frames, cfg.pose_dims, cfg.pose_fps)
        )
        mrng = np.random.default_rng(3000 + k)
        f = mrng.uniform(0.3, 1.2, size=cfg.pose_dims)
        ph = mrng.uniform(0, 2 * np.pi, size=cfg.pose_dims)
        amp = mrng.uniform(12.0, 25.0, size=cfg.pose_dims)
        arch = amp[None] * np.sin(2 * np.pi * f[None] * tg + ph[None])
        euler = (3.0 * wob + onset[:, None] * arch).astype(np.float32)

        # Faster cadence than the TED fixture: the 2.27 s clip must fit
        # enough of the template for the window sentence to identify the
        # mode (semantic_mode_of_sentence_prefix matches word prefixes;
        # template FIRST words are pairwise distinct).
        words: List = []
        t0 = 0.15
        template = SEMANTIC_TEMPLATES[k].split()
        i = 0
        while t0 < clip_seconds - 0.3:
            dur = 0.2
            words.append([template[i % len(template)], t0, t0 + dur])
            t0 += dur + 0.05
            i += 1

        yield {
            "vid": int(cfg.speakers[group % len(cfg.speakers)]),
            "euler141": euler,
            "audio": pool[group % len(pool)],
            "emo": np.full(n_frames, group % 8, np.int64),
            "sem": sem,
            "words": words,
        }


def build_semantic_beat_records(
    out_dir: str,
    n_clips: int = 32,
    modes: int = 4,
    seed: int = 233,
    audio_pool: int = 8,
    cfg=None,
) -> int:
    from .beat import BeatConfig, build_beat_records

    cfg = cfg or BeatConfig()
    return build_beat_records(
        cfg,
        synthetic_semantic_beat_clips(
            n_clips=n_clips, modes=modes, seed=seed, audio_pool=audio_pool,
            cfg=cfg,
        ),
        out_dir,
    )


def write_raw_ted_clips(out_dir: str, n_clips: int = 4, clip_seconds: float = 12.0,
                        seed: int = 233) -> List[str]:
    """:func:`synthetic_clips` as ``clip_{i:05d}.npz`` files in ``out_dir``,
    each with ``vid``, ``skeletons``, ``audio``, ``words`` (an object array
    of [word, start, end]), ``start_time`` and ``end_time``; returns the
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, clip in enumerate(synthetic_clips(n_clips=n_clips, clip_seconds=clip_seconds,
                                             seed=seed)):
        path = os.path.join(out_dir, f"clip_{i:05d}.npz")
        words = np.empty(len(clip["words"]), dtype=object)
        words[:] = [list(w) for w in clip["words"]]
        np.savez(path, vid=clip["vid"], skeletons=clip["skeletons"], audio=clip["audio"],
                 words=words, start_time=clip["start_time"], end_time=clip["end_time"])
        paths.append(path)
    return paths


def _textgrid_text(words: Sequence, seconds: float) -> str:
    """A long-format TextGrid with one interval tier of ``words`` (marks
    with a double quote are written with Praat's doubled quotes)."""
    items = "".join(
        f"        intervals [{i + 1}]:\n            xmin = {s!r}\n            xmax = {e!r}\n"
        f'            text = "{w.replace(chr(34), chr(34) * 2)}"\n'
        for i, (w, s, e) in enumerate(words))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
            f"xmax = {seconds!r}\ntiers? <exists>\nsize = 1\nitem []:\n    item [1]:\n"
            f'        class = "IntervalTier"\n        name = "words"\n        xmin = 0\n'
            f"        xmax = {seconds!r}\n        intervals: size = {len(words)}\n" + items)


def _write_wav(path: str, audio: np.ndarray, sr: int, sample_width: int, channels: int) -> None:
    if sample_width == 1:
        pcm = np.clip(np.round(audio * 128.0 + 128.0), 0, 255).astype(np.uint8)
    elif sample_width == 2:
        pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    else:
        pcm = np.round(audio.astype(np.float64) * 2147483647.0).astype(np.int32)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sample_width)
        w.setframerate(sr)
        w.writeframes(np.repeat(pcm, channels).tobytes())


def write_raw_beat_recordings(root: str, names: Sequence[str], seconds: float = 12.0,
                              seed: int = 233, bvh_fps: int = 120, sr: int = 16000,
                              sample_width: int = 2, channels: int = 1) -> List[str]:
    """A raw BEAT directory (``<root>/<speaker>/<name>.*``) for each name
    (``<speaker>_<alias>_<r0>_<r1>_<r2>``): a ``.bvh`` of the 47-joint chain
    (Hips, then the 46 joints of the 141-channel projection) at ``bvh_fps``,
    a ``.wav`` at ``sr`` of ``sample_width`` bytes and ``channels``
    channels, a ``.TextGrid`` of timed words with silent gaps, an emotion
    ``.csv``, a semantic ``.txt`` and the facial ``.json`` at 60 fps; each
    from ``seed`` and the name's position. Returns the name stems."""
    from .beat import SPINE_NECK_141_JOINTS
    from .bvh import BvhData, BvhJoint, write_bvh

    stems = []
    for k, name in enumerate(names):
        rng = np.random.default_rng(seed + k)
        sdir = os.path.join(root, name.split("_")[0])
        os.makedirs(sdir, exist_ok=True)
        stem = os.path.join(sdir, name)
        joints = {"Hips": BvhJoint("Hips", None, (0, 0, 0),
                                   ["Xposition", "Yposition", "Zposition",
                                    "Xrotation", "Yrotation", "Zrotation"], [])}
        order = [("Hips", c) for c in joints["Hips"].channels]
        prev = "Hips"
        for jn in SPINE_NECK_141_JOINTS:
            joints[jn] = BvhJoint(jn, prev, (0, 1, 0), ["Xrotation", "Yrotation", "Zrotation"], [])
            joints[prev].children.append(jn)
            order += [(jn, c) for c in joints[jn].channels]
            prev = jn
        t = int(seconds * bvh_fps)
        frames = 20.0 * _smooth_noise(rng, t, len(order), bvh_fps).astype(np.float64)
        write_bvh(BvhData(joints, "Hips", 1.0 / bvh_fps, frames, order), stem + ".bvh")

        audio = 0.1 * rng.normal(size=int(seconds * sr))
        _write_wav(stem + ".wav", audio, sr, sample_width, channels)

        words, t0 = [], 0.0
        while t0 < seconds - 0.6:
            dur = float(np.round(rng.uniform(0.15, 0.5), 3))
            gap = float(np.round(rng.uniform(0.0, 0.3), 3))
            if gap > 0.05:
                words.append(("", t0, t0 + gap))
                t0 += gap
            word = str(rng.choice(_WORDS))
            words.append((f'"{word}"' if rng.random() < 0.05 else word, t0, t0 + dur))
            t0 += dur
        words.append(("", t0, float(seconds)))
        with open(stem + ".TextGrid", "w", encoding="utf-8") as f:
            f.write(_textgrid_text(words, float(seconds)))

        cuts = np.sort(rng.uniform(0, seconds, size=3))
        spans = list(zip(np.r_[0.0, cuts], np.r_[cuts, seconds]))
        with open(stem + ".csv", "w") as f:
            f.writelines(f"emo{i},{s:.3f},{e:.3f},{e - s:.3f},{int(rng.integers(0, 8))}\n"
                         for i, (s, e) in enumerate(spans))
        with open(stem + ".txt", "w") as f:
            f.writelines(f"sem\t{s:.3f}\t{e:.3f}\t{e - s:.3f}\t{rng.uniform():.3f}\t{w}\n"
                         for w, s, e in words if w)
        n_face = int(seconds * 60)
        weights = np.round(rng.uniform(0, 1, size=(n_face, 52)), 4)
        with open(stem + ".json", "w") as f:
            json.dump({"names": [f"bs{i}" for i in range(52)],
                       "frames": [{"time": i / 60.0, "weights": weights[i].tolist()}
                                  for i in range(n_face)]}, f)
        stems.append(stem)
    return stems
