"""The port's eval DSP and metrics against the JAX package's, bit for bit.

``livelyspeaker_tpu_torch/eval/{audio,metrics}.py`` are the port's own numpy
copies of the JAX package's modules: every function is held with
``np.array_equal`` (or ``==`` on Python numbers) on the same seeded inputs:
float and PCM16 ``int16`` waves, clicks, silence and a wave shorter than the
STFT's padding; f32 motions, euler tracks and semantic weights for the
metrics.
"""

import numpy as np
import pytest

from livelyspeaker_tpu.eval import audio as jaudio
from livelyspeaker_tpu.eval import metrics as jmetrics
from livelyspeaker_tpu_torch.eval import audio as taudio
from livelyspeaker_tpu_torch.eval import metrics as tmetrics

SR = 16000


def _clicks(rng, n=2 * SR):
    y = np.zeros(n, np.float32)
    for s in (0.3, 0.9, 1.4):
        j = int(s * SR)
        y[j: j + 400] += np.sin(2 * np.pi * 880 * np.arange(400) / SR).astype(np.float32)
    return y


SIGNALS = {
    "float": lambda rng: (0.1 * rng.normal(size=36267)).astype(np.float32),
    "int16": lambda rng: rng.integers(-8000, 8000, size=36267).astype(np.int16),
    "clicks": _clicks,
    "silence": lambda rng: np.zeros(SR, np.float32),
    "short": lambda rng: (0.3 * rng.normal(size=700)).astype(np.float32),
}


def _signal(name, seed=0):
    return SIGNALS[name](np.random.default_rng(seed))


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
        return True
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True)
    return True


# each case: (name, f(module, wave) -> result)
DSP_CASES = {
    "stft_mag": lambda m, y: m.stft_mag(y),
    "stft_mag_n512_hop128": lambda m, y: m.stft_mag(y, n_fft=512, hop=128),
    "melspectrogram": lambda m, y: m.melspectrogram(y),
    "power_to_db": lambda m, y: m.power_to_db(m.melspectrogram(y)),
    "power_to_db_ref1_no_top": lambda m, y: m.power_to_db(m.melspectrogram(y), ref=1.0,
                                                          top_db=None),
    "onset_strength": lambda m, y: m.onset_strength(y),
    "onset_strength_lag2": lambda m, y: m.onset_strength(y, lag=2),
    "onset_detect": lambda m, y: m.onset_detect(y, sr=SR),
    "onset_detect_time": lambda m, y: m.onset_detect(y, sr=SR, units="time"),
    "onset_detect_backtrack": lambda m, y: m.onset_detect(y, sr=SR, backtrack=True),
    "onset_detect_envelope_22050": lambda m, y: m.onset_detect(
        onset_envelope=m.onset_strength(y), sr=22050),
    "rms_from_stft": lambda m, y: m.rms_from_stft(m.stft_mag(y)),
    "onset_backtrack_rms": lambda m, y: m.onset_backtrack(
        m.onset_detect(y, sr=SR), m.rms_from_stft(m.stft_mag(y))),
}


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("case", sorted(DSP_CASES))
def test_dsp_matches_jax_bit_for_bit(case, signal):
    y = _signal(signal)
    _same(DSP_CASES[case](taudio, y), DSP_CASES[case](jaudio, y))


@pytest.mark.parametrize("args", [(16000, 2048, 128), (22050, 2048, 128), (16000, 512, 40, 50.0, 4000.0)],
                         ids=["16k", "22050", "fmin_fmax"])
def test_mel_filterbank_matches_jax(args):
    _same(taudio.mel_filterbank(*args), jaudio.mel_filterbank(*args))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peak_pick_backtrack_and_frames_to_time_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.random(200)
    kw = dict(pre_max=int(rng.integers(0, 4)), post_max=1 + int(rng.integers(0, 3)),
              pre_avg=int(rng.integers(0, 8)), post_avg=1 + int(rng.integers(0, 8)),
              delta=float(rng.random() * 0.2), wait=int(rng.integers(0, 4)))
    peaks = taudio.peak_pick(x, **kw)
    _same(peaks, jaudio.peak_pick(x, **kw))
    energy = rng.random(200)
    _same(taudio.onset_backtrack(peaks, energy), jaudio.onset_backtrack(peaks, energy))
    _same(taudio.frames_to_time(peaks, sr=22050), jaudio.frames_to_time(peaks, sr=22050))


# --- metrics -----------------------------------------------------------------

def _motions(rng, b=6, t=34):
    """[B, T, 27] mean-subtracted dir-vec motions: smooth, with a few sharp
    turns so that motion beats exist."""
    base = np.cumsum(0.05 * rng.normal(size=(b, t, 27)), axis=1)
    base[:, ::7] += 0.4 * rng.normal(size=(b, (t + 6) // 7, 27))
    return base.astype(np.float32)


def _waves(rng, b, kind):
    if kind == "int16":
        return rng.integers(-6000, 6000, size=(b, 36267)).astype(np.int16)
    return np.stack([_clicks(rng, 36267) if i % 2 else
                     (0.1 * rng.normal(size=36267)).astype(np.float32) for i in range(b)])


def test_mean_dir_vec_is_the_jax_one():
    from livelyspeaker_tpu.ops.skeleton import MEAN_DIR_VEC as jmean
    from livelyspeaker_tpu_torch.ops.skeleton import MEAN_DIR_VEC as tmean

    _same(tmean, jmean)


@pytest.mark.parametrize("thres", [0.03, 0.1])
def test_motion_beat_times_ted_match_jax(thres):
    m = _motions(np.random.default_rng(3))
    ours = tmetrics.motion_beat_times_ted(m, thres=thres)
    theirs = jmetrics.motion_beat_times_ted(m, thres=thres)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _same(a, b)


@pytest.mark.parametrize("kind", ["float", "int16"])
def test_ted_beat_align_batch_matches_jax(kind):
    rng = np.random.default_rng(4)
    m, a = _motions(rng, b=4), _waves(rng, 4, kind)
    ours, theirs = tmetrics.ted_beat_align_batch(m, a), jmetrics.ted_beat_align_batch(m, a)
    assert ours == theirs and ours[1] > 0 and ours[2] > 0


@pytest.mark.parametrize("threshold,joints", [(0.3, 47), (4.0, 47), (4.0, 9)])
def test_srgr_and_l1div_match_jax(threshold, joints):
    rng = np.random.default_rng(5)
    ours, theirs = tmetrics.SRGR(threshold, joints), jmetrics.SRGR(threshold, joints)
    l1, jl1 = tmetrics.L1Div(), jmetrics.L1Div()
    for _ in range(3):
        tar = (30 * rng.normal(size=(4, 34, joints * 3))).astype(np.float32)
        res = (tar + threshold * rng.normal(size=tar.shape) / 3).astype(np.float32)
        sem = rng.random((4, 34)).astype(np.float32)
        assert ours.run(res, tar, sem) == theirs.run(res, tar, sem)
        l1.run(res.reshape(-1, joints * 3))
        jl1.run(res.reshape(-1, joints * 3))
    assert ours.avg() == theirs.avg() and ours.counter == theirs.counter
    assert l1.avg() == jl1.avg()


@pytest.mark.parametrize("kind", ["float", "int16"])
def test_alignment_matches_jax(kind):
    rng = np.random.default_rng(6)
    waves = _waves(rng, 3, kind)
    poses = np.cumsum(rng.normal(size=(3, 34, 141)), axis=1).astype(np.float32)
    ours, theirs = tmetrics.Alignment(0.3, 2), jmetrics.Alignment(0.3, 2)
    for w, p in zip(waves, poses):
        _same(ours.audio_beats(w), theirs.audio_beats(w))
        _same(ours.motion_beats(p), theirs.motion_beats(p))
        assert ours.score(w, p, pose_fps=15) == theirs.score(w, p, pose_fps=15)
    a, b = rng.random(7), rng.random(5)
    assert tmetrics.Alignment.GAHR(a, b, 0.3) == jmetrics.Alignment.GAHR(a, b, 0.3)
    assert tmetrics.Alignment.GAHR(a, [], 0.3) == jmetrics.Alignment.GAHR(a, [], 0.3)


@pytest.mark.parametrize("t,nframes,pre", [(150, 34, 4), (34, 34, 4), (100, 20, 5)],
                         ids=["five_windows", "one_window", "other_grid"])
def test_long_form_seam_report_matches_jax(t, nframes, pre):
    motion = np.cumsum(np.random.default_rng(7).normal(size=(9, 3, t)), axis=-1)
    motion = motion.astype(np.float32)
    ours = tmetrics.long_form_seam_report(motion, nframes, pre)
    theirs = jmetrics.long_form_seam_report(motion, nframes, pre)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k] == theirs[k] or (np.isnan(ours[k]) and np.isnan(theirs[k])), k


def test_the_eval_package_exports_what_the_jax_one_does():
    import livelyspeaker_tpu.eval as jeval
    import livelyspeaker_tpu_torch.eval as teval

    names = [n for n in dir(jeval) if not n.startswith("_") and n not in ("fgd", "metrics",
                                                                          "audio")]
    assert all(hasattr(teval, n) for n in names), [n for n in names if not hasattr(teval, n)]
    assert set(tmetrics.__all__) == set(jmetrics.__all__)
    assert set(taudio.__all__) == set(jaudio.__all__)
