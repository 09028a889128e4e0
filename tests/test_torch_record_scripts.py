"""Parity of the port's record building with the JAX package: the TextGrid
parser, and ``scripts/build_ted_records.py`` and
``scripts/build_beat_records.py`` of both packages run on the same raw
files (written by ``data.synthetic.write_raw_ted_clips`` and
``write_raw_beat_recordings``).

Records are compared field by field, bit for bit (dtype included), apart
from BEAT's rot6d field, which the port computes in torch f32 and the JAX
package in jnp f32 (atol 1e-6, as ``test_torch_data.py`` holds it). The
per-frame tracks, the WAV reader and the vocab pickles are compared exactly.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from livelyspeaker_tpu.data import records as jrecords
from livelyspeaker_tpu.data import textgrid as jtextgrid
from livelyspeaker_tpu_torch.data import records as trecords
from livelyspeaker_tpu_torch.data import textgrid as ttextgrid
from livelyspeaker_tpu_torch.data import vocab as tvocab
from livelyspeaker_tpu_torch.data.synthetic import write_raw_beat_recordings, write_raw_ted_clips
from livelyspeaker_tpu_torch.scripts import build_beat_records as tbeat
from livelyspeaker_tpu_torch.scripts import build_ted_records as tted

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROT6D_ATOL = 1e-6
BEAT_NAMES = ("2_scott_0_9_9", "2_scott_0_10_10", "4_lawrence_0_9_9")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: _jax_script(name) for name in ("build_ted_records", "build_beat_records")}


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    return module.main()


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


def _assert_same_records(port_dir, jax_dir, rot6d=False):
    ds, jds = trecords.ShardedDataset(port_dir), jrecords.ShardedDataset(jax_dir)
    assert len(ds) == len(jds) > 0
    assert ds.meta == jds.meta
    idx = np.arange(len(ds))
    a, b = ds.batch(idx), jds.batch(idx)
    if rot6d:
        assert np.abs(a.pop("rot6d") - b.pop("rot6d")).max() <= ROT6D_ATOL
    _assert_same(a, b)
    return len(ds)


def _assert_same_vocab(port_path, jax_path):
    port, jax_v = tvocab.Vocab.load(port_path), tvocab.Vocab.load(jax_path)
    for attr in ("name", "word2index", "index2word", "word2count", "n_words"):
        assert getattr(port, attr) == getattr(jax_v, attr), attr


# --- the TextGrid parser ------------------------------------------------------

BEAT_CLI_TG = """File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 4.0
tiers? <exists>
size = 1
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 4.0
        intervals: size = 3
        intervals [1]:
            xmin = 0.0
            xmax = 1.0
            text = ""
        intervals [2]:
            xmin = 1.0
            xmax = 2.5
            text = "hello"
        intervals [3]:
            xmin = 2.5
            xmax = 4.0
            text = "world"
"""

ESCAPES_TG = BEAT_CLI_TG.replace('"hello"', '"say ""hi"" now"').replace('"world"', '""""')

SEVERAL_TIERS_TG = BEAT_CLI_TG.replace("size = 1\n", "size = 3\n") + """    item [2]:
        class = "TextTier"
        name = "beats"
        xmin = 0
        xmax = 4.0
        points: size = 2
        points [1]:
            number = 1.5
            mark = "b1"
        points [2]:
            number = 3.0
            mark = "b2"
    item [3]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 4.0
        intervals: size = 2
        intervals [1]:
            xmin = 0
            xmax = 1.25e0
            text = "HH"
        intervals [2]:
            xmin = 1.25e0
            xmax = 4
            text = ""
"""


@pytest.mark.parametrize("text", [BEAT_CLI_TG, ESCAPES_TG, SEVERAL_TIERS_TG],
                         ids=["beat_cli", "escapes", "several_tiers_and_a_point_tier"])
def test_parse_textgrid_matches_jax(text, tmp_path):
    """Both parsers give the same tiers, from the text and from a file; the
    point tier is parsed and dropped by both."""
    path = tmp_path / "a.TextGrid"
    path.write_text(text, encoding="utf-8")
    for source in (text, str(path)):
        port, ref = ttextgrid.parse_textgrid(source), jtextgrid.parse_textgrid(source)
        assert [tuple(t.name for t in port)] == [tuple(t.name for t in ref)]
        assert [[tuple(i) for i in t.intervals] for t in port] == \
               [[tuple(i) for i in t.intervals] for t in ref]
    names = [t.name for t in ttextgrid.parse_textgrid(text)]
    assert names == (["words", "phones"] if text is SEVERAL_TIERS_TG else ["words"])
    if text is ESCAPES_TG:
        assert [i.mark for i in ttextgrid.parse_textgrid(text)[0].intervals] == \
               ["", 'say "hi" now', '"']


# --- TED ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ted_clips(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ted_raw"))
    write_raw_ted_clips(d, n_clips=3, clip_seconds=10, seed=21)
    return d


@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_build_ted_records_matches_jax(ted_clips, jax_scripts, tmp_path, monkeypatch,
                                       audio_dtype):
    argv = ["--clips_dir", ted_clips, "--audio_dtype", audio_dtype]
    n, vocab = tted.main(argv + ["--out", str(tmp_path / "port")])
    _run_jax(jax_scripts["build_ted_records"], argv + ["--out", str(tmp_path / "jax")],
             monkeypatch)
    assert _assert_same_records(str(tmp_path / "port"), str(tmp_path / "jax")) == n
    _assert_same_vocab(str(tmp_path / "port" / "speaker_model.pkl"),
                       str(tmp_path / "jax" / "speaker_model.pkl"))
    assert vocab.n_words == tvocab.Vocab.load(str(tmp_path / "port" / "speaker_model.pkl")).n_words
    audio = trecords.ShardedDataset(str(tmp_path / "port")).batch([0])["audio"]
    assert audio.dtype == np.dtype(audio_dtype)


def test_build_ted_records_refuses_as_jax(jax_scripts, tmp_path, monkeypatch):
    """The LMDB route exits with the JAX script's text where ``lmdb`` is
    missing (or, with it, where pyarrow has no ``deserialize``); neither or
    both of --clips_dir and --lmdb_dir exit too."""
    for argv in (["--lmdb_dir", str(tmp_path)], [],
                 ["--lmdb_dir", str(tmp_path), "--clips_dir", str(tmp_path)]):
        argv = argv + ["--out", str(tmp_path / "out")]
        with pytest.raises(SystemExit) as port:
            tted.main(argv)
        with pytest.raises(SystemExit) as ref:
            _run_jax(jax_scripts["build_ted_records"], argv, monkeypatch)
        assert str(port.value) == str(ref.value) and str(port.value)


# --- BEAT ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def beat_raw(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("beat_raw"))
    write_raw_beat_recordings(d, BEAT_NAMES, seconds=12, seed=31)
    return d


@pytest.mark.parametrize("route", ["built_vocab", "vocab_pkl", "int16"])
def test_build_beat_records_matches_jax(beat_raw, jax_scripts, tmp_path, monkeypatch, route):
    argv = ["--raw_dir", beat_raw, "--speakers", "2", "4", "--split", "train"]
    if route == "int16":
        argv += ["--audio_dtype", "int16"]
    if route == "vocab_pkl":
        given = tvocab.build_vocab("beat_words", [["the", "quick", "fox"], ["talk", "hands"]])
        given.save(str(tmp_path / "given.pkl"))
        argv += ["--vocab", str(tmp_path / "given.pkl")]
    n = tbeat.main(argv + ["--out", str(tmp_path / "port")])
    _run_jax(jax_scripts["build_beat_records"], argv + ["--out", str(tmp_path / "jax")],
             monkeypatch)
    assert _assert_same_records(str(tmp_path / "port"), str(tmp_path / "jax"), rot6d=True) == n
    _assert_same_vocab(str(tmp_path / "port" / "vocab.pkl"), str(tmp_path / "jax" / "vocab.pkl"))
    ds = trecords.ShardedDataset(str(tmp_path / "port"))
    b = ds.batch(np.arange(len(ds)))
    assert b["audio"].dtype == (np.int16 if route == "int16" else np.float32)
    assert (b["word_ids"] > 3).any() and (b["facial"] > 0).any()


def test_build_beat_records_other_splits_match_jax(beat_raw, jax_scripts, tmp_path,
                                                   monkeypatch):
    """A split none of the recordings is in raises in both (no windows)."""
    argv = ["--raw_dir", beat_raw, "--speakers", "2", "4", "--split", "test",
            "--out", str(tmp_path / "x")]
    with pytest.raises(Exception) as port:
        tbeat.main(argv)
    with pytest.raises(Exception) as ref:
        _run_jax(jax_scripts["build_beat_records"], argv, monkeypatch)
    assert type(port.value).__name__ == type(ref.value).__name__


def _write_wav(path, sample_width, channels, sr, seed):
    from livelyspeaker_tpu_torch.data.synthetic import _write_wav

    audio = 0.2 * np.random.default_rng(seed).normal(size=int(0.3 * sr))
    _write_wav(str(path), np.clip(audio, -0.99, 0.99), sr, sample_width, channels)


@pytest.mark.parametrize("sample_width,channels,sr", [
    (1, 1, 16000), (2, 1, 16000), (4, 1, 16000), (2, 2, 16000), (2, 1, 44100), (4, 2, 48000)])
def test_load_wav_16k_matches_jax(jax_scripts, tmp_path, sample_width, channels, sr):
    path = tmp_path / "a.wav"
    _write_wav(path, sample_width, channels, sr, seed=sample_width + channels)
    port = tbeat.load_wav_16k(str(path))
    ref = jax_scripts["build_beat_records"].load_wav_16k(str(path))
    _assert_same(port, ref)
    assert port.dtype == np.float32 and abs(len(port) - 0.3 * 16000) <= 1
    np.save(tmp_path / "a.npy", ref)
    _assert_same(tbeat.load_wav_16k(str(tmp_path / "a.npy")),
                 jax_scripts["build_beat_records"].load_wav_16k(str(tmp_path / "a.npy")))


def test_per_frame_tracks_match_jax(beat_raw, jax_scripts):
    jb = jax_scripts["build_beat_records"]
    stem = os.path.join(beat_raw, "2", BEAT_NAMES[0])
    n, fps = 180, 15
    words, ref_words = tbeat.read_words(stem + ".TextGrid"), jb.read_words(stem + ".TextGrid")
    assert words == ref_words and any(w == "" for w, _, _ in words)
    vocab = tvocab.build_vocab("beat_words", [[w for w, _, _ in words if w]])
    _assert_same(tbeat.word_ids_track(words, vocab, n, fps),
                 jb.word_ids_track(ref_words, vocab, n, fps))
    _assert_same(tbeat.read_emo_csv(stem + ".csv", n, fps), jb.read_emo_csv(stem + ".csv", n, fps))
    _assert_same(tbeat.read_sem_txt(stem + ".txt", n, fps), jb.read_sem_txt(stem + ".txt", n, fps))
    for frames in (n, 1000):  # cut, and padded at the edge
        _assert_same(tbeat.read_facial(stem + ".json", frames, fps),
                     jb.read_facial(stem + ".json", frames, fps))
