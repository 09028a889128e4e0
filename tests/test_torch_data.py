"""Parity of the port's data pipeline with the JAX package: the skeleton and
rotation ops, the sharded records (written by either package, read by the
other), the TED and BEAT record-building functions and window datasets, the vocab,
the BVH reader and writer, and the synthetic fixtures.

Records are compared bit for bit, apart from BEAT's rot6d field, which the
port computes in torch f32 and the JAX package in jnp f32 (atol 1e-6). The
ops are held within rel 1e-6: rel = max|port - jax| / max|jax|.
"""

import os
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.data import beat as jbeat
from livelyspeaker_tpu.data import bvh as jbvh
from livelyspeaker_tpu.data import records as jrecords
from livelyspeaker_tpu.data import synthetic as jsynth
from livelyspeaker_tpu.data import ted as jted
from livelyspeaker_tpu.data import vocab as jvocab
from livelyspeaker_tpu.ops import rotation as jrot
from livelyspeaker_tpu.ops import skeleton as jskel
from livelyspeaker_tpu_torch.data import beat as tbeat
from livelyspeaker_tpu_torch.data import bvh as tbvh
from livelyspeaker_tpu_torch.data import records as trecords
from livelyspeaker_tpu_torch.data import synthetic as tsynth
from livelyspeaker_tpu_torch.data import ted as tted
from livelyspeaker_tpu_torch.data import vocab as tvocab
from livelyspeaker_tpu_torch.ops import rotation as trot
from livelyspeaker_tpu_torch.ops import skeleton as tskel

OPS_TOL = 1e-6
ROT6D_ATOL = 1e-6


def rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def assert_same(a, b, path=""):
    """Equal bits for arrays (dtype included), equal values otherwise."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


# --- ops ---------------------------------------------------------------------

def test_skeleton_constants_are_the_same():
    assert tskel.DIR_VEC_PAIRS == jskel.DIR_VEC_PAIRS
    for name in ("MEAN_DIR_VEC", "MEAN_POSE", "_FK_A", "_BONE_LEN"):
        assert_same(getattr(tskel, name), getattr(jskel, name), name)


@pytest.mark.parametrize("fn,shape", [
    ("convert_dir_vec_to_pose", (5, 7, 9, 3)),
    ("convert_dir_vec_to_pose", (6, 27)),
    ("normalize_dir_vec", (4, 9, 3)),
    ("convert_pose_seq_to_dir_vec", (5, 7, 10, 3)),
    ("convert_pose_seq_to_dir_vec", (6, 30)),
])
def test_skeleton_ops_match_jax(fn, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    out = getattr(tskel, fn)(torch.from_numpy(x)).numpy()
    assert rel(out, getattr(jskel, fn)(jnp.asarray(x))) <= OPS_TOL


def _rotations(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q, np.array(jrot.quaternion_to_matrix(jnp.asarray(q)))


@pytest.mark.parametrize("fn,make", [
    ("quaternion_to_matrix", lambda rng: rng.normal(size=(3, 16, 4))),
    ("matrix_to_quaternion", lambda rng: _rotations(rng)[1]),
    ("axis_angle_to_quaternion", lambda rng: np.concatenate(
        [rng.normal(size=(16, 3)), 1e-8 * rng.normal(size=(4, 3))])),
    ("quaternion_to_axis_angle", lambda rng: _rotations(rng)[0]),
    ("axis_angle_to_matrix", lambda rng: rng.normal(size=(2, 16, 3))),
    ("matrix_to_axis_angle", lambda rng: _rotations(rng)[1]),
    ("rotation_6d_to_matrix", lambda rng: rng.normal(size=(4, 47, 6))),
    ("matrix_to_rotation_6d", lambda rng: _rotations(rng)[1]),
])
def test_rotation_ops_match_jax(fn, make):
    x = np.asarray(make(np.random.default_rng(1)), np.float32)
    out = getattr(trot, fn)(torch.from_numpy(x)).numpy()
    assert rel(out, getattr(jrot, fn)(jnp.asarray(x))) <= OPS_TOL


@pytest.mark.parametrize("convention", ["XYZ", "ZXY", "YZX", "XYX", "ZYZ"])
def test_euler_conversions_match_jax(convention):
    rng = np.random.default_rng(2)
    angles = rng.uniform(-1.4, 1.4, size=(8, 47, 3)).astype(np.float32)
    m = trot.euler_angles_to_matrix(torch.from_numpy(angles), convention).numpy()
    jm = np.asarray(jrot.euler_angles_to_matrix(jnp.asarray(angles), convention))
    assert rel(m, jm) <= OPS_TOL
    back = trot.matrix_to_euler_angles(torch.from_numpy(jm), convention).numpy()
    assert rel(back, jrot.matrix_to_euler_angles(jnp.asarray(jm), convention)) <= OPS_TOL


def test_beat_euler_rot6d_helpers_match_jax():
    deg = np.random.default_rng(3).uniform(-80, 80, size=(34, 47, 3)).astype(np.float32)
    r6 = tbeat.euler_deg_to_rot6d(deg)
    jr6 = jbeat.euler_deg_to_rot6d(deg)
    assert r6.dtype == jr6.dtype == np.float32
    assert np.abs(r6 - jr6).max() <= ROT6D_ATOL
    back = tbeat.rot6d_to_euler_deg(jr6)
    assert rel(back, jbeat.rot6d_to_euler_deg(jr6)) <= 1e-5  # degrees near +-80
    assert np.abs(back - deg).max() < 1e-2


# --- numpy helpers -----------------------------------------------------------

def test_ted_helpers_match_jax():
    rng = np.random.default_rng(4)
    poses = rng.normal(size=(53, 10, 3)).astype(np.float32)
    assert_same(tted.resample_pose_seq(poses, 3.5, 15), jted.resample_pose_seq(poses, 3.5, 15))
    audio = rng.uniform(-1.2, 1.2, size=5000).astype(np.float32)
    assert_same(tted.pcm16_encode(audio), jted.pcm16_encode(audio))
    assert_same(tted.pcm16_decode(jted.pcm16_encode(audio)),
                jted.pcm16_decode(jted.pcm16_encode(audio)))
    for n in (4000, 6000):
        assert_same(tted.make_audio_fixed_length(audio, n),
                    jted.make_audio_fixed_length(audio, n))
    seq = rng.normal(size=(34, 27)).astype(np.float32)
    assert_same(tted.motion_fft_lowpass(seq), jted.motion_fft_lowpass(seq))
    assert_same(tted.motion_random_resample(seq, np.random.default_rng(5)),
                jted.motion_random_resample(seq, np.random.default_rng(5)))
    assert_same(tted.convert_pose_seq_to_dir_vec_np(poses),
                jted.convert_pose_seq_to_dir_vec_np(poses))
    for window in (poses[:42], np.broadcast_to(jskel.MEAN_POSE.reshape(10, 3), (42, 10, 3))):
        assert (tted.MotionFilter(jskel.MEAN_POSE).check(window)
                == jted.MotionFilter(jskel.MEAN_POSE).check(window))


def test_vocab_matches_jax_and_reads_its_pickle(tmp_path):
    words = [["a", "b", "a"], ["c", "a", "d"], [], ["b"]]
    jv = jvocab.build_vocab("w", words, embedding_dim=4)
    tv = tvocab.build_vocab("w", words, embedding_dim=4)
    assert tv.word2index == jv.word2index and tv.index2word == jv.index2word
    assert_same(tv.word_embedding_weights, jv.word_embedding_weights)
    jv.trim(2)
    tv.trim(2)
    assert tv.word2index == jv.word2index and tv.word2count == jv.word2count
    jv.save(tmp_path / "jax.pkl")
    tv.save(tmp_path / "port.pkl")
    from_jax = tvocab.Vocab.load(tmp_path / "jax.pkl")
    assert type(from_jax) is tvocab.Vocab and from_jax.word2index == jv.word2index
    from_port = jvocab.Vocab.load(tmp_path / "port.pkl")
    assert from_port.word2index == jv.word2index and from_port.get_word_index("zz") == 3


SIMPLE_BVH = """HIERARCHY
ROOT Hips
{
  OFFSET 0.0 0.0 0.0
  CHANNELS 6 Xposition Yposition Zposition Xrotation Yrotation Zrotation
  JOINT Spine
  {
    OFFSET 0.0 10.0 0.0
    CHANNELS 3 Zrotation Xrotation Yrotation
    End Site
    {
      OFFSET 0.0 5.0 0.0
    }
  }
}
MOTION
Frames: 3
Frame Time: 0.00833333
0 0 0 1 2 3 4 5 6
0 1 0 1.1 2.1 3.1 14.1 5.1 6.1
0 0 2 1.2 2.2 3.2 4.2 25.2 6.2
"""


def test_bvh_matches_jax():
    t, j = tbvh.parse_bvh(SIMPLE_BVH), jbvh.parse_bvh(SIMPLE_BVH)
    assert t.channel_order == j.channel_order and t.root == j.root
    assert_same(t.frames, j.frames)
    assert tbvh.write_bvh(t) == jbvh.write_bvh(j)
    assert_same(tbvh.bvh_world_positions(t), jbvh.bvh_world_positions(j))
    assert t.rotation_order("Spine") == "ZXY"
    assert_same(tbeat.bvh_to_joint_channels(t, ["Spine"], target_fps=40),
                jbeat.bvh_to_joint_channels(j, ["Spine"], target_fps=40))


@pytest.mark.parametrize("name,duration", [
    ("2_scott_0_9_9", 60.0), ("2_scott_0_1_1", 60.0), ("5_x_0_65_65", 45.0),
    ("5_x_1_1_1", 400.0), ("0_57_57", 20.0)])
def test_beat_official_split_matches_jax(name, duration):
    assert tbeat.beat_official_split(name, duration) == jbeat.beat_official_split(name, duration)


# --- records -----------------------------------------------------------------

def _read_all(root):
    ds = trecords.ShardedDataset(str(root))
    jds = jrecords.ShardedDataset(str(root))
    idx = np.arange(len(ds))
    return ds, jds, idx


@pytest.mark.parametrize("shard_size", [3, 64])
def test_shard_writer_and_reader_both_ways(tmp_path, shard_size):
    rng = np.random.default_rng(6)
    rows = [dict(x=rng.normal(size=(5, 4)).astype(np.float32), i=np.int32(k),
                 a=rng.integers(-9, 9, size=(7,)).astype(np.int16), text=f"row {k}")
            for k in range(10)]
    for writer, name in ((trecords.ShardWriter, "port"), (jrecords.ShardWriter, "jax")):
        w = writer(str(tmp_path / name), shard_size=shard_size)
        for r in rows:
            w.add(**r)
        w.finish(extra_meta={"n": 10})
    assert open(tmp_path / "port" / "meta.json").read() == open(tmp_path / "jax" / "meta.json").read()
    for name in ("port", "jax"):
        ds, jds, idx = _read_all(tmp_path / name)
        order = np.random.default_rng(7).permutation(idx)
        assert_same(ds.batch(order), jds.batch(order))
        assert_same(ds.gather_field("x", order, prefix=2), jds.gather_field("x", order, prefix=2))
        assert_same(ds.gather_field("x", order, transpose_crop=3),
                    jds.gather_field("x", order, transpose_crop=3))
        assert_same(ds[7], jds[7])
        assert ds.row_shape("x") == jds.row_shape("x") == (5, 4)


@pytest.fixture(scope="module")
def ted_records(tmp_path_factory):
    """TED records of one seed built by each package: {"port": dir, "jax": dir}."""
    out = {}
    for name, build in (("port", tsynth.build_synthetic_ted_records),
                        ("jax", jsynth.build_synthetic_ted_records)):
        d = str(tmp_path_factory.mktemp(f"ted_{name}"))
        build(d, n_clips=3, clip_seconds=10, seed=11)
        out[name] = d
    return out


@pytest.fixture(scope="module")
def beat_records(tmp_path_factory):
    out = {}
    for name, build in (("port", tsynth.build_synthetic_beat_records),
                        ("jax", jsynth.build_synthetic_beat_records)):
        d = str(tmp_path_factory.mktemp(f"beat_{name}"))
        out[name] = (d, build(d, n_clips=2, clip_seconds=6, seed=12))
    return out


def test_ted_records_of_both_packages_hold_the_same_bits(ted_records):
    ds, _, idx = _read_all(ted_records["port"])
    jds = jrecords.ShardedDataset(ted_records["jax"])
    assert len(ds) == len(jds) > 0
    assert ds.meta == jds.meta
    assert_same(ds.batch(idx), jds.batch(idx))
    for sp in (tvocab.Vocab.load(os.path.join(ted_records["jax"], "speaker_model.pkl")),):
        port = tvocab.Vocab.load(os.path.join(ted_records["port"], "speaker_model.pkl"))
        assert port.word2index == sp.word2index


def test_beat_records_of_both_packages_agree(beat_records):
    (pd, n), (jd, jn) = beat_records["port"], beat_records["jax"]
    assert n == jn > 0
    ds, jds = trecords.ShardedDataset(pd), jrecords.ShardedDataset(jd)
    assert ds.meta == jds.meta
    idx = np.arange(n)
    a, b = ds.batch(idx), jds.batch(idx)
    assert np.abs(a.pop("rot6d") - b.pop("rot6d")).max() <= ROT6D_ATOL
    assert_same(a, b)


@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("fields", [None, ("motion", "audio", "vid"), ("word_ids", "sentence"),
                                    ("vec_seq", "pose_seq")])
def test_ted_window_dataset_matches_jax(ted_records, reader, fields):
    """Each package's dataset over the records the other wrote (and its own)."""
    root = ted_records["jax" if reader == "port" else "port"]
    lang = jvocab.build_vocab("w", [jsynth._WORDS])
    ds = tted.TedWindowDataset(root, lang_model=lang)
    jds = jted.TedWindowDataset(root, lang_model=lang)
    idx = np.random.default_rng(8).permutation(len(ds))[:7]
    assert_same(ds.batch(idx, fields=fields), jds.batch(idx, fields=fields))
    assert_same(ds[int(idx[0])], jds[int(idx[0])])


def test_ted_pcm16_records_match_jax(tmp_path):
    cfg = dict(audio_dtype="int16")
    tsynth.build_synthetic_ted_records(str(tmp_path / "p"), n_clips=2, seed=3,
                                       cfg=tted.TedConfig(**cfg))
    jsynth.build_synthetic_ted_records(str(tmp_path / "j"), n_clips=2, seed=3,
                                       cfg=jted.TedConfig(**cfg))
    ds = tted.TedWindowDataset(str(tmp_path / "j"), cfg=tted.TedConfig(**cfg))
    jds = jted.TedWindowDataset(str(tmp_path / "p"), cfg=jted.TedConfig(**cfg))
    idx = np.arange(len(ds))
    batch = ds.batch(idx, fields=("motion", "audio", "vid"))
    assert batch["audio"].dtype == np.int16
    assert_same(batch, jds.batch(idx, fields=("motion", "audio", "vid")))
    assert_same(ds[1], jds[1])


@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("fields", [None, ("motion", "audio", "vid", "emo")])
def test_beat_window_dataset_matches_jax(beat_records, reader, fields):
    root = beat_records["jax" if reader == "port" else "port"][0]
    ds, jds = tbeat.BeatWindowDataset(root), jbeat.BeatWindowDataset(root)
    idx = np.random.default_rng(9).permutation(len(ds))[:5]
    assert_same(ds.batch(idx, fields=fields), jds.batch(idx, fields=fields))
    assert_same(ds[int(idx[0])], jds[int(idx[0])])


@pytest.mark.parametrize("fixture", ["clips", "semantic", "semantic_beat"])
def test_synthetic_fixtures_match_jax(fixture):
    if fixture == "clips":
        args = dict(n_clips=3, clip_seconds=3.0, modes=2, mode_blind=True)
        make = lambda m: list(m.synthetic_clips(**args))
    elif fixture == "semantic":
        make = lambda m: list(m.synthetic_semantic_clips(n_clips=5, modes=3))
    else:
        make = lambda m: list(m.synthetic_semantic_beat_clips(n_clips=5, modes=3))
    for a, b in zip(make(tsynth), make(jsynth), strict=True):
        assert_same(a, b)
    s = "A person is talking: \"" + jsynth.SEMANTIC_TEMPLATES[2] + "\""
    assert tsynth.semantic_mode_of_sentence(s, 4) == jsynth.semantic_mode_of_sentence(s, 4)
    assert (tsynth.semantic_mode_of_sentence_prefix("folding the arms", 4)
            == jsynth.semantic_mode_of_sentence_prefix("folding the arms", 4))


def test_speaker_pickle_names_each_package_class(ted_records):
    """The port's speaker model pickles its own class; each reader maps it."""
    raw = open(os.path.join(ted_records["port"], "speaker_model.pkl"), "rb").read()
    assert b"livelyspeaker_tpu_torch.data.vocab" in raw
    assert isinstance(pickle.loads(raw), tvocab.Vocab)
