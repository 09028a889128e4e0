"""The native record gather of the port (``data/native.py`` over its own
``native/record_gather.cc``) against the JAX package's and numpy indexing.

Every comparison is byte for byte (``assert_array_equal`` with equal dtypes
and shapes): a gather copies bytes and computes nothing. The records are
small (a few rows a shard, so that batches span shards) and seeded with
numpy.
"""

import numpy as np
import pytest

from livelyspeaker_tpu.data import native as jnative
from livelyspeaker_tpu.data import ted as jted
from livelyspeaker_tpu_torch.data import native
from livelyspeaker_tpu_torch.data import ted as tted
from livelyspeaker_tpu_torch.data.records import ShardedDataset, ShardWriter
from livelyspeaker_tpu_torch.data.synthetic import synthetic_clips

DTYPES = [np.float32, np.int16, np.int32]
IDX = np.array([5, 0, 5, 19, 3, 3, 11])  # repeats, out of order


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(a, b)


def _src(dtype, shape=(20, 42, 27), seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-30000, 30000, size=shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def test_library_builds_from_the_ports_source_into_the_build_directory():
    assert native.available()
    lib = native.get_lib()
    so, log = native._paths()
    assert lib._name == str(so) and so.exists()
    assert so.parent.name == "_build" and so.parent.parent.name == "csrc"
    assert so.parent.parent.parent.name == "livelyspeaker_tpu_torch"
    assert native.SOURCE.parent.parent.name == "livelyspeaker_tpu_torch"
    assert native.SOURCE.read_bytes().startswith(b"// Native batch-assembly")
    assert native.build_log() == log.read_text() if log.exists() else native.build_log() == ""


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n_threads", [1, 2])
def test_gather_rows_and_prefix_match_jax_and_numpy(dtype, n_threads):
    src = _src(dtype)
    got = native.gather_rows(src, IDX, n_threads=n_threads)
    _same(got, np.ascontiguousarray(src[IDX]))
    _same(got, jnative.gather_rows(src, IDX, n_threads=n_threads))
    got = native.gather_rows_prefix(src, IDX, 34, n_threads=n_threads)
    _same(got, np.ascontiguousarray(src[IDX, :34]))
    _same(got, jnative.gather_rows_prefix(src, IDX, 34, n_threads=n_threads))
    flat = _src(dtype, (20, 36267 + 11), seed=1)  # an audio field: one prefix a row
    _same(native.gather_rows_prefix(flat, IDX, 36267, n_threads=n_threads),
          np.ascontiguousarray(flat[IDX, :36267]))


def test_transposes_match_jax_and_numpy():
    src = _src(np.float32)
    got = native.gather_rows_transpose(src, IDX)
    _same(got, np.ascontiguousarray(src[IDX].transpose(0, 2, 1)))
    _same(got, jnative.gather_rows_transpose(src, IDX))
    got = native.gather_rows_transpose_crop(src, IDX, 34)
    _same(got, np.ascontiguousarray(src[IDX, :34].transpose(0, 2, 1)))
    _same(got, jnative.gather_rows_transpose_crop(src, IDX, 34))
    with pytest.raises(ValueError, match="f32"):
        native.gather_rows_transpose_crop(src.astype(np.int32), IDX, 34)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_a_non_contiguous_source_takes_the_numpy_path(dtype, monkeypatch):
    """A strided view (every other row) is not C-contiguous: each function
    gives numpy's bytes without calling the library."""
    src = _src(dtype, (40, 42, 27))[::2]
    assert not src.flags["C_CONTIGUOUS"]

    class Refuse:
        def __getattr__(self, name):
            raise AssertionError(f"the library was called ({name}) on a strided source")

    monkeypatch.setattr(native, "_lib", Refuse())
    _same(native.gather_rows(src, IDX, n_threads=2), np.ascontiguousarray(src[IDX]))
    _same(native.gather_rows_prefix(src, IDX, 34), np.ascontiguousarray(src[IDX, :34]))
    if dtype == np.float32:
        _same(native.gather_rows_transpose(src, IDX),
              np.ascontiguousarray(src[IDX].transpose(0, 2, 1)))
        _same(native.gather_rows_transpose_crop(src, IDX, 34),
              np.ascontiguousarray(src[IDX, :34].transpose(0, 2, 1)))


@pytest.mark.parametrize("bad", [[0, 20], [-1, 3]], ids=["past-the-end", "negative"])
def test_rows_outside_the_source_raise_before_the_library_reads(bad):
    """The C loops read ``src + index * row_bytes`` unchecked: an index
    outside [0, N) or a prefix longer than a row raises first."""
    src = _src(np.float32)
    for fn in (native.gather_rows, native.gather_rows_transpose,
               lambda s, i: native.gather_rows_prefix(s, i, 34),
               lambda s, i: native.gather_rows_transpose_crop(s, i, 34)):
        with pytest.raises(IndexError, match=r"\[0, 20\)"):
            fn(src, np.array(bad))
    with pytest.raises(ValueError, match="prefix of 43"):
        native.gather_rows_prefix(src, IDX, 43)
    with pytest.raises(ValueError, match="prefix of 43"):
        native.gather_rows_transpose_crop(src, IDX, 43)


def test_batch_and_gather_field_across_shards_keep_the_order(tmp_path):
    """Shards of 4 rows: a batch whose indices span every shard, out of
    order and repeated, in the order asked, for each gather mode."""
    rng = np.random.default_rng(2)
    w = ShardWriter(str(tmp_path / "ds"), shard_size=4)
    rows = [dict(x=np.full((3,), i, np.float32), tag=f"t{i}",
                 a=rng.integers(-9, 9, size=(9,)).astype(np.int16),
                 m=rng.normal(size=(6, 5)).astype(np.float32)) for i in range(10)]
    for r in rows:
        w.add(**r)
    w.finish()
    ds = ShardedDataset(str(tmp_path / "ds"))
    order = [9, 0, 5, 3, 9, 1, 6]
    b = ds.batch(order)
    _same(b["x"], np.repeat(np.array(order, np.float32)[:, None], 3, axis=1))
    assert b["tag"] == [f"t{i}" for i in order]
    stack = lambda f: np.stack([rows[i][f] for i in order])
    _same(b["a"], stack("a"))
    _same(ds.gather_field("a", order, prefix=7), np.ascontiguousarray(stack("a")[:, :7]))
    _same(ds.gather_field("m", order, transpose_crop=4),
          np.ascontiguousarray(stack("m")[:, :4].transpose(0, 2, 1)))


@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_ted_loader_batch_equals_the_jax_packages(tmp_path, audio_dtype):
    """Synthetic TED records in shards of 5 windows, read by both packages'
    ``TedWindowDataset``: the training batch (motion through the
    transpose-crop, audio through the prefix, vid) and the vec_seq prefix,
    byte for byte, on indices that span the shards."""
    cfg = tted.TedConfig(audio_dtype=audio_dtype)
    root = str(tmp_path / "ted")
    tted.build_ted_records(cfg, synthetic_clips(n_clips=2, clip_seconds=10, seed=31), root,
                           shard_size=5)
    ds = tted.TedWindowDataset(root, cfg=cfg)
    jds = jted.TedWindowDataset(root, cfg=jted.TedConfig(audio_dtype=audio_dtype))
    assert len(ds.records.shard_names) > 2
    idx = np.random.default_rng(9).integers(0, len(ds), size=12)
    fields = ("motion", "audio", "vid", "vec_seq")
    got, ref = ds.batch(idx, fields=fields), jds.batch(idx, fields=fields)
    assert got["audio"].dtype == np.dtype(audio_dtype)
    for k in fields:
        _same(np.asarray(got[k]), np.asarray(ref[k]))
