"""Parity of the port's loaders with the JAX package's: the same index
stream and batch contents for the same (seed, epoch, start_batch, host_id,
num_hosts), bit for bit, from the streaming ``DataLoader`` on the host and on
``device="cpu"``, and from ``DeviceDataLoader`` on ``device="cpu"``.
The pinned-buffer route to the card is held against the CPU route by
``tests/test_torch_cuda.py::test_pinned_loader_delivers_the_cpu_bits``.
"""

import threading

import numpy as np
import pytest
import torch

from livelyspeaker_tpu.data import loader as jloader
from livelyspeaker_tpu.data import ted as jted
from livelyspeaker_tpu_torch.data import DataLoader, DeviceDataLoader, TedWindowDataset
from livelyspeaker_tpu_torch.data.loader import epoch_indices
from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records

FIELDS = ("motion", "audio", "vid")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ted"))
    n, _ = build_synthetic_ted_records(root, n_clips=3, clip_seconds=10, seed=21)
    return root, n


def as_numpy(batch):
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if not isinstance(v, list) else v for k, v in batch.items()}


def assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        a, b = as_numpy(a), as_numpy(b)
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], list):
                assert a[k] == b[k], k
            else:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed,epoch,start_batch,host_id,num_hosts", [
    (233, 0, 0, 0, 1), (5, 3, 0, 0, 1), (5, 3, 2, 0, 1), (7, 1, 0, 1, 2), (7, 2, 1, 0, 3)])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_streaming_loader_matches_jax(records, seed, epoch, start_batch, host_id, num_hosts,
                                      device):
    root, _ = records
    kw = dict(batch_size=3, shuffle=True, seed=seed, host_id=host_id, num_hosts=num_hosts,
              fields=FIELDS)
    ours = DataLoader(TedWindowDataset(root), device=device, **kw)
    theirs = jloader.DataLoader(jted.TedWindowDataset(root), **kw)
    assert len(ours) == len(theirs)
    ours.set_epoch(epoch, start_batch)
    theirs.set_epoch(epoch, start_batch)
    assert_batches_equal(ours, theirs)
    # the next epoch continues the counter on both sides
    assert_batches_equal(ours, theirs)


def test_streaming_loader_without_fields_or_drop_last_matches_jax(records):
    root, n = records
    kw = dict(batch_size=4, shuffle=False, drop_last=False)
    ours = DataLoader(TedWindowDataset(root), **kw)
    theirs = jloader.DataLoader(jted.TedWindowDataset(root), **kw)
    assert len(ours) == len(theirs) == -(-n // 4)
    assert_batches_equal(ours, theirs)


def test_collate_runs_on_the_host_batch(records):
    root, _ = records
    collate = lambda b: {"motion2": b["motion"] * 2}
    ours = DataLoader(TedWindowDataset(root), 4, fields=("motion",), collate=collate,
                      device="cpu")
    theirs = jloader.DataLoader(jted.TedWindowDataset(root), 4, fields=("motion",),
                                collate=collate)
    assert_batches_equal(ours, theirs)


@pytest.mark.parametrize("epoch,start_batch", [(0, 0), (2, 1)])
def test_device_resident_loader_matches_streaming_and_jax(records, epoch, start_batch):
    root, _ = records
    ds = TedWindowDataset(root)
    resident = DeviceDataLoader(ds, 3, seed=9, fields=FIELDS, device="cpu")
    stream = DataLoader(ds, 3, seed=9, fields=FIELDS)
    theirs = jloader.DeviceDataLoader(jted.TedWindowDataset(root), 3, seed=9, fields=FIELDS)
    assert len(resident) == len(stream) == len(theirs)
    for loader in (resident, stream, theirs):
        loader.set_epoch(epoch, start_batch)
    first = list(resident)
    assert all(v.device.type == "cpu" for b in first for v in b.values())
    assert_batches_equal(first, stream)
    resident.set_epoch(epoch, start_batch)
    assert_batches_equal(resident, theirs)


def test_device_resident_loader_keeps_every_array_field(records):
    root, n = records
    resident = DeviceDataLoader(TedWindowDataset(root), 4, shuffle=False, device="cpu")
    theirs = jloader.DeviceDataLoader(jted.TedWindowDataset(root), 4, shuffle=False)
    assert resident.nbytes > 0
    assert_batches_equal(resident, theirs)


def test_device_resident_loader_needs_a_card_by_default(records):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        DeviceDataLoader(TedWindowDataset(records[0]), 4)


def test_epoch_indices_are_the_jax_stream():
    for n, seed, epoch, host, hosts in ((10, 1, 0, 0, 1), (11, 2, 5, 1, 2), (7, 3, 1, 2, 3)):
        dl = jloader.DataLoader(list(range(n)), 2, seed=seed, host_id=host, num_hosts=hosts)
        dl.epoch = epoch
        assert np.array_equal(epoch_indices(n, seed, epoch, True, host, hosts),
                              dl._epoch_indices())


def test_abandoned_iterator_stops_its_producer(records):
    root, _ = records
    dl = DataLoader(TedWindowDataset(root), 1, fields=FIELDS, device="cpu", prefetch=1)
    before = set(threading.enumerate())
    it = iter(dl)
    next(it)
    started = set(threading.enumerate()) - before
    assert len(started) == 1
    it.close()
    for t in started:
        t.join(timeout=5)
        assert not t.is_alive()


def test_producer_errors_reach_the_consumer():
    class Broken:
        def __len__(self):
            return 8

        def batch(self, idx, fields=None):
            raise ValueError("bad record")

    with pytest.raises(ValueError, match="bad record"):
        list(DataLoader(Broken(), 2, device="cpu"))
