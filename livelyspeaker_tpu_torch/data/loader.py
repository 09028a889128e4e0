"""Batching data loaders: a streaming loader with background prefetch, and a
device-resident one.

Port of ``livelyspeaker_tpu/data/loader.py``, with the same index stream:
the shuffle of an epoch is ``np.random.default_rng([seed, epoch])``, the
per-host split strided, and ``set_epoch(epoch, start_batch)`` resumes inside
an epoch without assembling the skipped batches.

Where the port differs, it is in the device handling:

- :class:`DataLoader` with ``device=None`` yields host numpy batches, as the
  JAX loader does with ``sharding=None``. With a ``device`` it yields the
  array fields as tensors on that device, in the records' dtypes (int16
  audio and int32 ids stay so; the models cast). On a CUDA device the
  prefetch thread copies each batch into a pinned host buffer and from
  there to the card with ``non_blocking=True`` on a copy stream of its own.
  Each prefetch slot has its own pinned buffers and a CUDA event recorded
  after its copy; a slot is refilled only after its event has completed, and
  the consumer's stream waits on the event before the batch is used.
- :class:`DeviceDataLoader` stages the kept fields on the device once and
  gathers each batch there by an index vector. ``device=None`` means the
  card, and it raises where there is none (``utils/device.py``'s rule).
- With a ``mesh`` (``parallel.create_mesh``) instead of a device, both
  yield a list of one batch a shard, in shard order (JAX ``data/loader.py:
  66-82``, whose batch is one array laid out over the mesh). The streaming
  loader's batch leaves the host as N shards: one pinned copy a slot, each
  shard's rows sent to its card on that card's copy stream, one event a
  card. The resident loader holds its copy once a distinct device (a mesh
  that names one card twice holds it once) and gathers each shard's rows
  on its device.

JSON fields (``sentence``, ``words``) pass through as Python lists.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.profiling import annotate

__all__ = ["DataLoader", "DeviceDataLoader", "epoch_indices"]


def epoch_indices(n: int, seed: int, epoch: int, shuffle: bool = True,
                  host_id: int = 0, num_hosts: int = 1) -> np.ndarray:
    """The dataset indices of one epoch, in order: shuffled by
    ``default_rng([seed, epoch])``, then this host's strided share,
    truncated to the common per-host length (every host runs the same
    number of batches)."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng([seed, epoch]).shuffle(idx)
    return idx[host_id::num_hosts][: n // num_hosts]


def _batches(idx: np.ndarray, batch_size: int, drop_last: bool, start_batch: int):
    for s in range(start_batch * batch_size, len(idx), batch_size):
        chunk = idx[s: s + batch_size]
        if drop_last and len(chunk) < batch_size:
            return
        yield chunk


def _mesh_devices(device, mesh, who: str) -> Optional[List[torch.device]]:
    """The devices a batch goes to (one a shard), or None for host batches."""
    if mesh is not None:
        if device is not None:
            raise ValueError(f"{who} takes a device or a mesh, not both")
        return list(mesh.devices)
    return None if device is None else [torch.device(device)]


def _split_rows(n_rows: int, n: int):
    if n_rows % n:
        raise ValueError(f"batch {n_rows} must divide the mesh data axis ({n})")
    return [(i * n_rows // n, (i + 1) * n_rows // n) for i in range(n)]


class DeviceDataLoader:
    """Device-resident batching: stage the whole dataset on the device once,
    then gather each batch there by a [B] index vector.

    The host path disappears from the step: no per-batch gather, pinned
    copy or host-to-device transfer. Use it whenever the training fields fit
    device memory (1,040 TED windows hold about 150 MB of f32 audio).

    Same iteration contract as :class:`DataLoader` (``set_epoch``,
    ``drop_last``, ``len``); yields dicts of device tensors, or with a
    ``mesh`` a list of one dict a shard. ``device=None`` (and no mesh)
    means the card."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 233,
        fields: Optional[Sequence[str]] = None,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
    ):
        self.mesh = mesh
        if mesh is None and device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceDataLoader stages the dataset on an NVIDIA GPU by default and "
                    'torch.cuda.is_available() is False; pass device="cpu" to stage it in '
                    "host memory")
            device = "cuda"
        self._shard_devices = _mesh_devices(device, mesh, "DeviceDataLoader")
        self.device = self._shard_devices[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self.epoch = 0
        self._start_batch = 0
        n = len(dataset)
        host = (dataset.batch(np.arange(n), fields=list(fields)) if fields is not None
                else dataset.batch(np.arange(n)))
        # array fields only, in their stored dtypes (PCM16 audio is decoded
        # by the WavEncoder on the device)
        fields = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()
                  if isinstance(v, np.ndarray) and v.dtype != object}
        self._dev = {d: {k: v.to(d) for k, v in fields.items()}
                     for d in dict.fromkeys(self._shard_devices)}
        self._n = n

    @property
    def nbytes(self) -> int:
        """Device bytes the staged fields hold, over every device."""
        return sum(v.numel() * v.element_size() for staged in self._dev.values()
                   for v in staged.values())

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """``start_batch`` makes the next iteration begin at that batch of
        the epoch; it is consumed by one ``__iter__`` and resets to 0."""
        self.epoch = int(epoch)
        self._start_batch = int(start_batch)

    def __len__(self) -> int:
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = epoch_indices(self._n, self._seed, self.epoch, self.shuffle)
        self.epoch += 1
        start, self._start_batch = self._start_batch, 0
        n = len(self._shard_devices)
        for chunk in _batches(idx, self.batch_size, self.drop_last, start):
            with annotate("train.loader"):
                shards = []
                for (lo, hi), dev in zip(_split_rows(len(chunk), n), self._shard_devices):
                    ci = torch.from_numpy(chunk[lo:hi]).to(dev)
                    shards.append({k: torch.index_select(v, 0, ci)
                                   for k, v in self._dev[dev].items()})
            yield shards if self.mesh is not None else shards[0]


class _PinnedSlots:
    """The pinned host buffers of the prefetch slots of one iteration, each
    guarded by the CUDA events recorded after its host-to-device copies,
    one a card (each card has its copy stream)."""

    def __init__(self, n_slots: int, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.streams = {d: torch.cuda.Stream(d) for d in dict.fromkeys(self.devices)}
        self.buffers: List[Dict[str, torch.Tensor]] = [{} for _ in range(n_slots)]
        self.events: List[list] = [[] for _ in range(n_slots)]
        self.next = 0

    def _buffer(self, slot: int, key: str, arr: np.ndarray) -> torch.Tensor:
        """A pinned view of ``arr``'s shape and dtype in ``slot``."""
        dtype = torch.from_numpy(arr[:0]).dtype
        buf = self.buffers[slot].get(key)
        if buf is None or buf.dtype != dtype or buf.shape[1:] != arr.shape[1:] \
                or buf.shape[0] < arr.shape[0]:
            buf = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            self.buffers[slot][key] = buf
        return buf[: arr.shape[0]]

    def send(self, batch: Dict):
        """(one batch a device of ``devices``, its rows of the arrays sent
        there; the (device, event) pairs the consumer's streams wait on)."""
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        for _, event in self.events[slot]:
            event.synchronize()  # the slot's last copies have finished
        pinned = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                pinned[k] = self._buffer(slot, k, v)
                pinned[k].numpy()[...] = v
        rows = len(next(iter(batch.values())))
        outs = []
        for (lo, hi), dev in zip(_split_rows(rows, len(self.devices)), self.devices):
            out = {}
            with torch.cuda.stream(self.streams[dev]):
                for k, v in batch.items():
                    if k in pinned:
                        out[k] = pinned[k][lo:hi].to(dev, non_blocking=True)
                    else:
                        out[k] = v if len(self.devices) == 1 else v[lo:hi]
            outs.append(out)
        events = []
        for dev, stream in self.streams.items():
            event = torch.cuda.Event()
            event.record(stream)
            events.append((dev, event))
        self.events[slot] = events
        return outs, events


class DataLoader:
    """Streaming batches from a dataset with ``batch(indices, fields=...)``,
    assembled by a background thread up to ``prefetch`` batches ahead.

    ``device=None`` yields host numpy batches; with a ``device`` the array
    fields arrive as tensors on it (through pinned buffers and a copy stream
    on a CUDA device, see the module docstring), and with a ``mesh`` as a
    list of one batch a shard, each on its device."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 233,
        collate: Optional[Callable[[Dict], Dict]] = None,
        device: Optional[Union[str, torch.device]] = None,
        prefetch: int = 2,
        host_id: int = 0,
        num_hosts: int = 1,
        fields: Optional[Sequence[str]] = None,
        mesh=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate = collate
        self.mesh = mesh
        self._shard_devices = _mesh_devices(device, mesh, "DataLoader")
        self.device = None if self._shard_devices is None else self._shard_devices[0]
        self.prefetch = prefetch
        self.host_id = host_id
        self.num_hosts = num_hosts
        # restrict assembly to these output fields (training needs 3 or 4)
        self.fields = list(fields) if fields is not None else None
        self._seed = seed
        # the shuffle is a pure function of (seed, epoch), so a resumed run
        # replays the batch stream of an uninterrupted one; without
        # set_epoch the counter advances by one an epoch
        self.epoch = 0
        self._start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """``start_batch`` makes the next iteration begin at that batch of
        the epoch without assembling or sending the skipped batches;
        consumed by one ``__iter__``, then reset."""
        self.epoch = int(epoch)
        self._start_batch = int(start_batch)

    def _epoch_indices(self) -> np.ndarray:
        idx = epoch_indices(len(self.dataset), self._seed, self.epoch, self.shuffle,
                            self.host_id, self.num_hosts)
        self.epoch += 1
        return idx

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_hosts
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batches(self) -> Iterator[Dict]:
        idx = self._epoch_indices()
        start, self._start_batch = self._start_batch, 0
        for chunk in _batches(idx, self.batch_size, self.drop_last, start):
            if self.fields is not None:
                batch = self.dataset.batch(chunk, fields=self.fields)
            else:
                batch = self.dataset.batch(chunk)
            if self.collate is not None:
                batch = self.collate(batch)
            yield batch

    def _to_device(self, batch: Dict, slots: Optional[_PinnedSlots]):
        """(batch as it is yielded, the (device, CUDA event) pairs it waits
        on)."""
        if self._shard_devices is None:
            return batch, []
        if slots is not None:
            outs, events = slots.send(batch)
        elif self.mesh is not None:
            from ..parallel.mesh import shard_batch

            outs, events = shard_batch(batch, self.mesh), []
        else:
            outs, events = [{k: torch.from_numpy(v).to(self.device)
                             if isinstance(v, np.ndarray) and v.dtype != object else v
                             for k, v in batch.items()}], []
        return (outs if self.mesh is not None else outs[0]), events

    def __iter__(self) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []
        stop = threading.Event()
        slots = None
        if self.device is not None and self.device.type == "cuda":
            # a slot per batch the queue holds, one being filled and one
            # whose copy may still run: the event wait seldom blocks
            slots = _PinnedSlots(self.prefetch + 2, self._shard_devices)

        def put_or_stop(item) -> bool:
            """Bounded put that gives up when the consumer is gone, so an
            abandoned iterator cannot leave the producer blocked."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._make_batches():
                    if not put_or_stop(self._to_device(b, slots)):
                        return
            except Exception as e:  # raised again in the consumer
                err.append(e)
            finally:
                put_or_stop(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with annotate("train.loader"):  # the wait on the producer
                    item = q.get()
                    if item is sentinel:
                        if err:
                            raise err[0]
                        return
                    batch, events = item
                    for dev, event in events:
                        torch.cuda.current_stream(dev).wait_event(event)
                    if events:
                        for shard in (batch if self.mesh is not None else [batch]):
                            for v in shard.values():
                                if isinstance(v, torch.Tensor):
                                    # memory allocated on a copy stream, used on the current one
                                    v.record_stream(torch.cuda.current_stream(v.device))
                yield batch
        finally:
            # on break, exception or collection of the generator: stop the
            # producer and drain the queue so that it exits
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
