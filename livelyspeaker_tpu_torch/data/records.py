"""Sharded on-disk dataset records: a directory of memory-mapped ``.npy``
shards.

Port of ``livelyspeaker_tpu/data/records.py`` with the same on-disk format,
so records written by either package are read by the other. A batch's
array fields are gathered per shard by the native record gather
(``data/native.py``: memcpy rows out of the memory-mapped shards, with the
window crop and the motion transpose fused in), which falls back to numpy
indexing where the library cannot be built or a shard array is not
C-contiguous; the bytes are the same either way.

Layout:
    root/meta.json                     {"fields": {...}, "shards": [...]}
    root/shard_00000/<field>.npy       one array per field, N rows each
    root/shard_00000/<field>.json      per-row python objects (e.g. text)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .native import gather_rows, gather_rows_prefix, gather_rows_transpose_crop

__all__ = ["ShardWriter", "ShardedDataset"]


class ShardWriter:
    """Accumulate rows and flush fixed-size shards."""

    def __init__(self, root: str, shard_size: int = 4096):
        self.root = root
        self.shard_size = shard_size
        self._buf: Dict[str, List[Any]] = {}
        self._json_fields: set = set()
        self._shards: List[Dict[str, Any]] = []
        self._field_shapes: Dict[str, List[int]] = {}
        os.makedirs(root, exist_ok=True)

    def add(self, **fields) -> None:
        for k, v in fields.items():
            self._buf.setdefault(k, []).append(v)
            if isinstance(v, str) or isinstance(v, dict) or isinstance(v, list):
                self._json_fields.add(k)
        n = len(next(iter(self._buf.values())))
        if n >= self.shard_size:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        idx = len(self._shards)
        d = os.path.join(self.root, f"shard_{idx:05d}")
        os.makedirs(d, exist_ok=True)
        count = len(next(iter(self._buf.values())))
        for k, vals in self._buf.items():
            if k in self._json_fields:
                with open(os.path.join(d, f"{k}.json"), "w") as f:
                    json.dump(vals, f)
            else:
                arr = np.stack(vals)
                shape = list(arr.shape[1:])
                prev = self._field_shapes.setdefault(k, shape)
                if prev != shape:  # readers rely on one row shape per field
                    raise ValueError(
                        f"field {k!r}: shard {idx} row shape {shape} != "
                        f"earlier shards' {prev}"
                    )
                np.save(os.path.join(d, f"{k}.npy"), arr)
        self._shards.append({"name": f"shard_{idx:05d}", "count": count})
        self._buf = {}

    def finish(self, extra_meta: Optional[Dict[str, Any]] = None) -> None:
        self._flush()
        meta = {
            "shards": self._shards,
            "json_fields": sorted(self._json_fields),
            "field_shapes": self._field_shapes,
        }
        if extra_meta:
            meta.update(extra_meta)
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)


class ShardedDataset:
    """Random-access view over a record directory (mmap per shard)."""

    def __init__(self, root: str, fields: Optional[Sequence[str]] = None):
        self.root = root
        with open(os.path.join(root, "meta.json")) as f:
            self.meta = json.load(f)
        self.shard_names = [s["name"] for s in self.meta["shards"]]
        self.counts = np.array([s["count"] for s in self.meta["shards"]])
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)])
        self.json_fields = set(self.meta.get("json_fields", []))
        self._cache: Dict[str, Dict[str, Any]] = {}
        if fields is None:
            d = os.path.join(root, self.shard_names[0])
            fields = sorted(
                f.rsplit(".", 1)[0]
                for f in os.listdir(d)
                if f.endswith((".npy", ".json"))
            )
        self.fields = list(fields)

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def row_shape(self, field: str) -> tuple:
        """Per-row shape of an array field, from meta.json (writer-verified
        homogeneous across shards); falls back to the first shard's npy
        header for records written before field_shapes existed."""
        shapes = self.meta.get("field_shapes") or {}
        if field in shapes:
            return tuple(shapes[field])
        return tuple(self._shard(0)[field].shape[1:])

    def _shard(self, si: int) -> Dict[str, Any]:
        name = self.shard_names[si]
        if name not in self._cache:
            d = os.path.join(self.root, name)
            data = {}
            for f in self.fields:
                npy = os.path.join(d, f"{f}.npy")
                if os.path.exists(npy):
                    data[f] = np.load(npy, mmap_mode="r")
                else:
                    with open(os.path.join(d, f"{f}.json")) as fh:
                        data[f] = json.load(fh)
            self._cache[name] = data
        return self._cache[name]

    def __getitem__(self, i: int) -> Dict[str, Any]:
        si = int(np.searchsorted(self.offsets, i, side="right") - 1)
        li = i - int(self.offsets[si])
        shard = self._shard(si)
        return {f: shard[f][li] for f in self.fields}

    def _grouped(self, indices: Sequence[int]):
        idx = np.asarray(indices, np.int64)
        si = np.searchsorted(self.offsets, idx, side="right") - 1
        local = idx - self.offsets[si]
        order = np.argsort(si, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return si, local, order, inv

    def _gather_grouped(self, field: str, si, local, order, inv, gather_fn):
        chunks = []
        pos = 0
        while pos < len(order):
            s = si[order[pos]]
            end = pos
            while end < len(order) and si[order[end]] == s:
                end += 1
            rows = local[order[pos:end]]
            chunks.append(gather_fn(self._shard(int(s))[field], rows))
            pos = end
        stacked = (
            np.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]
        )
        if len(chunks) == 1:
            # single-shard batch (the common case): order == identity, so
            # the un-permute would be a full extra copy of the batch — skip
            return stacked
        return stacked[inv]

    def gather_field(
        self,
        field: str,
        indices: Sequence[int],
        *,
        prefix: Optional[int] = None,
        transpose_crop: Optional[int] = None,
    ) -> np.ndarray:
        """Gather one array field across shards through the native gather.

        ``prefix`` keeps only the first N entries along each row's leading
        axis (the window or audio crop); ``transpose_crop`` also transposes
        each cropped [T, C] row to [C, T], the motion layout the denoiser
        consumes.
        """
        si, local, order, inv = self._grouped(indices)
        if transpose_crop is not None:
            fn = lambda a, r: gather_rows_transpose_crop(
                a.reshape(a.shape[0], a.shape[1], -1), r, transpose_crop
            )
        elif prefix is not None:
            fn = lambda a, r: gather_rows_prefix(a, r, prefix)
        else:
            fn = gather_rows
        return self._gather_grouped(field, si, local, order, inv, fn)

    def batch(
        self, indices: Sequence[int], fields: Optional[Sequence[str]] = None
    ) -> Dict[str, Any]:
        """Assemble a batch: one native gather per array field and shard; JSON
        fields stay Python lists. ``fields`` restricts assembly to the
        listed record fields (the training path needs 3 of them, see
        ted.py)."""
        si, local, order, inv = self._grouped(indices)
        out: Dict[str, Any] = {}
        for f in self.fields if fields is None else fields:
            if f in self.json_fields:
                out[f] = [self._shard(int(s))[f][int(l)]
                          for s, l in zip(si, local)]
                continue
            out[f] = self._gather_grouped(f, si, local, order, inv, gather_rows)
        return out

    def iter_shards(self) -> Iterator[Dict[str, Any]]:
        for si in range(len(self.shard_names)):
            yield self._shard(si)
