"""Key-value training logger and reporting platforms (numpy only).

A copy of ``livelyspeaker_tpu/training/logging.py``, whose package imports
JAX: the mean-aggregating ``KVLogger`` with stdout/JSON/CSV sinks, the
``TrainPlatform`` interface with ``NoPlatform``, ``TensorboardPlatform``
(over ``torch.utils.tensorboard``) and ``ClearmlPlatform`` (which imports
the optional ``clearml`` when built, and raises ``ImportError`` without it),
and the per-quartile diffusion-loss breakdown.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Iterable, Optional

import numpy as np

__all__ = [
    "KVLogger",
    "TrainPlatform",
    "TensorboardPlatform",
    "ClearmlPlatform",
    "NoPlatform",
    "log_loss_quartiles",
]


class KVLogger:
    """Mean-aggregating key-value logger with human/JSON/CSV sinks."""

    def __init__(self, log_dir: Optional[str] = None,
                 formats: Iterable[str] = ("stdout", "json", "csv")):
        self.log_dir = log_dir
        self._sum: Dict[str, float] = {}
        self._cnt: Dict[str, int] = {}
        self._latest: Dict[str, float] = {}
        self._files = {}
        self._csv_keys = None
        self.formats = tuple(formats)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            if "json" in self.formats:
                self._files["json"] = open(
                    os.path.join(log_dir, "progress.jsonl"), "a"
                )
            if "csv" in self.formats:
                self._files["csv_path"] = os.path.join(log_dir, "progress.csv")

    def logkv(self, key: str, val) -> None:
        self._latest[key] = float(val)
        self._sum[key] = float(val)
        self._cnt[key] = 1

    def logkv_mean(self, key: str, val) -> None:
        self._sum[key] = self._sum.get(key, 0.0) + float(val)
        self._cnt[key] = self._cnt.get(key, 0) + 1
        self._latest[key] = self._sum[key] / self._cnt[key]

    def dumpkvs(self) -> Dict[str, float]:
        out = {
            k: self._sum[k] / max(self._cnt[k], 1) for k in sorted(self._sum)
        }
        if "stdout" in self.formats:
            width = max((len(k) for k in out), default=1)
            lines = [f"| {k.ljust(width)} | {v:<12.5g} |" for k, v in out.items()]
            dash = "-" * (width + 19)
            print("\n".join([dash] + lines + [dash]), file=sys.stderr)
        if "json" in self._files:
            self._files["json"].write(json.dumps(out) + "\n")
            self._files["json"].flush()
        if "csv_path" in self._files:
            self._write_csv_row(out)
        self._sum.clear()
        self._cnt.clear()
        return out

    def _write_csv_row(self, row: Dict[str, float]) -> None:
        path = self._files["csv_path"]
        keys = sorted(row)
        if self._csv_keys is None or any(k not in self._csv_keys for k in keys):
            # (Re)write header with the union of keys.
            old_rows = []
            if self._csv_keys is not None and os.path.exists(path):
                with open(path) as f:
                    old_rows = list(csv.DictReader(f))
            self._csv_keys = sorted(set(keys) | set(self._csv_keys or []))
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_keys)
            w.writerow({k: row.get(k, "") for k in self._csv_keys})

    @contextmanager
    def profile(self, name: str):
        """Wall-time profiling context (logger.py:294-312)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.logkv_mean(f"wait_{name}", time.time() - t0)

    def close(self) -> None:
        f = self._files.get("json")
        if f:
            f.close()


class TrainPlatform:
    """Scalar-reporting backend interface (train_platforms.py:3-14)."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir

    def report_scalar(self, name, value, iteration, group_name=None):
        pass

    def report_args(self, args, name):
        pass

    def close(self):
        pass


class TensorboardPlatform(TrainPlatform):
    """Scalars as TensorBoard events in ``save_dir``."""

    def __init__(self, save_dir: str):
        super().__init__(save_dir)
        from torch.utils.tensorboard import SummaryWriter  # lazy

        self.writer = SummaryWriter(log_dir=save_dir)

    def report_scalar(self, name, value, iteration, group_name=None):
        self.writer.add_scalar(f"{group_name}/{name}", value, iteration)

    def close(self):
        self.writer.close()


class ClearmlPlatform(TrainPlatform):
    """ClearML reporting backend (train_platforms.py:17-28); lazily imports
    the optional dependency."""

    def __init__(self, save_dir: str):
        super().__init__(save_dir)
        from clearml import Task  # optional dep

        name = os.path.basename(save_dir)
        self.task = Task.init(
            project_name="livelyspeaker_tpu", task_name=name
        )
        self.logger = self.task.get_logger()

    def report_scalar(self, name, value, iteration, group_name=None):
        self.logger.report_scalar(
            title=group_name, series=name, iteration=iteration, value=value
        )

    def report_args(self, args, name):
        self.task.connect(args, name=name)

    def close(self):
        self.task.close()


class NoPlatform(TrainPlatform):
    pass


def log_loss_quartiles(
    logger: KVLogger, t: np.ndarray, losses: Dict[str, np.ndarray],
    num_timesteps: int, *, log_means: bool = True
) -> None:
    """Per-timestep-quartile loss means (train_loop.py:255-261).

    Vectorised: one bincount per key instead of a Python loop over samples.
    ``log_means=False`` skips the whole-batch mean (for callers that already
    log it from the step metrics).
    """
    t = np.asarray(t)
    quartile = (4 * t // num_timesteps).astype(np.int64)
    for key, values in losses.items():
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        if log_means:
            logger.logkv_mean(key, values.mean())
        if values.shape != t.shape:
            continue  # scalar losses (huber) have no per-sample breakdown
        for q in range(4):
            sel = quartile == q
            if sel.any():
                logger.logkv_mean(f"{key}_q{q}", values[sel].mean())
