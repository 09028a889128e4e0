"""Profiling and tracing utilities.

Port of ``livelyspeaker_tpu/utils/profiling.py``: ``device_trace`` captures
a ``torch.profiler`` trace of the enclosed block (host activity and, where
there is a card, its kernels and copies) and writes it into ``log_dir`` as
a Chrome trace (chrome://tracing or Perfetto); ``annotate`` names a region
of that timeline; ``StepTimer`` feeds per-step throughput counters (steps/s,
clips/s) into a logger, as the JAX module's does.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

__all__ = ["device_trace", "StepTimer", "annotate", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block: CPU activity, and CUDA activity when a
    card is there. On exit the trace is written to ``log_dir/trace.json``;
    the profile object (``key_averages()`` and so on) is what the block
    receives."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextmanager
def annotate(name: str):
    """Named region visible in profiler timelines (``record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Throughput counters with warmup exclusion.

    >>> timer = StepTimer(batch_size=512)
    >>> for batch in data:
    ...     train_step(...)
    ...     stats = timer.tick()   # {'steps_per_sec', 'clips_per_sec', ...}
    """

    def __init__(self, batch_size: int, warmup_steps: int = 2):
        self.batch_size = batch_size
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0: Optional[float] = None
        self._last = None

    def tick(self) -> dict:
        now = time.perf_counter()
        self._count += 1
        out = {}
        if self._last is not None:
            dt = now - self._last
            out["step_time_s"] = dt
            out["steps_per_sec"] = 1.0 / max(dt, 1e-9)
            out["clips_per_sec"] = self.batch_size / max(dt, 1e-9)
        self._last = now
        if self._count == self.warmup_steps:
            self._t0 = now
            self._steady_start_count = self._count
        if self._t0 is not None and self._count > self.warmup_steps:
            steady = self._count - self._steady_start_count
            out["avg_steps_per_sec"] = steady / max(now - self._t0, 1e-9)
            out["avg_clips_per_sec"] = out["avg_steps_per_sec"] * self.batch_size
        return out
