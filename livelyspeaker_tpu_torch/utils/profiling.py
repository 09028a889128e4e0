"""Profiling and tracing utilities.

Port of ``livelyspeaker_tpu/utils/profiling.py``: ``device_trace`` captures
a ``torch.profiler`` trace of the enclosed block (host activity and, where
there is a card, its kernels and copies) and writes it into ``log_dir`` as
a Chrome trace (chrome://tracing or Perfetto); ``annotate`` names a region
of that timeline, on the clock of the kernels and copies it launches.

The port's hot path carries a fixed set of spans: ``rag.sample``,
``rag.prepare`` and ``rag.step`` (``pipeline.py``,
``diffusion/sampling.py``), ``compose.clip``, ``compose.lm`` and
``compose.sag`` (``pipeline.py``), ``lm.attn``, ``lm.route`` and ``lm.ffn``
in every layer of the MoE text tower (``models/moe_text.py``),
``train.loader`` (``data/loader.py``), ``train.grads``, ``train.sync`` and
``train.apply`` (``training/trainer.py``). With no profiler running a span
tests one flag: 1.2-1.6 us an enter and exit on an H100 machine's host,
against 8.6-10.6 us for a bare ``record_function``.

``counters()`` copies the counters of the objects registered with
:func:`register_counters` to the host: the MoE text tower's routed token
count by layer and expert (``moe_text``), which the tower adds on the
device at every call. Reading them is a synchronise; keeping them is not.
"""

from __future__ import annotations

import os
import weakref
from contextlib import contextmanager
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["device_trace", "annotate", "TRACE_FILE", "counters", "register_counters"]

TRACE_FILE = "trace.json"

# name -> the live object whose ``counters()`` is read under that name
_SOURCES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


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


def register_counters(name: str, source) -> None:
    """Read ``source.counters()`` under ``name`` in :func:`counters` while
    ``source`` lives; a later source of the same name takes its place."""
    _SOURCES[name] = source


def counters() -> Dict[str, Dict]:
    """The registered counters, by name, copied to the host."""
    return {name: src.counters() for name, src in list(_SOURCES.items())}
