"""Serving: dynamic batching of gesture requests onto the sampler.

Port of the plain RAG path of ``livelyspeaker_tpu/serving.py``.
:class:`GestureBatcher` coalesces concurrent requests into one batch padded
to ``max_batch`` rows, runs the sampler once and fans the results back out.
Two threads pipeline host work against the device: the dispatch worker forms
a batch and enqueues its whole sampling chain (CUDA launches return before
the device finishes), records a ``torch.cuda.Event`` behind it and hands it
to the collector, which waits on the event and copies the clips to the host.
While batch N runs, the worker already forms and enqueues batch N+1. Both
threads use the one stream the batcher was built on: torch's current stream
is per thread.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .models.audio_encoder import audio_samples_for_frames
from .pipeline import RAGSampler

__all__ = [
    "ServeConfig",
    "ServerOverloaded",
    "GestureRequest",
    "GestureBatcher",
    "build_rag_server",
]


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_wait_ms: float = 25.0
    default_guidance: float = 1.5
    steps: int = 1000
    timestep_respacing: Optional[str] = "ddim20"
    sampler: str = "dpmpp"
    use_fused: bool = True  # the fused TransMLP kernel
    seed: int = 0
    # Backpressure: pending requests beyond this raise ServerOverloaded at
    # submit time instead of growing latency without bound.
    max_queue: int = 128
    # Dispatched-but-uncollected batches that may wait for the collector;
    # 0 makes the worker finish each batch itself.
    pipeline_depth: int = 2
    # Only 1: the port serves from one card.
    data_parallel: int = 1


class ServerOverloaded(RuntimeError):
    """Request rejected at admission: the pending queue is full."""


@dataclass
class GestureRequest:
    audio: np.ndarray  # [samples] f32 waveform at 16 kHz (padded/trimmed)
    speaker: int = 0
    guidance: Optional[float] = None
    emotion: int = 0  # BEAT models (num_emotions > 0); ignored for TED
    # [njoints, nfeats, n_pre_seq] seed frames
    seed_frames: Optional[np.ndarray] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None  # [njoints, nfeats, nframes]
    error: Optional[BaseException] = None
    batch_size: int = 0  # how many requests shared the batch
    t_submit: float = 0.0

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("gesture generation timed out")
        if self.error is not None:
            raise self.error
        return self.result


_SHUTDOWN = object()


def _fail(reqs, err: BaseException) -> None:
    for r in reqs:
        r.error = err
        r.done.set()


class GestureBatcher:
    """Coalesce concurrent requests into fixed-shape sampler batches.

    The worker drains the queue into a bucket; the bucket dispatches when it
    holds ``max_batch`` requests, or when its oldest request has waited
    ``max_wait_ms``. Padding rows copy row 0's conditioning and are
    discarded."""

    def __init__(self, sampler: RAGSampler, cfg: ServeConfig):
        self.sampler = sampler
        self.cfg = cfg
        c = sampler.model.cfg
        self.device = sampler.device
        self.n_samples = audio_samples_for_frames(c.nframes)
        self._shape = (c.njoints, c.nfeats, c.nframes)
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.max_queue)
        self._stop = threading.Event()
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._batches_served = 0
        self._requests_served = 0
        self._rejected = 0
        self._stash_len = 0  # worker-owned count of bucketed requests
        self._latencies_ms: List[float] = []  # rolling, last 512
        # one lock owns the device: dispatch and reload serialise on it
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._param_version = 0
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(1, cfg.pipeline_depth))
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._collector = threading.Thread(target=self._collect, daemon=True)
        self._worker.start()
        self._collector.start()

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ------------------------------------------------------------- client
    def submit(
        self,
        audio: np.ndarray,
        *,
        speaker: int = 0,
        guidance: Optional[float] = None,
        emotion: int = 0,
        seed_frames: Optional[np.ndarray] = None,
    ) -> GestureRequest:
        """Enqueue one clip; raises :class:`ServerOverloaded` when the
        pending queue is full."""
        if self._stop.is_set():
            raise RuntimeError("server is shutting down")
        a = np.zeros((self.n_samples,), np.float32)
        src = np.asarray(audio, np.float32).reshape(-1)[: self.n_samples]
        a[: src.shape[0]] = src
        req = GestureRequest(audio=a, speaker=speaker, guidance=guidance,
                             emotion=emotion, seed_frames=seed_frames,
                             t_submit=time.monotonic())
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self._rejected += 1
            raise ServerOverloaded(
                f"pending queue full ({self.cfg.max_queue}); retry later"
            ) from None
        if self._stop.is_set():
            # close() may have drained the queue before this put landed
            _fail([req], RuntimeError("server is shutting down"))
            raise RuntimeError("server is shutting down")
        return req

    def generate(self, audio: np.ndarray, timeout: float = 300.0, **kw) -> np.ndarray:
        return self.submit(audio, **kw).wait(timeout)

    def reload_params(self, state_dict) -> int:
        """Hot-swap the weights; batches dispatched before the swap finish on
        the old ones. Returns the new params version (1-based)."""
        with self._device_lock, self._on_stream():
            self.sampler.update_params(state_dict)
            with self._stats_lock:
                self._param_version += 1
                return self._param_version

    def reset_stats(self) -> None:
        """Zero the counters and the latency window."""
        with self._stats_lock:
            self._batches_served = 0
            self._requests_served = 0
            self._rejected = 0
            self._latencies_ms.clear()

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            batches = self._batches_served
            requests = self._requests_served
            rejected = self._rejected
            param_version = self._param_version
        pct = lambda p: lat[min(int(p * len(lat)), len(lat) - 1)] if lat else 0.0
        return {
            "batches_served": batches,
            "requests_served": requests,
            "rejected": rejected,
            "pending": self._q.qsize() + self._stash_len,
            "inflight_batches": self._inflight.qsize(),
            "param_version": param_version,
            "mean_batch_occupancy": requests / batches if batches else 0.0,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
        }

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(_SHUTDOWN)
        except queue.Full:
            pass  # the worker's intake returns at once and sees the flag
        self._worker.join(timeout=10)
        # fail what is still queued now, rather than at the client's timeout
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not _SHUTDOWN:
                _fail([req], RuntimeError("server is shutting down"))
        try:
            self._inflight.put(_SHUTDOWN, timeout=10)
        except queue.Full:
            pass
        self._collector.join(timeout=10)

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        bucket: List = []  # (arrival, request), FIFO, owned by this thread
        try:
            self._run_loop(bucket)
        finally:
            _fail([r for _, r in bucket], RuntimeError("server is shutting down"))
            self._stash_len = 0

    def _run_loop(self, bucket: List) -> None:
        wait_s = self.cfg.max_wait_ms / 1000.0

        def pop_batch():
            take = bucket[: self.cfg.max_batch]
            del bucket[: len(take)]
            self._stash_len = len(bucket)
            return [r for _, r in take]

        while not self._stop.is_set():
            if len(bucket) >= self.cfg.max_batch:
                self._emit(pop_batch())
                continue
            now = time.monotonic()
            deadline = bucket[0][0] + wait_s if bucket else None
            if deadline is not None and deadline <= now:
                self._emit(pop_batch())
                continue
            timeout = deadline - now if deadline is not None else 0.1
            try:
                item = self._q.get(timeout=max(timeout, 1e-3))
            except queue.Empty:
                continue
            if item is _SHUTDOWN:
                while bucket:  # admitted requests are served
                    self._emit(pop_batch())
                return
            bucket.append((time.monotonic(), item))
            self._stash_len = len(bucket)

    def _emit(self, batch: List[GestureRequest]) -> None:
        """Dispatch a formed batch and route it to the collector."""
        try:
            out = self._dispatch(batch)
        except BaseException as e:  # every waiter gets the error
            _fail(batch, e)
            return
        if self.cfg.pipeline_depth <= 0:
            self._finish(batch, out)
            return
        while not self._stop.is_set():
            try:
                self._inflight.put((batch, out), timeout=0.2)
                return
            except queue.Full:
                continue
        self._finish(batch, out)  # shutting down with the pipe full

    def _dispatch(self, batch: Sequence[GestureRequest]):
        """Build the padded batch and enqueue the sampler. Returns the output
        tensor and the event recorded behind it (None on the CPU)."""
        n, bsz = len(batch), self.cfg.max_batch
        audio = np.zeros((bsz, self.n_samples), np.float32)
        vid = np.zeros((bsz,), np.int64)
        emo = np.zeros((bsz,), np.int64)
        guidance = np.full((bsz,), self.cfg.default_guidance, np.float32)
        origin = np.zeros((bsz,) + self._shape, np.float32)
        for i, r in enumerate(batch):
            audio[i] = r.audio
            vid[i] = r.speaker
            emo[i] = r.emotion
            if r.guidance is not None:
                guidance[i] = r.guidance
            if r.seed_frames is not None:
                origin[i, :, :, : r.seed_frames.shape[-1]] = r.seed_frames
        # padding rows replicate row 0 (fixed shapes; results discarded)
        audio[n:] = audio[0]
        vid[n:] = vid[0]
        emo[n:] = emo[0]

        dev = self.device
        with self._device_lock, self._on_stream():
            cond = {
                "audio": torch.from_numpy(audio).to(dev),
                "vid": torch.from_numpy(vid).to(dev),
                "origin_x": torch.from_numpy(origin).to(dev),
            }
            if self.sampler.model.cfg.num_emotions:
                cond["emo"] = torch.from_numpy(emo).to(dev)
            out = self.sampler(cond, self._generator,
                               guidance=torch.from_numpy(guidance).to(dev))
            event = None
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
        return out, event

    def _collect(self) -> None:
        while True:
            item = self._inflight.get()
            if item is _SHUTDOWN:
                return
            self._finish(*item)

    def _finish(self, batch: Sequence[GestureRequest], dispatched) -> None:
        out, event = dispatched
        try:
            with self._on_stream():
                if event is not None:
                    event.synchronize()
                out_np = out.cpu().numpy()
        except BaseException as e:
            _fail(batch, e)
            return
        now = time.monotonic()
        with self._stats_lock:
            self._batches_served += 1
            self._requests_served += len(batch)
            self._latencies_ms.extend((now - r.t_submit) * 1e3 for r in batch)
            del self._latencies_ms[:-512]
        for i, r in enumerate(batch):
            r.result = out_np[i]
            r.batch_size = len(batch)
            r.done.set()


def build_rag_server(model, cfg: Optional[ServeConfig] = None, *,
                     device=None) -> GestureBatcher:
    """Wire a RAG model into a ready-to-serve batcher on the card:
    ``device=None`` moves the model to ``cuda`` (or leaves it on the CUDA
    device it is on) and raises where there is none; ``device="cpu"``
    serves on the CPU with the plain versions of the kernels."""
    cfg = cfg or ServeConfig()
    if cfg.data_parallel != 1:
        raise ValueError("the port serves from one device: data_parallel must be 1")
    sampler = RAGSampler(
        model,
        steps=cfg.steps,
        timestep_respacing=cfg.timestep_respacing,
        method=cfg.sampler,
        use_fused=cfg.use_fused,
        device=device,
    )
    return GestureBatcher(sampler, cfg)
