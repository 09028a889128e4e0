"""Serving: dynamic batching of gesture requests onto the sampler.

Port of ``livelyspeaker_tpu/serving.py``. :class:`GestureBatcher` coalesces
concurrent requests into one batch padded to ``max_batch`` rows, runs the
sampler once and fans the results back out. Requests that carry text go
through the two-stage composition, in batches of their own. Long-form
requests chain windows through the same queue, so a chain batches with all
other traffic.

Two threads pipeline host work against the device: the dispatch worker forms
a batch and enqueues its whole sampling chain (CUDA launches return before
the device finishes), records a ``torch.cuda.Event`` behind it and hands it
to the collector, which waits on the event and copies the clips to the host.
While batch N runs, the worker already forms and enqueues batch N+1. Both
threads use the one stream the batcher was built on: torch's current stream
is per thread.

The HTTP front end is ``scripts/serve.py``; this module is transport-agnostic.
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
from .pipeline import LivelySpeakerPipeline, RAGSampler, long_form_window_grid

__all__ = [
    "ServeConfig",
    "ServerOverloaded",
    "GestureRequest",
    "GestureBatcher",
    "build_rag_server",
    "serving_mesh",
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
    # Long-form chains in flight at once; one more raises ServerOverloaded.
    max_long_concurrent: int = 2
    # Dispatched-but-uncollected batches that may wait for the collector;
    # 0 makes the worker finish each batch itself.
    pipeline_depth: int = 2
    # Shard each served batch over this many devices (serving_mesh);
    # max_batch must be a multiple of it
    data_parallel: int = 1


class ServerOverloaded(RuntimeError):
    """Request rejected at admission: the pending queue is full, or too
    many long-form chains are in flight."""


@dataclass
class GestureRequest:
    audio: np.ndarray  # [samples] f32 waveform at 16 kHz (padded/trimmed)
    speaker: int = 0
    guidance: Optional[float] = None
    text: Optional[str] = None  # through the composition, if one is attached
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

    Padding rows copy row 0's conditioning and are discarded. With a
    ``composition`` attached, a batch with text runs through it (the
    sentences padded with ``""``); its refinement must drive the sampler's
    RAG module, or :meth:`reload_params` swaps both.

    Only the worker thread draws from the batcher's one ``torch.Generator``:
    long-form chains submit their windows through the queue, so no other
    thread needs a draw of its own (the JAX package's thread-safe
    ``next_key`` has no counterpart here)."""

    def __init__(self, sampler: RAGSampler, cfg: ServeConfig, *,
                 composition: Optional[LivelySpeakerPipeline] = None):
        self.sampler = sampler
        self.cfg = cfg
        self.composition = composition
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
        self._long_active = 0
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
        text: Optional[str] = None,
        emotion: int = 0,
        seed_frames: Optional[np.ndarray] = None,
        block: bool = False,
    ) -> GestureRequest:
        """Enqueue one clip. ``block=False`` raises
        :class:`ServerOverloaded` when the pending queue is full;
        ``block=True`` (the next window of an admitted long-form chain)
        waits for room instead."""
        if self._stop.is_set():
            raise RuntimeError("server is shutting down")
        a = np.zeros((self.n_samples,), np.float32)
        src = np.asarray(audio, np.float32).reshape(-1)[: self.n_samples]
        a[: src.shape[0]] = src
        req = GestureRequest(audio=a, speaker=speaker, guidance=guidance, text=text,
                             emotion=emotion, seed_frames=seed_frames,
                             t_submit=time.monotonic())
        if block:
            while not self._stop.is_set():
                try:
                    self._q.put(req, timeout=0.2)
                    return req
                except queue.Full:
                    continue
            raise RuntimeError("server is shutting down")
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
        """Hot-swap the RAG weights, the composition's refinement stage's
        too (its SAG and CLIP tower stay); batches dispatched before the
        swap finish on the old ones. Returns the new params version
        (1-based)."""
        with self._device_lock, self._on_stream():
            self.sampler.update_params(state_dict)
            if self.composition is not None:
                self.composition.rag_sampler.update_params(state_dict)
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
            long_active = self._long_active
            param_version = self._param_version
        pct = lambda p: lat[min(int(p * len(lat)), len(lat) - 1)] if lat else 0.0
        return {
            "batches_served": batches,
            "requests_served": requests,
            "rejected": rejected,
            # bucketed requests wait for a batch of their kind: pending too
            "pending": self._q.qsize() + self._stash_len,
            "inflight_batches": self._inflight.qsize(),
            "long_active": long_active,
            "param_version": param_version,
            "mean_batch_occupancy": requests / batches if batches else 0.0,
            "latency_ms_p50": round(pct(0.50), 2),
            "latency_ms_p95": round(pct(0.95), 2),
            "latency_ms_p99": round(pct(0.99), 2),
        }

    # ---------------------------------------------------------- long-form
    def long_form_stream(
        self,
        audio: np.ndarray,
        *,
        speaker: int = 0,
        guidance: Optional[float] = None,
        emotion: int = 0,
        sentences: Optional[Sequence[str]] = None,
        fps: int = 15,
        sr: int = 16000,
        window_timeout: float = 300.0,
    ):
        """Long-form generation through the batcher: yields ``(window,
        new_frames)`` over the windows of
        :func:`pipeline.long_form_window_grid`, each seeded with the
        previous window's last frames, as
        :func:`pipeline.generate_long_form_stream` does. Each window is an
        ordinary request, so chains batch with each other and with short
        requests. At most ``max_long_concurrent`` chains run at once (one
        more raises :class:`ServerOverloaded`); an admitted chain's windows
        wait for room in the queue rather than fail."""
        with self._stats_lock:
            if self._long_active >= self.cfg.max_long_concurrent:
                self._rejected += 1
                raise ServerOverloaded(
                    f"{self._long_active} long-form requests already in flight; retry later")
            self._long_active += 1
        try:
            c = self.sampler.model.cfg
            nf, pre = c.nframes, c.n_pre_seq
            n_windows, excess, _, _, offsets = long_form_window_grid(
                len(audio), nf, pre, fps=fps, sr=sr)
            seed = None
            for w in range(n_windows):
                s0 = offsets[w]
                text = sentences[w % len(sentences)] if sentences else None
                req = self.submit(np.asarray(audio[s0: s0 + self.n_samples]), speaker=speaker,
                                  guidance=guidance, text=text, emotion=emotion,
                                  seed_frames=seed, block=True)
                clip = req.wait(window_timeout)  # [J, F, nf]
                out = clip if w == 0 else clip[:, :, pre:]
                if w == n_windows - 1 and excess:
                    out = out[:, :, :-excess]
                yield w, out
                seed = clip[:, :, -pre:]
        finally:
            with self._stats_lock:
                self._long_active -= 1

    def long_form(self, audio: np.ndarray, **kw) -> np.ndarray:
        """Blocking form of :meth:`long_form_stream` -> [J, F, total]."""
        return np.concatenate([c for _, c in self.long_form_stream(audio, **kw)], axis=-1)

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
        # (arrival, request) by kind (True: text), FIFO, owned by this thread
        buckets: Dict[bool, List] = {False: [], True: []}
        try:
            self._run_loop(buckets)
        finally:
            for b in buckets.values():
                _fail([r for _, r in b], RuntimeError("server is shutting down"))
            self._stash_len = 0

    def _run_loop(self, buckets: Dict[bool, List]) -> None:
        """Two-bucket batch scheduler. With a composition attached, batches
        are text-homogeneous: the composition warm-starts every row of its
        batch from the SAG sketch, so a plain request in a text batch would
        get composition output. Intake goes to its kind's bucket; a bucket
        dispatches when it holds ``max_batch`` requests, or when its oldest
        has waited ``max_wait_ms``. Without a composition there is one kind.

        Shutdown drains best effort: ``close()`` sets the stop flag before
        it queues the sentinel, so the loop may see the flag first and exit
        without serving its buckets; ``_run`` then fails their requests."""
        wait_s = self.cfg.max_wait_ms / 1000.0

        def pop_batch(kind):
            take = buckets[kind][: self.cfg.max_batch]
            del buckets[kind][: len(take)]
            self._stash_len = len(buckets[False]) + len(buckets[True])
            return [r for _, r in take]

        while not self._stop.is_set():
            full = [k for k in (False, True) if len(buckets[k]) >= self.cfg.max_batch]
            if full:
                self._emit(pop_batch(full[0]))
                continue
            now = time.monotonic()
            nearest = min(((b[0][0] + wait_s, k) for k, b in buckets.items() if b),
                          default=None)
            if nearest is not None and nearest[0] <= now:
                self._emit(pop_batch(nearest[1]))
                continue
            timeout = nearest[0] - now if nearest is not None else 0.1
            try:
                item = self._q.get(timeout=max(timeout, 1e-3))
            except queue.Empty:
                continue
            if item is _SHUTDOWN:
                for kind in (False, True):
                    while buckets[kind]:
                        self._emit(pop_batch(kind))
                return
            kind = bool(item.text) and self.composition is not None
            buckets[kind].append((time.monotonic(), item))
            self._stash_len += 1

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
        """Build the padded batch and enqueue the sampler, or the
        composition for a batch with text. Returns the output tensor and the
        event recorded behind it (None on the CPU)."""
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
        texts = [r.text for r in batch]

        dev = self.device
        with self._device_lock, self._on_stream():
            cond = {
                "audio": torch.from_numpy(audio).to(dev),
                "vid": torch.from_numpy(vid).to(dev),
                "origin_x": torch.from_numpy(origin).to(dev),
            }
            if self.sampler.model.cfg.num_emotions:
                cond["emo"] = torch.from_numpy(emo).to(dev)
            scale = torch.from_numpy(guidance).to(dev)
            if self.composition is not None and any(texts):
                sentences = [t or "" for t in texts] + [""] * (bsz - n)
                out = self.composition(sentences, cond, self._generator, guidance=scale)
            else:
                out = self.sampler(cond, self._generator, guidance=scale)
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


def serving_mesh(cfg: ServeConfig, device=None):
    """The one mesh every server component shares (JAX ``serving.py:
    600-615``), or None at ``data_parallel`` 1. Every served batch is padded
    to ``max_batch`` rows, in both buckets of the batcher, so ``max_batch``
    must be a multiple of ``data_parallel``. With ``device=None`` the mesh
    is the first ``data_parallel`` cards, and this raises where there are
    fewer; ``device="cpu"`` names the CPU ``data_parallel`` times."""
    from .parallel.mesh import data_parallel_mesh

    if cfg.max_batch % cfg.data_parallel:
        raise ValueError(f"max_batch {cfg.max_batch} must be a multiple of data_parallel "
                         f"{cfg.data_parallel}")
    return data_parallel_mesh(cfg.data_parallel, device)


def build_rag_server(model, cfg: Optional[ServeConfig] = None, *,
                     composition: Optional[LivelySpeakerPipeline] = None,
                     device=None, mesh=None) -> GestureBatcher:
    """Wire a RAG model (and optionally a composition over the same RAG)
    into a ready-to-serve batcher on the card: ``device=None`` moves the
    model to ``cuda`` (or leaves it on the CUDA device it is on) and raises
    where there is none; ``device="cpu"`` serves on the CPU with the plain
    versions of the kernels. With ``cfg.data_parallel`` above 1 each served
    batch is split over ``mesh`` (``serving_mesh(cfg, device)`` unless
    given; a composition must be built on the same mesh)."""
    cfg = cfg or ServeConfig()
    if mesh is None:
        mesh = serving_mesh(cfg, device)
    if mesh is not None:
        if mesh.size != cfg.data_parallel:
            raise ValueError(f"a mesh of {mesh.size} devices for data_parallel "
                             f"{cfg.data_parallel}")
        device = None
    sampler = RAGSampler(
        model,
        steps=cfg.steps,
        timestep_respacing=cfg.timestep_respacing,
        method=cfg.sampler,
        use_fused=cfg.use_fused,
        device=device,
        mesh=mesh,
    )
    return GestureBatcher(sampler, cfg, composition=composition)
