"""Behaviour of the port's GestureBatcher on the CPU (tiny model), and the
port's import hygiene: no JAX, no triton, no nvcc needed to import it."""

import os
import queue
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.models import RAG, RAGConfig
from livelyspeaker_tpu_torch.ops import fused_mlp
from livelyspeaker_tpu_torch.serving import (
    ServeConfig,
    ServerOverloaded,
    build_rag_server,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model():
    cfg = RAGConfig(latent_dim=32, num_layers=1, n_speakers=4)
    model = RAG(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # give the near-identity init some reach
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    return model


def _server(max_batch=4, max_wait_ms=100.0, pipeline_depth=1):
    cfg = ServeConfig(max_batch=max_batch, max_wait_ms=max_wait_ms, steps=50,
                      timestep_respacing="ddim5", sampler="ddim",
                      pipeline_depth=pipeline_depth)
    model = _model()
    return build_rag_server(model, cfg, device="cpu"), model.cfg


def test_batcher_coalesces_and_pads():
    batcher, cfg = _server()
    try:
        calls = fused_mlp.fused_transmlp_reference.calls
        audio = np.random.default_rng(1).normal(size=16000).astype(np.float32)
        reqs = [batcher.submit(audio, speaker=i % 4, guidance=1.0 + 0.5 * i)
                for i in range(3)]
        outs = [r.wait(timeout=120) for r in reqs]
        for o in outs:
            assert o.shape == (cfg.njoints, cfg.nfeats, cfg.nframes)
            assert np.isfinite(o).all()
        st = batcher.stats()
        assert st["requests_served"] == 3
        assert st["batches_served"] <= 3
        # the default config takes the fused path: on the CPU its plain version
        assert fused_mlp.fused_transmlp_reference.calls - calls == 5 * st["batches_served"]
        assert not np.allclose(outs[0], outs[1])  # per-sample guidance
    finally:
        batcher.close()


def test_padding_rows_copy_row_zero():
    batcher, _ = _server(max_batch=4, max_wait_ms=20.0)
    seen = []
    real = batcher.sampler

    class Recorder:
        model = real.model

        def __call__(self, cond, generator, guidance):
            seen.append({k: v.clone() for k, v in cond.items()})
            return real(cond, generator, guidance=guidance)

    batcher.sampler = Recorder()
    try:
        audio = np.random.default_rng(2).normal(size=20000).astype(np.float32)
        batcher.generate(audio, speaker=3, timeout=120)
        (cond,) = seen
        assert cond["audio"].shape[0] == 4
        for i in range(1, 4):
            assert torch.equal(cond["audio"][i], cond["audio"][0])
            assert cond["vid"][i] == 3
    finally:
        batcher.close()


def test_batcher_audio_pad_and_trim():
    batcher, cfg = _server(max_batch=2)
    try:
        short = batcher.generate(np.ones(100, np.float32), timeout=120)
        long = batcher.generate(np.ones(10**6, np.float32), timeout=120)
        assert short.shape == long.shape == (cfg.njoints, cfg.nfeats, cfg.nframes)
    finally:
        batcher.close()


def test_backpressure_rejects_when_queue_full():
    batcher, _ = _server(max_batch=2, max_wait_ms=50.0)
    try:
        batcher.cfg.max_queue = 2
        batcher._q = queue.Queue(maxsize=2)
        # hold the device lock: the worker takes the first request, its
        # window expires and it blocks in dispatch; the rest stay queued
        with batcher._device_lock:
            batcher.submit(np.zeros(10, np.float32))
            time.sleep(0.5)
            batcher.submit(np.zeros(10, np.float32))
            batcher.submit(np.zeros(10, np.float32))
            with pytest.raises(ServerOverloaded):
                batcher.submit(np.zeros(10, np.float32))
            assert batcher.stats()["rejected"] == 1
            assert batcher.stats()["pending"] == 2
    finally:
        batcher.close()


def test_submit_after_close_rejected():
    batcher, _ = _server(max_batch=2)
    batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(np.zeros(10, np.float32))


def test_close_fails_queued_waiters_promptly():
    batcher, _ = _server(max_batch=1, max_wait_ms=1.0)
    try:
        real = batcher.sampler

        class Slow:
            model = real.model

            def __call__(self, *a, **k):
                time.sleep(0.5)
                return real(*a, **k)

        batcher.sampler = Slow()
        reqs = [batcher.submit(np.zeros(10, np.float32)) for _ in range(5)]
    finally:
        t0 = time.monotonic()
        batcher.close()
    for r in reqs:
        try:
            assert np.isfinite(r.wait(timeout=30)).all()
        except RuntimeError as e:
            assert "shutting down" in str(e)
    assert time.monotonic() - t0 < 30


def test_full_bucket_dispatches_before_window():
    batcher, _ = _server(max_batch=2, max_wait_ms=60_000.0)
    try:
        t0 = time.monotonic()
        reqs = [batcher.submit(np.zeros(10, np.float32)) for _ in range(2)]
        for r in reqs:
            assert np.isfinite(r.wait(timeout=60)).all()
        assert time.monotonic() - t0 < 30.0
    finally:
        batcher.close()


def test_close_resolves_bucketed_waiters_promptly():
    batcher, _ = _server(max_batch=4, max_wait_ms=60_000.0)
    try:
        req = batcher.submit(np.zeros(10, np.float32))
        deadline = time.monotonic() + 10.0
        while batcher._stash_len == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert batcher._stash_len == 1
    finally:
        t0 = time.monotonic()
        batcher.close()
    assert time.monotonic() - t0 < 30.0
    try:
        assert np.isfinite(req.wait(timeout=30)).all()
    except RuntimeError as e:
        assert "shutting down" in str(e)


def test_batcher_error_propagates():
    batcher, _ = _server(max_batch=2)
    try:
        class Boom:
            model = batcher.sampler.model

            def __call__(self, *a, **k):
                raise RuntimeError("kaboom")

        batcher.sampler = Boom()
        with pytest.raises(RuntimeError, match="kaboom"):
            batcher.submit(np.zeros(10, np.float32)).wait(timeout=60)
    finally:
        batcher.close()


def test_reload_params_swaps_and_validates():
    batcher, cfg = _server(max_batch=1, max_wait_ms=1.0, pipeline_depth=0)
    try:
        audio = np.random.default_rng(3).normal(size=16000).astype(np.float32)
        before = batcher.generate(audio, timeout=120)
        new = {k: v + 0.1 for k, v in batcher.sampler.model.state_dict().items()}
        assert batcher.reload_params(new) == 1
        batcher.reset_stats()
        after = batcher.generate(audio, timeout=120)
        assert not np.allclose(before, after)
        bad = dict(new)
        bad["pose_final.bias"] = torch.zeros(3)
        with pytest.raises(ValueError, match="pose_final.bias"):
            batcher.reload_params(bad)
        with pytest.raises(ValueError, match="differs"):
            batcher.reload_params({k: v for k, v in new.items() if k != "pose_final.bias"})
        assert batcher.stats()["param_version"] == 1
    finally:
        batcher.close()


def test_build_rag_server_is_single_device():
    with pytest.raises(ValueError, match="data_parallel"):
        build_rag_server(_model(), ServeConfig(data_parallel=2), device="cpu")


def test_port_imports_without_jax_triton_or_nvcc():
    """Every module of the port imports with jax, flax, triton and the JAX
    package unimportable and no nvcc on PATH, and pulls none of them in."""
    code = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "triton", "livelyspeaker_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import livelyspeaker_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
