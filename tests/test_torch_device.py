"""The port's entry points run on the card unless the caller asks for the
CPU: without a CUDA device ``RAGSampler``, ``LivelySpeakerPipeline``,
``build_rag_server``, ``TrainLoop`` and the HTTP front end's
``build_server`` raise unless ``device="cpu"`` (``--device cpu``) is
passed, and run with it."""

import os
import tempfile

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.data import HashTokenizer
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import (
    RAG,
    SAG,
    CLIPTextConfig,
    CLIPTextEncoder,
    RAGConfig,
    audio_samples_for_frames,
)
from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline, RAGSampler
from livelyspeaker_tpu_torch.scripts.serve import build_server
from livelyspeaker_tpu_torch.serving import ServeConfig, build_rag_server
from livelyspeaker_tpu_torch.training import TrainConfig
from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz
from livelyspeaker_tpu_torch.training.loop import TrainLoop
from livelyspeaker_tpu_torch.utils.device import place_model


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _model():
    return RAG(RAGConfig(latent_dim=32, num_layers=1, n_speakers=4),
               generator=torch.Generator().manual_seed(0))


def _batch(cfg, b=2):
    rng = np.random.default_rng(0)
    return {
        "motion": rng.normal(size=(b, cfg.njoints, cfg.nfeats, cfg.nframes)).astype(np.float32),
        "audio": rng.normal(size=(b, audio_samples_for_frames(cfg.nframes))).astype(np.float32),
        "vid": rng.integers(0, cfg.n_speakers, size=(b,)),
    }


def _sampler(model, **kw):
    sampler = RAGSampler(model, steps=20, timestep_respacing="ddim2", use_fused=True, **kw)
    b = _batch(model.cfg)
    cond = {"audio": torch.from_numpy(b["audio"]), "vid": torch.from_numpy(b["vid"]),
            "origin_x": torch.from_numpy(b["motion"])}
    out = sampler(cond, torch.Generator().manual_seed(1))
    assert out.shape == b["motion"].shape and bool(torch.isfinite(out).all())
    return sampler.device


def _pipeline(model, **kw):
    """A tiny composition: SAG and CLIP text tower at width 32, ddim2 with
    one of its two steps skipped."""
    g = torch.Generator().manual_seed(2)
    sag = SAG(latent_dim=32, ff_size=64, num_layers=1, generator=g)
    clip = CLIPTextEncoder(CLIPTextConfig(width=32, layers=1, heads=4, embed_dim=32),
                           generator=g)
    pipe = LivelySpeakerPipeline(model, sag, clip, HashTokenizer(), steps=20,
                                 timestep_respacing="ddim2", skip_timesteps=1, use_fused=True,
                                 **kw)
    b = _batch(model.cfg)
    cond = {"audio": torch.from_numpy(b["audio"]), "vid": torch.from_numpy(b["vid"]),
            "origin_x": torch.from_numpy(b["motion"])}
    out = pipe(["hello there", "the river"], cond, torch.Generator().manual_seed(1))
    assert out.shape == b["motion"].shape and bool(torch.isfinite(out).all())
    for m in (sag, clip):
        assert next(m.parameters()).device == pipe.device
    return pipe.device


def _server(model, **kw):
    cfg = ServeConfig(max_batch=2, max_wait_ms=10.0, steps=20, timestep_respacing="ddim2",
                      sampler="ddim")
    batcher = build_rag_server(model, cfg, **kw)
    try:
        clip = batcher.generate(np.zeros(batcher.n_samples, np.float32), timeout=120)
        assert clip.shape == (9, 3, 34) and np.isfinite(clip).all()
        return batcher.device
    finally:
        batcher.close()


def _front_end(model, device=None):
    """The front end on a checkpoint of ``model`` (with its args.json): it
    warms one request through its batcher before it binds."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rag.npz")
        save_params_npz(path, model.state_dict(), model)
        c = model.cfg
        save_args(d, {"latent_dim": c.latent_dim, "layers": c.num_layers,
                      "n_speakers": c.n_speakers})
        argv = ["--model_path", path, "--port", "0", "--max_batch", "2", "--steps", "20",
                "--timestep_respacing", "ddim2", "--sampler", "ddim"]
        srv, batcher = build_server(argv + (["--device", device] if device else []))
    try:
        assert batcher.stats()["requests_served"] == 1
        return batcher.device
    finally:
        srv.server_close()
        batcher.close()


def _train(model, **kw):
    loop = TrainLoop(model, DiffusionSchedule.create(steps=20), None, [_batch(model.cfg)],
                     cfg=TrainConfig(lr=1e-3), num_epochs=1, log_interval=1000, seed=3, **kw)
    loop.run_loop()
    assert loop.step == 1
    return loop.device


@pytest.mark.parametrize("entry", [_sampler, _pipeline, _server, _train, _front_end],
                         ids=["RAGSampler", "LivelySpeakerPipeline", "build_rag_server",
                              "TrainLoop", "serve.build_server"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(no_card, entry):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry(_model())
    model = _model()
    assert entry(model, device="cpu") == torch.device("cpu")
    assert next(model.parameters()).device == torch.device("cpu")


def test_place_model_rule(no_card):
    """None means the card (and raises without one); an explicit device is
    taken as given, also as a torch.device."""
    model = _model()
    with pytest.raises(RuntimeError, match="TrainLoop runs on an NVIDIA GPU by default"):
        place_model(model, None, "TrainLoop")
    assert place_model(model, "cpu", "x") == torch.device("cpu")
    assert place_model(model, torch.device("cpu"), "x") == torch.device("cpu")
