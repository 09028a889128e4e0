"""The port's serving beyond plain one-window requests, on the CPU (tiny
models): text requests through the composition, long-form chains in the
batcher, and the HTTP front end (``livelyspeaker_tpu_torch.scripts.serve``).
Counterparts of the JAX package's tests of the same names in
tests/test_serving.py, plus the front end's own entry point,
``build_server``, on checkpoints written here."""

import base64
import copy
import http.client
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch import models
from livelyspeaker_tpu_torch.data import HashTokenizer
from livelyspeaker_tpu_torch.models import (
    RAG,
    SAG,
    CLIPTextConfig,
    CLIPTextEncoder,
    RAGConfig,
)
from livelyspeaker_tpu_torch.ops import fused_mlp
from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline
from livelyspeaker_tpu_torch.scripts import serve
from livelyspeaker_tpu_torch.serving import (
    GestureBatcher,
    ServeConfig,
    ServerOverloaded,
    build_rag_server,
)
from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz

from test_torch_clip_text import SMALL, _openai_state_dict

LONG_AUDIO = np.zeros(int(80 / 15 * 16000), np.float32)  # 80 frames: 3 windows
SMALL_CLIP = CLIPTextConfig(width=32, layers=1, heads=2, embed_dim=32)
FRONT_END_CLIP = dict(SMALL, embed_dim=512)  # feeds the front end's SAG at latent 512


def _model(cfg=None, seed=0):
    cfg = cfg or RAGConfig(latent_dim=32, num_layers=1, n_speakers=4)
    model = RAG(cfg, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # give the near-identity init some reach
        g = torch.Generator().manual_seed(seed + 1)
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _serve_cfg(**kw):
    base = dict(max_batch=2, max_wait_ms=10.0, steps=50, timestep_respacing="ddim5",
                sampler="ddim", pipeline_depth=1)
    base.update(kw)
    return ServeConfig(**base)


def _server(**kw):
    model = _model()
    return build_rag_server(model, _serve_cfg(**kw), device="cpu"), model.cfg


def _composition(model):
    g = torch.Generator().manual_seed(2)
    sag = SAG(latent_dim=32, ff_size=64, num_layers=1, num_heads=2, generator=g)
    clip = CLIPTextEncoder(SMALL_CLIP, generator=g)
    return LivelySpeakerPipeline(model, sag, clip, HashTokenizer(), steps=50,
                                 timestep_respacing="ddim5", skip_timesteps=2, device="cpu")


def _http(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}", t


def _post(url, obj, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(obj).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers, r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.headers, r.read()


def test_batcher_composition_with_text():
    """Text requests go through the composition, plain ones through the
    sampler; a reload swaps the refinement's weights too, here on a RAG
    module of its own, so a missed swap would show."""
    model = _model()
    pipe = _composition(copy.deepcopy(model))
    batcher = build_rag_server(model, _serve_cfg(max_wait_ms=100.0), composition=pipe,
                               device="cpu")
    assert batcher.sampler.model is not pipe.rag_sampler.model
    try:
        r_text = batcher.submit(np.zeros(100, np.float32), text="waves both hands")
        r_plain = batcher.submit(np.zeros(100, np.float32))
        a, b = r_text.wait(timeout=120), r_plain.wait(timeout=120)
        assert a.shape == b.shape == (9, 3, 34)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        new = {k: v * 1.5 for k, v in model.state_dict().items()}
        assert batcher.reload_params(new) == 1
        leaf = "pose_final.weight"
        assert model.state_dict()[leaf].abs().max() > 0
        for m in (batcher.sampler.model, pipe.rag_sampler.model):
            torch.testing.assert_close(m.state_dict()[leaf], new[leaf], rtol=0, atol=0)
        a2 = batcher.generate(np.zeros(100, np.float32), text="waves both hands", timeout=120)
        assert np.isfinite(a2).all()
    finally:
        batcher.close()


def test_mixed_text_plain_batches_split():
    """With a composition attached, text and plain requests never share a
    batch; both kinds are served."""
    model = _model()
    pipe = _composition(model)
    batcher = GestureBatcher(pipe.rag_sampler, _serve_cfg(max_batch=4, max_wait_ms=2000.0),
                             composition=pipe)
    seen = []
    real = batcher._dispatch

    def spy(batch):
        n_text = sum(1 for r in batch if r.text)
        seen.append((n_text, len(batch) - n_text))
        return real(batch)

    batcher._dispatch = spy
    try:
        reqs = [batcher.submit(np.zeros(100, np.float32), text="hello" if i % 2 == 0 else None)
                for i in range(4)]
        for r in reqs:
            assert np.isfinite(r.wait(timeout=120)).all()
            assert r.batch_size == 2
        assert all(t == 0 or p == 0 for t, p in seen), seen
        assert any(t for t, _ in seen) and any(p for _, p in seen), seen
    finally:
        batcher.close()


def test_long_form_admission_and_device_serialisation():
    """Long-form chains are capped at max_long_concurrent and interleave
    with short requests window by window."""
    batcher, cfg = _server(max_wait_ms=5.0)
    batcher.cfg.max_long_concurrent = 1
    try:
        gen = batcher.long_form_stream(LONG_AUDIO, speaker=0)
        first = next(gen)
        assert first[0] == 0
        assert batcher.stats()["long_active"] == 1
        with pytest.raises(ServerOverloaded):
            next(batcher.long_form_stream(LONG_AUDIO, speaker=1))
        assert batcher.stats()["rejected"] == 1
        short = batcher.generate(np.zeros(batcher.n_samples, np.float32), timeout=120)
        assert np.isfinite(short).all()
        rest = list(gen)
        assert batcher.stats()["long_active"] == 0
        total = int(len(LONG_AUDIO) * 15 / 16000)
        assert first[1].shape[-1] + sum(c.shape[-1] for _, c in rest) == total
        assert batcher.long_form(LONG_AUDIO, speaker=2).shape == (9, 3, total)
    finally:
        batcher.close()


def test_beat_model_serving_with_emotion():
    """A BEAT deployment threads each request's emotion into the
    conditioning, long-form windows included."""
    model = _model(RAGConfig.beat(njoints=5, latent_dim=32, num_layers=1, n_speakers=4))
    srv = build_rag_server(model, _serve_cfg(timestep_respacing="ddim4", max_wait_ms=5.0),
                           device="cpu")
    seen = []
    real = srv.sampler

    class Recorder:
        model = real.model

        def __call__(self, cond, generator, guidance):
            seen.append(cond["emo"].tolist())
            return real(cond, generator, guidance=guidance)

    srv.sampler = Recorder()
    try:
        out = srv.generate(np.zeros(srv.n_samples, np.float32), speaker=1, emotion=3,
                           timeout=120)
        assert out.shape == (5, 6, 34) and np.isfinite(out).all()
        assert seen[-1][0] == 3
        long_audio = np.zeros(int(70 / 15 * 16000), np.float32)
        long_out = srv.long_form(long_audio, emotion=2)
        assert long_out.shape == (5, 6, int(len(long_audio) * 15 / 16000))
        assert np.isfinite(long_out).all()
        assert all(e[0] == 2 for e in seen[1:]) and len(seen) == 4
    finally:
        srv.close()


def test_concurrent_long_chains_share_batches():
    batcher, cfg = _server(max_batch=4, max_wait_ms=40.0)
    batcher.cfg.max_long_concurrent = 2
    try:
        results = {}

        def run(tag, speaker):
            results[tag] = batcher.long_form(LONG_AUDIO, speaker=speaker)

        threads = [threading.Thread(target=run, args=a) for a in (("a", 1), ("b", 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        total = int(len(LONG_AUDIO) * 15 / 16000)
        assert results["a"].shape[-1] == results["b"].shape[-1] == total
        assert batcher.stats()["mean_batch_occupancy"] > 1.0, batcher.stats()
    finally:
        batcher.close()


def test_reload_concurrent_with_traffic():
    batcher, _ = _server(max_wait_ms=5.0, pipeline_depth=2)
    try:
        base = {k: v.clone() for k, v in batcher.sampler.model.state_dict().items()}
        audio = np.random.default_rng(5).normal(size=10).astype(np.float32)
        batcher.generate(audio, timeout=120)
        errors = []

        def client(n):
            for i in range(n):
                try:
                    assert np.isfinite(batcher.generate(audio, timeout=120, speaker=i % 4)).all()
                except Exception as e:  # noqa: BLE001 (asserted below)
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(6,)) for _ in range(3)]
        for t in threads:
            t.start()
        for v in range(4):
            batcher.reload_params({k: p * (1.0 + 0.1 * v) for k, p in base.items()})
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        st = batcher.stats()
        assert st["param_version"] == 4
        assert st["requests_served"] >= 19
    finally:
        batcher.close()


def test_http_server_roundtrip(tmp_path):
    batcher, cfg = _server(max_wait_ms=10.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(batcher, reload_token="sekrit"))
    url, _ = _http(srv)
    try:
        assert json.loads(_get(url + "/healthz")[1]) == {"ok": True, "devices": ["cpu"]}
        audio = np.full(1000, 0.1, np.float32)
        out = json.loads(_post(url + "/v1/generate",
                               {"audio": audio.tolist(), "speaker": 1, "guidance": 1.5})[1])
        assert out["shape"] == [cfg.njoints, cfg.nfeats, cfg.nframes]
        assert out["batch_size"] >= 1 and out["latency_ms"] > 0
        b64 = base64.b64encode(audio.tobytes()).decode()
        out2 = json.loads(_post(url + "/v1/generate", {"audio_b64": b64, "speaker": 1})[1])
        assert np.isfinite(np.asarray(out2["motion"])).all()
        stats = json.loads(_get(url + "/stats")[1])
        assert stats["requests_served"] >= 2
        assert stats["latency_ms_p50"] == round(stats["latency_ms_p50"], 2) > 0

        ckpt = str(tmp_path / "model_v2.npz")
        model = batcher.sampler.model
        save_params_npz(ckpt, {k: v * 2.0 for k, v in model.state_dict().items()}, model)
        for tok in ({}, {"token": "wrong"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/v1/reload", {"model_path": ckpt, **tok})
            assert e.value.code == 403
        out = json.loads(_post(url + "/v1/reload", {"model_path": ckpt, "token": "sekrit"})[1])
        assert out["ok"] is True and out["param_version"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/v1/reload", {"model_path": "/nonexistent.npz", "token": "sekrit"})
        assert e.value.code == 400
        assert json.loads(_get(url + "/stats")[1])["param_version"] == 1

        headers, body = _get(url + "/metrics")
        assert headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        assert "# TYPE livelyspeaker_requests_served counter" in text
        assert "livelyspeaker_param_version 1.0" in text
        assert "# TYPE livelyspeaker_long_active gauge" in text
        assert "# TYPE livelyspeaker_latency_ms_p99 gauge" in text
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()


def test_http_streaming_long_request():
    """'long' + 'stream' answers chunked NDJSON, a line a window; the
    windows concatenate to the blocking long answer from the same seed."""
    batcher, cfg = _server(max_wait_ms=5.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(batcher))
    url, _ = _http(srv)
    try:
        audio = [0.01] * len(LONG_AUDIO)
        batcher._generator.manual_seed(5)  # the worker is idle: no other draw
        headers, body = _post(url + "/v1/generate",
                              {"audio": audio, "speaker": 1, "long": True, "stream": True})
        assert headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(line) for line in body.splitlines() if line.strip()]
        assert [line["window"] for line in lines] == list(range(len(lines))) == [0, 1, 2]
        assert lines[0]["frames"] == cfg.nframes
        assert all(line["frames"] == cfg.nframes - cfg.n_pre_seq for line in lines[1:-1])
        assert sum(line["frames"] for line in lines) == int(len(audio) * 15 / 16000)
        streamed = np.concatenate([np.asarray(line["motion"], np.float32) for line in lines], -1)
        batcher._generator.manual_seed(5)
        whole = json.loads(_post(url + "/v1/generate",
                                 {"audio": audio, "speaker": 1, "long": True})[1])
        np.testing.assert_array_equal(streamed, np.asarray(whole["motion"], np.float32))

        # text on a server without a composition is flagged, not dropped
        _, body = _post(url + "/v1/generate",
                        {"audio": audio, "long": True, "stream": True, "text": "hi"})
        assert json.loads(body.splitlines()[0])["text_ignored"] is True
        out = json.loads(_post(url + "/v1/generate",
                               {"audio": audio, "long": True, "text": "hi"})[1])
        assert out["text_ignored"] is True

        # a 403 reads the body: the next request on the connection works
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
        conn.request("POST", "/v1/reload", body=json.dumps({"model_path": "/x.npz"}),
                     headers={"Content-Type": "application/json"})
        r1 = conn.getresponse()
        assert r1.status == 403
        r1.read()
        conn.request("GET", "/healthz")
        r2 = conn.getresponse()
        assert r2.status == 200 and json.loads(r2.read())["ok"] is True
        conn.close()

        # a long request past max_long_concurrent is a clean 503
        batcher.cfg.max_long_concurrent = 0
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/v1/generate", {"audio": audio, "long": True, "stream": True})
        assert e.value.code == 503
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()


def _checkpoints(tmp_path, with_sag=True):
    """A tiny RAG checkpoint with its args.json, a SAG at the front end's
    width (latent 512) and an OpenAI-format CLIP state dict at SMALL."""
    model = _model(seed=3)
    rag_path = str(tmp_path / "rag.npz")
    save_params_npz(rag_path, model.state_dict(), model)
    c = model.cfg
    save_args(str(tmp_path), {"njoints": c.njoints, "nfeats": c.nfeats, "n_poses": c.nframes,
                              "latent_dim": c.latent_dim, "layers": c.num_layers,
                              "mlpact": c.mlpact, "n_speakers": c.n_speakers,
                              "num_emotions": c.num_emotions})
    paths = {"model_path": rag_path}
    if with_sag:
        sag = SAG(njoints=c.njoints, nfeats=c.nfeats, latent_dim=512,
                  generator=torch.Generator().manual_seed(4))
        paths["sag_path"] = str(tmp_path / "sag.npz")
        save_params_npz(paths["sag_path"], sag.state_dict(), sag)
        paths["clip_path"] = str(tmp_path / "clip.pt")
        rng = np.random.default_rng(5)
        clip_sd = _openai_state_dict(rng, layers=SMALL["layers"], dtype=torch.float16)
        clip_sd["text_projection"] = torch.from_numpy(
            rng.normal(size=(SMALL["width"], 512)) / 8).to(torch.float16)
        torch.save(clip_sd, paths["clip_path"])
    return model, paths


def _argv(paths, *extra):
    argv = ["--port", "0", "--max_batch", "2", "--max_wait_ms", "5", "--steps", "50",
            "--timestep_respacing", "ddim5", "--composition_respacing", "ddim5",
            "--skip_steps", "3", "--reload_token", "tok", "--device", "cpu"]
    for k, v in paths.items():
        argv += [f"--{k}", v]
    return argv + list(extra)


@pytest.fixture
def small_clip_tower(monkeypatch):
    """The front end builds ViT-B/32's text tower; here a narrow one."""
    monkeypatch.setattr(models, "CLIPTextEncoder",
                        lambda generator=None: CLIPTextEncoder(CLIPTextConfig(**FRONT_END_CLIP),
                                                               generator=generator))


def test_build_server_serves_the_checkpoints(tmp_path, small_clip_tower):
    """build_server on a RAG, a SAG and a CLIP checkpoint: it loads them,
    warms the plain and the text route, and serves plain, text and long
    requests over HTTP; the composition's refinement drives the batcher's
    RAG; a reload from an npz swaps it."""
    model, paths = _checkpoints(tmp_path)
    srv, batcher = serve.build_server(_argv(paths, "--sampler", "plms"))
    url, thread = _http(srv)
    try:
        pipe = batcher.composition
        assert batcher.sampler.method == "plms"
        assert pipe.rag_sampler.model is batcher.sampler.model
        for k, v in model.state_dict().items():
            torch.testing.assert_close(batcher.sampler.model.state_dict()[k], v, rtol=0, atol=0)
        sd = torch.load(paths["clip_path"])
        torch.testing.assert_close(pipe.clip_text.token_embedding,
                                   sd["token_embedding.weight"].float(), rtol=0, atol=0)
        warm = batcher.stats()
        assert warm["requests_served"] == 2 and warm["batches_served"] == 2
        audio = np.full(20000, 0.05, np.float32).tolist()
        plain = json.loads(_post(url + "/v1/generate", {"audio": audio})[1])
        text = json.loads(_post(url + "/v1/generate", {"audio": audio, "text": "wave"})[1])
        for out in (plain, text):
            assert out["shape"] == [9, 3, 34] and "text_ignored" not in out
            assert np.isfinite(np.asarray(out["motion"])).all()
        long = json.loads(_post(url + "/v1/generate",
                                {"audio": audio * 3, "long": True, "text": "wave"})[1])
        assert long["shape"] == [9, 3, int(60000 * 15 / 16000)]
        out = json.loads(_post(url + "/v1/reload", {"model_path": paths["model_path"],
                                                    "token": "tok"})[1])
        assert out["param_version"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_build_server_refuses_what_it_cannot_serve(tmp_path, small_clip_tower):
    _, paths = _checkpoints(tmp_path)
    # --data_parallel 2 on the CPU serves: one mesh of two CPU shards under
    # the batcher's sampler and the composition, both routes warmed
    srv, batcher = serve.build_server(_argv(paths, "--data_parallel", "2"))
    try:
        assert batcher.sampler.mesh.size == 2
        assert batcher.composition.rag_sampler.mesh is batcher.sampler.mesh
        assert batcher.stats()["requests_served"] == 2
    finally:
        srv.server_close()
        batcher.close()
    with pytest.raises(SystemExit, match="data_parallel"):  # max_batch 2
        serve.build_server(_argv(paths, "--data_parallel", "3"))
    with pytest.raises(SystemExit, match="skip_steps"):
        serve.build_server(_argv(paths, "--skip_steps", "5"))
    with pytest.raises(SystemExit):  # argparse: not a sampler
        serve.build_server(_argv(paths, "--sampler", "euler"))


def test_front_end_warms_before_it_binds(tmp_path):
    """Without a composition, the warm-up is one plain request; the server
    is bound (a port is taken) only after it."""
    _, paths = _checkpoints(tmp_path, with_sag=False)
    calls = fused_mlp.fused_transmlp_reference.calls
    srv, batcher = serve.build_server(_argv(paths))
    try:
        assert batcher.composition is None
        assert batcher.stats()["requests_served"] == 1
        assert fused_mlp.fused_transmlp_reference.calls - calls == 5  # ddim5, fused default
        assert srv.server_address[1] > 0
        assert os.path.isfile(paths["model_path"])
    finally:
        srv.server_close()
        batcher.close()
