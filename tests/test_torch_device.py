"""The port's entry points run on the card unless the caller asks for the
CPU: without a CUDA device ``RAGSampler``, ``LivelySpeakerPipeline``,
``build_rag_server``, ``TrainLoop``, the HTTP front end's ``build_server``,
the four eval scripts' ``main``, ``EmbeddingSpaceEvaluator``, the BEAT
FID embedder, and the measurement and generation scripts (``bench_serve``,
``bench_train``, ``profile``, ``generate``), ``train_gesture_autoencoder``,
the studies (``soak_flagship``, ``measure_*``) and the distillation
experiments raise unless ``device="cpu"`` (``--device cpu``) is passed, and
run with it. Each new script answers ``--help`` when run as ``python -m
livelyspeaker_tpu_torch.scripts.<name>`` (or ``.experiments...``)."""

# torch.optim's first step imports torch._dynamo, and with it cProfile and the
# standard library's ``profile``; some tests put the JAX ``scripts/`` directory,
# which holds a ``profile.py``, on sys.path for a while. Importing cProfile at
# collection keeps ``profile`` the standard library's in every worker.
import cProfile  # noqa: F401
import contextlib
import io
import os
import runpy
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.data import HashTokenizer
from livelyspeaker_tpu_torch.data.synthetic import (
    build_synthetic_beat_records,
    build_synthetic_ted_records,
)
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.eval import EmbeddingSpaceEvaluator
from livelyspeaker_tpu_torch.models import (
    RAG,
    SAG,
    CLIPTextConfig,
    CLIPTextEncoder,
    RAGConfig,
    audio_samples_for_frames,
)
from livelyspeaker_tpu_torch.models.embedding_net import TedEmbeddingEncoder
from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline, RAGSampler
from livelyspeaker_tpu_torch.experiments.distillation import distill_rag, measure_distill_quality
from livelyspeaker_tpu_torch.scripts import (
    bench_serve,
    bench_train,
    eval_common,
    eval_livelyspeaker_beat,
    eval_livelyspeaker_ted,
    eval_rag_beat,
    eval_rag_ted,
    generate,
    measure_audio_bf16,
    measure_ema_warmup,
    measure_long_form_seams,
    measure_semantic_payoff,
    measure_semantic_payoff_beat,
    profile,
    soak_flagship,
    train_gesture_autoencoder,
    train_multihost_demo,
    train_rag,
)
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


@contextlib.contextmanager
def _one_torch_thread():
    """The eval entries' tensors are small: torch's CPU thread pool costs
    more than it gives here, and its spinning threads slow the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _eval_script(module, beat):
    """``module.main`` on one batch of synthetic records and a checkpoint of
    ``model`` (a BEAT model of the same width for the BEAT scripts), ddim2;
    the composition scripts refine the last step."""

    def entry(model, device=None):
        with tempfile.TemporaryDirectory() as d, _one_torch_thread():
            data = os.path.join(d, "records")
            if beat:
                build_synthetic_beat_records(data, n_clips=1, clip_seconds=5, seed=3)
                c = model.cfg
                model = RAG(RAGConfig.beat(latent_dim=c.latent_dim, num_layers=c.num_layers,
                                           n_speakers=30))
            else:
                build_synthetic_ted_records(data, n_clips=1, clip_seconds=10, seed=3)
            path = os.path.join(d, "rag.npz")
            save_params_npz(path, model.state_dict(), model)
            save_args(d, {"latent_dim": model.cfg.latent_dim, "layers": model.cfg.num_layers,
                          "n_speakers": model.cfg.n_speakers})
            argv = ["--model_path", path, "--data_dir", data, "--batch_size", "4",
                    "--diffusion_steps", "20", "--timestep_respacing", "ddim2",
                    "--skip_steps", "1", "--fused"]
            results = module.main(argv + (["--device", device] if device else []))
        assert results and all(np.isfinite(r[2]) for r in results)
        return torch.device(device)

    return entry


def _evaluator(model, device=None):
    with _one_torch_thread():
        ev = EmbeddingSpaceEvaluator(TedEmbeddingEncoder().state_dict(), device=device)
        ev.push_samples(np.zeros((2, 34, 27), np.float32), np.ones((2, 34, 27), np.float32))
    return ev.device


def _beat_embedder(model, device=None):
    from test_torch_convert import reference_state_dict

    with tempfile.TemporaryDirectory() as d, _one_torch_thread():
        path = os.path.join(d, "best_rec.bin")
        torch.save({"model_state": reference_state_dict("beat_half_embedding")}, path)
        args = type("Args", (), {"eval_model_path": path, "device": device})()
        feats = eval_common.load_beat_embedder(args)(np.zeros((2, 34, 282), np.float32))
    assert feats.shape == (2, 300) and np.isfinite(feats).all()
    return torch.device(device)


def _script_argv(model, device):
    c = model.cfg
    return (["--latent_dim", str(c.latent_dim), "--layers", str(c.num_layers)]
            + (["--device", device] if device else []))


def _bench_serve(model, device=None):
    """The bench at ``model``'s width (it builds its own seeded model)."""
    with _one_torch_thread():
        out = bench_serve.main(_script_argv(model, device) + [
            "--burst", "2", "--max_batch", "2", "--clients", "1", "--max_wait_ms", "5",
            "--steps", "20", "--timestep_respacing", "ddim2", "--sampler", "ddim"])
    assert out["clips_per_sec"] > 0
    return torch.device(out["device"])


def _bench_train(model, device=None):
    with _one_torch_thread():
        rows = bench_train.main(_script_argv(model, device) + [
            "--batch", "2", "--steps", "1", "--dtypes", "float32", "--fused_train"])
    assert np.isfinite(rows[0]["final_loss"])
    return torch.device(device)


def _profile(model, device=None):
    """The sampler's trace at the TED configuration, two steps."""
    with tempfile.TemporaryDirectory() as d, _one_torch_thread():
        path = profile.main(["--what", "sampler", "--batch", "1", "--iters", "1", "--steps",
                             "20", "--timestep_respacing", "ddim2", "--sampler", "ddim",
                             "--trace_dir", d] + (["--device", device] if device else []))
        assert os.path.getsize(path) > 0
    return torch.device(device)


def _generate(model, device=None):
    """``generate.run`` on a checkpoint of ``model`` (with its args.json)."""
    with tempfile.TemporaryDirectory() as d, _one_torch_thread():
        path = os.path.join(d, "rag.npz")
        save_params_npz(path, model.state_dict(), model)
        c = model.cfg
        save_args(d, {"latent_dim": c.latent_dim, "layers": c.num_layers,
                      "n_speakers": c.n_speakers})
        motion, _ = generate.run(generate.parse_args(
            ["--model_path", path, "--fused", "--diffusion_steps", "20",
             "--timestep_respacing", "ddim2"] + (["--device", device] if device else [])))
    assert motion.shape == (34, 27) and np.isfinite(motion).all()
    return torch.device(device)


def _train_gesture_ae(model, device=None):
    """``train_gesture_autoencoder.main`` for one step on tiny records."""
    with tempfile.TemporaryDirectory() as d, _one_torch_thread():
        build_synthetic_ted_records(os.path.join(d, "records"), n_clips=1, clip_seconds=4)
        out = train_gesture_autoencoder.main(
            ["--data_dir", os.path.join(d, "records"), "--batch_size", "2", "--epochs", "1",
             "--base", "8", "--save_dir", os.path.join(d, "ae")]
            + (["--device", device] if device else []))
    return next(out["model"].parameters()).device


def _multihost_demo(model, device=None):
    """The demo as a group of one process, one step on two local shards."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with _one_torch_thread():
        losses = train_multihost_demo.main(
            ["--coordinator", f"localhost:{port}", "--num_processes", "1", "--process_id", "0",
             "--devices_per_process", "2", "--steps", "1", "--local_batch", "2",
             "--latent_dim", str(model.cfg.latent_dim), "--layers", str(model.cfg.num_layers)]
            + (["--platform", device] if device else []))
    assert len(losses) == 1 and np.isfinite(losses[0])
    return torch.device(device)


def _train_rag_here(argv, *, device=None, cudnn_deterministic=False, capture=False):
    """The studies' ``run_train_rag`` as ``train_rag.main`` in this process
    (a process costs seconds of imports on the CPU); it must be handed the
    study's ``--device``."""
    assert device == "cpu", device
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        train_rag.main(list(argv) + ["--device", "cpu"])
    return subprocess.CompletedProcess(argv, 0, out.getvalue(), err.getvalue())


def _study(module, extra):
    """A study's ``main`` at latent 32 on 3 clips, one or two epochs, its
    train_rag runs in this process."""

    def entry(model, device=None):
        with tempfile.TemporaryDirectory() as d, _one_torch_thread(), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "run_train_rag", _train_rag_here)
            out = module.main(["--latent_dim", "32", "--layers", "1", "--batch_size", "32",
                               "--n_clips", "3", "--log_interval", "1000", "--out", d]
                              + extra + (["--device", device] if device else []))
        assert all(np.isfinite(v) for k, v in out.items() if k.startswith("fgd"))
        return torch.device(device)

    return entry


def _long_form_seams(model, device=None):
    """The seam report over 5 s of audio of tiny records, ddim2, fused."""
    with tempfile.TemporaryDirectory() as d, _one_torch_thread():
        build_synthetic_ted_records(os.path.join(d, "records"), n_clips=1, clip_seconds=5)
        path = os.path.join(d, "rag.npz")
        save_params_npz(path, model.state_dict(), model)
        c = model.cfg
        save_args(d, {"latent_dim": c.latent_dim, "layers": c.num_layers,
                      "n_speakers": c.n_speakers})
        out = measure_long_form_seams.main(
            ["--model_path", path, "--data_dir", os.path.join(d, "records"), "--seconds", "5",
             "--respacing", "ddim2", "--fused", "--no-with_random_baseline"]
            + (["--device", device] if device else []))
    assert np.isfinite(out["trained"]["ratio_p95"])
    return torch.device(device)


def _semantic(module):
    def entry(model, device=None):
        with _one_torch_thread():
            out = module.main(["--modes", "2", "--train_clips", "2", "--test_clips", "4",
                               "--rag_steps", "1", "--sag_steps", "1", "--latent_dim", "32",
                               "--layers", "1", "--clip_layers", "1", "--sag_latent", "32",
                               "--samples_per_window", "1", "--respacing", "ddim2",
                               "--skip", "1", "--batch_size", "4"]
                              + (["--device", device] if device else []))
        assert len(out["rows"]) == 4
        return torch.device(device)

    return entry


def _distill_rag(model, device=None):
    """One round of 1 step from a checkpoint of ``model``."""
    with tempfile.TemporaryDirectory() as d, _one_torch_thread():
        build_synthetic_ted_records(os.path.join(d, "records"), n_clips=1, clip_seconds=4)
        path = os.path.join(d, "rag.npz")
        save_params_npz(path, model.state_dict(), model)
        c = model.cfg
        save_args(d, {"latent_dim": c.latent_dim, "layers": c.num_layers,
                      "n_speakers": c.n_speakers})
        out = distill_rag.main(["--model_path", path, "--data_dir", os.path.join(d, "records"),
                                "--save_dir", os.path.join(d, "out"), "--start_grid", "4",
                                "--rounds", "1", "--steps_per_round", "1", "--batch_size", "2"]
                               + (["--device", device] if device else []))
        assert out["timestep_respacing"] == "ddim2" and os.path.exists(out["students"][0])
    return torch.device(device)


def _distill_quality(model, device=None):
    with _one_torch_thread():
        out = measure_distill_quality.main(
            ["--train_steps", "1", "--distill_steps", "1", "--rounds", "1", "--start_grid", "4",
             "--latent_dim", "32", "--layers", "1", "--batch_size", "8", "--modes", "2",
             "--n_clips", "2"] + (["--device", device] if device else []))
    assert len(out["rows"]) == 4 and all(np.isfinite(r["fgd"]) for r in out["rows"])
    return torch.device(device)


@pytest.mark.parametrize("entry", [_sampler, _pipeline, _server, _train, _front_end,
                                   _eval_script(eval_rag_ted, beat=False),
                                   _eval_script(eval_rag_beat, beat=True),
                                   _eval_script(eval_livelyspeaker_ted, beat=False),
                                   _eval_script(eval_livelyspeaker_beat, beat=True),
                                   _evaluator, _beat_embedder, _bench_serve, _bench_train,
                                   _profile, _generate, _train_gesture_ae, _multihost_demo,
                                   _study(soak_flagship, ["--epochs", "2"]),
                                   _study(measure_ema_warmup, ["--epochs", "1"]),
                                   _study(measure_audio_bf16, ["--epochs", "1"]),
                                   _long_form_seams, _semantic(measure_semantic_payoff),
                                   _semantic(measure_semantic_payoff_beat), _distill_rag,
                                   _distill_quality],
                         ids=["RAGSampler", "LivelySpeakerPipeline", "build_rag_server",
                              "TrainLoop", "serve.build_server", "eval_rag_ted.main",
                              "eval_rag_beat.main", "eval_livelyspeaker_ted.main",
                              "eval_livelyspeaker_beat.main", "EmbeddingSpaceEvaluator",
                              "load_beat_embedder", "bench_serve.main", "bench_train.main",
                              "profile.main", "generate.run",
                              "train_gesture_autoencoder.main",
                              "train_multihost_demo.main", "soak_flagship.main",
                              "measure_ema_warmup.main", "measure_audio_bf16.main",
                              "measure_long_form_seams.main", "measure_semantic_payoff.main",
                              "measure_semantic_payoff_beat.main", "distill_rag.main",
                              "measure_distill_quality.main"])
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


@pytest.mark.parametrize("script", ["eval_rag_ted", "eval_rag_beat", "eval_livelyspeaker_ted",
                                    "eval_livelyspeaker_beat", "convert_checkpoint", "profile",
                                    "bench_data", "bench_train", "bench_serve", "soak_serve",
                                    "generate", "build_ted_records", "build_beat_records",
                                    "train_gesture_autoencoder", "train_multihost_demo",
                                    "soak_flagship", "measure_ema_warmup", "measure_audio_bf16",
                                    "measure_long_form_seams", "measure_semantic_payoff",
                                    "measure_semantic_payoff_beat",
                                    "experiments.distillation.distill_rag",
                                    "experiments.distillation.measure_distill_quality"])
def test_new_scripts_answer_help(script, monkeypatch, capsys):
    """``python -m livelyspeaker_tpu_torch.scripts.<script> --help`` (a
    dotted name: ``livelyspeaker_tpu_torch.<script>``), run the way ``-m``
    runs it, in this process."""
    module = script if "." in script else f"scripts.{script}"
    monkeypatch.setattr(sys, "argv", [script, "--help"])
    with warnings.catch_warnings(), pytest.raises(SystemExit) as exit_:
        # runpy warns that the module was imported before: this file imports it
        warnings.filterwarnings("ignore", ".*found in sys.modules", RuntimeWarning)
        runpy.run_module(f"livelyspeaker_tpu_torch.{module}", run_name="__main__")
    assert exit_.value.code == 0
    assert "usage:" in capsys.readouterr().out
