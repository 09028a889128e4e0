"""The port's measurement studies (``scripts/soak_flagship.py``,
``scripts/measure_*.py``) and their shared helpers in
``scripts/eval_common.py``, against the JAX package's, on the CPU.

- ``fixture_fgd`` against the JAX ``scripts/eval_common.py:194`` on the
  same synthetic records, the same RAG npz (read through
  ``utils/convert.py``) and the same fixture embedder weights (JAX shapes
  from ``jax.eval_shape``, seeded normals), each side's sampler stubbed to
  return the same arrays: FGD within rel 1e-5; and one real DDIM run.
- ``xt_boundary_probe`` against the JAX ``:143`` on the same params,
  motion, noise (the JAX function's own key 5) and style draw: the same
  boundary timestep, x0 within 1e-5 of max|x0|; an out-of-range skip
  raises on both sides.
- ``soak_flagship.main`` at latent 32: two epochs in one process against
  one epoch and a resumed one, bit for bit, with the loss-second-moment
  sampler and the EMA on (their state carried by the resume too).
- each other study's ``main`` at its smallest settings: its JSON keys,
  with finite values; the TED semantic classifier scores 1.0 on the real
  test windows. ``measure_ema_warmup`` and ``measure_audio_bf16`` run
  ``train_rag`` in this process (the soak spawns its runs).
"""

# torch.optim's first step imports torch._dynamo, and with it cProfile and the
# standard library's ``profile``; some tests put the JAX ``scripts/`` directory,
# which holds a ``profile.py``, on sys.path for a while. Importing cProfile at
# collection keeps ``profile`` the standard library's in every worker.
import cProfile  # noqa: F401
import contextlib
import importlib.util
import io
import math
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import livelyspeaker_tpu.pipeline as jpipeline
import livelyspeaker_tpu_torch.pipeline as tpipeline
from livelyspeaker_tpu.data import TedWindowDataset as JTedWindowDataset
from livelyspeaker_tpu.diffusion import DiffusionSchedule as JSchedule
from livelyspeaker_tpu.eval import EmbeddingSpaceEvaluator as JEvaluator
from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.models import embedding_net as jemb
from livelyspeaker_tpu.training.checkpoints import save_params_npz as jsave_params_npz
from livelyspeaker_tpu_torch.data import TedWindowDataset
from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.eval import EmbeddingSpaceEvaluator
from livelyspeaker_tpu_torch.models import RAG, RAGConfig
from livelyspeaker_tpu_torch.scripts import (
    eval_common,
    measure_audio_bf16,
    measure_ema_warmup,
    measure_long_form_seams,
    measure_semantic_payoff,
    measure_semantic_payoff_beat,
    soak_flagship,
    train_rag,
)
from livelyspeaker_tpu_torch.training.checkpoints import save_args
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, random_normal_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
KW = dict(latent_dim=32, num_layers=2, n_speakers=40)
TINY = ["--latent_dim", "32", "--layers", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's CPU thread pool costs more than it gives
    here, and its spinning threads slow the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jec():
    """The JAX package's ``scripts/eval_common.py``, loaded under a name of
    its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_eval_common", os.path.join(REPO, "scripts", "eval_common.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _normals(shapes, seed):
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return random_normal_params(zeros, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """TED records, a RAG npz of seeded normals over the JAX tree (with its
    args.json) and the fixture embedder's weights."""
    root = tmp_path_factory.mktemp("studies")
    records = str(root / "ted")
    build_synthetic_ted_records(records, n_clips=2, clip_seconds=10, seed=31)
    first = JTedWindowDataset(records).batch([0], fields=("motion", "audio", "vid"))
    key = jax.random.PRNGKey(0)
    cond = {"audio": jnp.asarray(first["audio"]), "vid": jnp.asarray(first["vid"]),
            "origin_x": jnp.asarray(first["motion"])}
    rag = _normals(jax.eval_shape(lambda: JRAG(JRAGConfig.ted(**KW)).init(
        {"params": key, "style": key}, cond["origin_x"], jnp.zeros((1,), jnp.int32),
        cond))["params"], seed=3)
    npz = str(root / "rag" / "model000000100.npz")
    os.makedirs(os.path.dirname(npz))
    jsave_params_npz(npz, rag)
    save_args(os.path.dirname(npz), {"latent_dim": 32, "layers": 2, "n_speakers": 40})
    emb = _normals(jax.eval_shape(lambda: jemb.TedEmbeddingEncoder().init(
        key, jnp.zeros((1, 34, 27))))["params"], seed=4)
    for k in list(emb):
        if k.endswith("_bn_var"):
            emb[k] = np.abs(emb[k]) + 0.5
        elif k.endswith("_bn_scale"):
            emb[k] = 1.0 + emb[k]
    return {"records": records, "rag_params": rag, "npz": npz, "embedder": emb}


def test_fixture_fgd_matches_jax(files, jec, monkeypatch):
    """Both loops over the same records in order, batches of 8, each
    sampler stubbed to the same arrays: the FGD within rel 1e-5."""
    n_batches = len(TedWindowDataset(files["records"])) // 8
    assert n_batches >= 2
    gens = np.random.default_rng(5).normal(size=(n_batches, 8, 9, 3, 34)).astype(np.float32)
    calls = {"jax": 0, "port": 0}

    class JStub:
        def __init__(self, model, params, **kw):
            pass

        def __call__(self, cond, rng, guidance=1.0):
            calls["jax"] += 1
            return jnp.asarray(gens[calls["jax"] - 1])

    class TStub:
        def __init__(self, model, **kw):
            self.device = torch.device("cpu")

        def __call__(self, cond, generator=None, *, guidance=1.0):
            calls["port"] += 1
            return torch.from_numpy(gens[calls["port"] - 1])

    monkeypatch.setattr(jpipeline, "RAGSampler", JStub)
    monkeypatch.setattr(tpipeline, "RAGSampler", TStub)
    jfgd = jec.fixture_fgd(JRAG(JRAGConfig.ted(**KW)), JTedWindowDataset(files["records"]),
                           files["npz"], JEvaluator(files["embedder"]), batch_size=8)
    fixture = EmbeddingSpaceEvaluator(jax_params_to_state_dict(files["embedder"]), device="cpu")
    fgd = eval_common.fixture_fgd(RAG(RAGConfig.ted(**KW)), TedWindowDataset(files["records"]),
                                  files["npz"], fixture, batch_size=8, device="cpu")
    assert calls == {"jax": n_batches, "port": n_batches}
    assert abs(fgd - jfgd) <= TOL * abs(jfgd), (fgd, jfgd)


def test_fixture_fgd_samples_on_the_cpu(files):
    fgd = eval_common.fixture_fgd(RAG(RAGConfig.ted(**KW)), TedWindowDataset(files["records"]),
                                  files["npz"], eval_common.fixture_evaluator(device="cpu"),
                                  batch_size=8, timestep_respacing="ddim2", device="cpu")
    assert math.isfinite(fgd)


class _Jitted:
    """A Flax module whose ``apply`` is compiled once (op by op, the RAG's
    forward costs seconds on the CPU)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames=("train",))


def test_xt_boundary_probe_matches_jax(files, jec):
    """ddim10 over 1,000 steps, skip 8: the boundary is respaced index 1."""
    batch = JTedWindowDataset(files["records"]).batch(list(range(4)),
                                                      fields=("motion", "audio", "vid"))
    motion = batch["motion"]
    style = np.random.default_rng(6).normal(size=(4, 1, 32)).astype(np.float32)
    jcond = {"audio": jnp.asarray(batch["audio"]), "vid": jnp.asarray(batch["vid"]),
             "origin_x": jnp.asarray(motion), "style_eps": jnp.asarray(style)}
    sched = dict(steps=1000, schedule="cosine")
    jspaced = JSchedule.create(**sched, timestep_respacing="ddim10")
    jmodel = _Jitted(JRAG(JRAGConfig.ted(**KW)))
    jt, jx0 = jec.xt_boundary_probe(jspaced, JSchedule.create(**sched), jmodel,
                                    files["rag_params"], motion, jcond, 8)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(5), motion.shape))

    model = RAG(RAGConfig.ted(**KW))
    model.load_state_dict(jax_params_to_state_dict(files["rag_params"]))
    spaced = DiffusionSchedule.create(**sched, timestep_respacing="ddim10")
    cond = {"audio": torch.from_numpy(batch["audio"]), "vid": torch.from_numpy(batch["vid"]),
            "origin_x": torch.from_numpy(motion)}
    t, x0 = eval_common.xt_boundary_probe(spaced, DiffusionSchedule.create(**sched), model.eval(),
                                          motion, cond, 8, noise=torch.from_numpy(noise),
                                          style_eps=torch.from_numpy(style))
    assert t == jt == int(spaced.timestep_map[1])
    assert np.abs(x0 - np.asarray(jx0)).max() <= TOL * np.abs(np.asarray(jx0)).max()
    for skip in (10, -1):  # the boundary index outside [0, 10)
        with pytest.raises(AssertionError):
            jec.xt_boundary_probe(jspaced, JSchedule.create(**sched), jmodel,
                                  files["rag_params"], motion, jcond, skip)
        with pytest.raises(ValueError, match="out of range"):
            eval_common.xt_boundary_probe(spaced, DiffusionSchedule.create(**sched), model,
                                          motion, cond, skip)


def test_soak_resume_is_bit_exact_on_the_cpu(tmp_path):
    """Two epochs against one and a resumed one (three train_rag processes),
    the loss-second-moment sampler and the EMA on: the params, the EMA and
    the sampler's history the same bits."""
    out = soak_flagship.main(TINY + ["--epochs", "2", "--batch_size", "32", "--n_clips", "3",
                                     "--log_interval", "1000", "--out", str(tmp_path),
                                     "--device", "cpu"])
    assert out["resume_bit_exact"] and out["resume_max_param_delta"] == 0.0
    assert math.isfinite(out["fgd_raw"]) and math.isfinite(out["fgd_ema"])
    full, split = tmp_path / "full", tmp_path / "split"
    ema = soak_flagship.param_delta(eval_common.final_npz(str(full), "model_ema"),
                                    eval_common.final_npz(str(split), "model_ema"))
    assert ema[0] == 0.0
    # the split run stopped after its first epoch and resumed from there
    steps = sorted(int(p.name[5:14]) for p in split.glob("ckpt_*.pt"))
    assert len(steps) == 2 and steps[1] == 2 * steps[0]
    blobs = [torch.load(d / f"ckpt_{steps[1]:09d}.pt", weights_only=True) for d in (full, split)]
    for b in blobs:
        assert b["sampler_state"] is not None and b["ema_params"] is not None
    for k in ("history", "counts"):
        assert np.array_equal(np.asarray(blobs[0]["sampler_state"][k]),
                              np.asarray(blobs[1]["sampler_state"][k])), k


@pytest.fixture
def train_rag_here(monkeypatch):
    """``run_train_rag`` as ``train_rag.main`` in this process, its output
    captured (a process costs seconds of imports on the CPU)."""

    def run(argv, *, device=None, cudnn_deterministic=False, capture=False):
        argv = list(argv) + (["--device", str(device)] if device is not None else [])
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            train_rag.main(argv)
        return subprocess.CompletedProcess(argv, 0, out.getvalue(), err.getvalue())

    for module in (measure_ema_warmup, measure_audio_bf16):
        monkeypatch.setattr(module, "run_train_rag", run)


def _finite(d, keys):
    assert set(keys) <= set(d), sorted(d)
    for k in keys:
        assert math.isfinite(d[k]), (k, d[k])


STUDY_TRAIN = TINY + ["--epochs", "1", "--batch_size", "16", "--n_clips", "3",
                      "--log_interval", "2", "--device", "cpu"]


def test_ema_warmup_main(tmp_path, train_rag_here):
    out = measure_ema_warmup.main(STUDY_TRAIN + ["--out", str(tmp_path)])
    _finite(out, ["fgd_raw_plain", "fgd_ema_plain", "fgd_raw_warmup", "fgd_ema_warmup"])
    # the EMA observes the trajectory: the raw params are the same run's
    assert out["fgd_raw_plain"] == out["fgd_raw_warmup"]


def test_audio_bf16_main(tmp_path, train_rag_here):
    out = measure_audio_bf16.main(STUDY_TRAIN + ["--out", str(tmp_path)])
    _finite(out, ["final_loss_f32", "final_loss_bf16", "fgd_f32", "fgd_bf16", "fgd_rel_delta"])


def test_long_form_seams_main(files):
    out = measure_long_form_seams.main(
        ["--model_path", files["npz"], "--data_dir", files["records"], "--seconds", "5",
         "--respacing", "ddim2", "--fused", "--device", "cpu"])
    for rep in (out["trained"], out["random_baseline"]):
        assert rep["n_seams"] == 2 and rep["frames"] == 75
        _finite(rep, ["ratio_p95", "seam_mean", "seam_p95", "within_mean", "within_p95"])


SEMANTIC = TINY + ["--train_clips", "4", "--test_clips", "8", "--rag_steps", "2",
                   "--sag_steps", "2", "--clip_layers", "1", "--sag_latent", "32",
                   "--samples_per_window", "1", "--respacing", "ddim4", "--skip", "3",
                   "--batch_size", "8", "--device", "cpu"]


def _rows_finite(out, keys):
    _finite(out["header"], ["classifier_acc_on_real", "sketch_recall",
                            "x0hat_recall_at_boundary", "chance_recall"])
    for row in out["rows"]:
        _finite(row, keys)


def test_semantic_payoff_main():
    out = measure_semantic_payoff.main(SEMANTIC + ["--skip_sweep", "2", "--schedule_sweep",
                                                   "cosine", "--trajectory"])
    assert out["header"]["classifier_acc_on_real"] == 1.0
    assert [r["path"] for r in out["rows"]] == ["rag", "full", "rag", "full"] + ["full"] * 3
    _rows_finite(out, ["mode_recall", "fgd", "cond_fgd_mean"])
    assert len(out["trajectory"]["x0hat_recall_per_step"]) == 4 - 3


def test_semantic_payoff_beat_main():
    """Two modes: each FID takes the square root of a 300 x 300 product."""
    out = measure_semantic_payoff_beat.main(SEMANTIC + ["--modes", "2"])
    assert [r["path"] for r in out["rows"]] == ["rag", "full", "rag", "full"]
    _finite(out["header"], ["srgr_ceiling"])
    _rows_finite(out, ["mode_recall", "srgr", "fid", "cond_fid_mean"])
