"""The port's four eval entry points against the JAX package's scripts.

Both packages read the same synthetic TED and BEAT records, the same RAG
npz (latent 64, 2 blocks) and the same evaluator checkpoints in the
reference's layout. The sampler (or the composition) is replaced on both
sides by one deterministic stub, a function of the conditioning, the
sentences and the guidance, so what is compared is the scripts' own work:
batches, random speakers, layouts, the metrics and their sums. Each JAX
script runs once for the module (``jax_runs``), with its metric functions
wrapped to record what they return.

- TED: beat-align (each batch's ``ted_beat_align_batch``, the sums) and
  motion_beats exactly; FGD, diversity and feat_dist within rel 1e-5.
- BEAT: align and SRGR within 1e-6 abs (the euler angles go through the
  port's torch rotations); FID and diversity within rel 1e-5.
- The printed lines have the JAX scripts' format.

Then each script runs for real on ``--device cpu`` at small width (2
blocks, latent 64, ``ddim10``) and every number is finite.
"""

import ast
import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.data.synthetic import (
    build_synthetic_beat_records,
    build_synthetic_ted_records,
)
from livelyspeaker_tpu_torch.models import SAG, RAG, RAGConfig
from livelyspeaker_tpu_torch.scripts import (
    eval_common,
    eval_livelyspeaker_beat,
    eval_livelyspeaker_ted,
    eval_rag_beat,
    eval_rag_ted,
)
from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz
from test_torch_convert import reference_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # FGD, FID, diversity, feat_dist: f32 embedding nets on two frameworks
BEAT_ABS = 1e-6  # align and SRGR through the torch euler angles


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: torch's CPU thread pool costs more than it
    gives here, and its spinning threads slow the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Records, checkpoints with their args.json, evaluator checkpoints."""
    root = tmp_path_factory.mktemp("eval_files")
    out = {"ted": str(root / "ted"), "beat": str(root / "beat")}
    build_synthetic_ted_records(out["ted"], n_clips=3, clip_seconds=10, seed=31)
    build_synthetic_beat_records(out["beat"], n_clips=2, clip_seconds=5, seed=32)
    for name, cfg in (("ted_rag", RAGConfig.ted(latent_dim=64, num_layers=2, n_speakers=40)),
                      ("beat_rag", RAGConfig.beat(latent_dim=64, num_layers=2, n_speakers=30))):
        d = root / name
        d.mkdir()
        model = RAG(cfg, generator=torch.Generator().manual_seed(5))
        save_params_npz(str(d / "model000000100.npz"), model.state_dict(), model)
        save_args(str(d), {"latent_dim": 64, "layers": 2, "n_speakers": cfg.n_speakers})
        out[name] = str(d / "model000000100.npz")
    out["ted_eval"] = str(root / "ted_evaluator.bin")
    torch.save({"gen_dict": reference_state_dict("ted_evaluator", seed=7), "pose_dim": 27},
               out["ted_eval"])
    out["beat_eval"] = str(root / "best_rec.bin")
    torch.save({"model_state": reference_state_dict("beat_half_embedding", seed=8)},
               out["beat_eval"])
    sag = SAG(njoints=47, nfeats=6, latent_dim=512, generator=torch.Generator().manual_seed(9))
    out["beat_sag"] = str(root / "sag_beat.npz")
    save_params_npz(out["beat_sag"], sag.state_dict(), sag)
    return out


def _stub_motion(cond, guidance, calls, sentences=None):
    """A deterministic 'sample': the real motion, scaled by the guidance,
    plus seeded noise by call number (and the sentence lengths)."""
    x = np.asarray(cond["origin_x"], np.float32)
    noise = np.random.default_rng(calls).normal(size=x.shape).astype(np.float32)
    out = (0.9 + 0.05 * guidance) * x + 0.05 * noise
    if sentences is not None:
        out = out + 0.001 * np.asarray([len(s) for s in sentences], np.float32)[:, None, None,
                                                                             None]
    return torch.from_numpy(out.astype(np.float32))


class StubSampler:
    """Stands in for RAGSampler in either package."""

    def __init__(self, *args, **kw):
        self.device = torch.device("cpu")
        self.calls = 0

    def __call__(self, cond, rng=None, *, guidance=1.5, **kw):
        self.calls += 1
        return _stub_motion(cond, guidance, self.calls)


class StubPipe(StubSampler):
    """Stands in for the composition in either package."""

    skip_timesteps = 80

    def __call__(self, sentences, cond, rng=None, *, guidance=1.5):
        self.calls += 1
        return _stub_motion(cond, guidance, self.calls, sentences)


def _recording(log, fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append(out)
        return out
    return wrapped


def _instrument(mp, module, log):
    """Wrap the metric entry points a script module uses, where it has them:
    their returns go to ``log[name]``."""
    for name in ("ted_beat_align_batch", "frechet_from_samples", "diversity_score"):
        if hasattr(module, name):
            mp.setattr(module, name, _recording(log.setdefault(name, []), getattr(module, name)))
    if hasattr(module, "EmbeddingSpaceEvaluator"):
        base = module.EmbeddingSpaceEvaluator
        scores = log.setdefault("get_scores", [])
        divs = log.setdefault("get_diversity_scores", [])

        class Recorded(base):
            def get_scores(self):
                return _recording(scores, super().get_scores)()

            def get_diversity_scores(self):
                return _recording(divs, super().get_diversity_scores)()

        Recorded.from_torch_checkpoint = classmethod(
            lambda cls, *a, **kw: _as(cls, base.from_torch_checkpoint(*a, **kw)))
        mp.setattr(module, "EmbeddingSpaceEvaluator", Recorded)
    for name, method in (("SRGR", "avg"), ("Alignment", "score")):
        if hasattr(module, name):
            base = getattr(module, name)
            calls = log.setdefault(f"{name}.{method}", [])
            mp.setattr(module, name, type(name, (base,), {
                method: lambda self, *a, _m=method, _b=base, _c=calls, **kw:
                _recording(_c, getattr(_b, _m).__get__(self))(*a, **kw)}))


def _as(cls, obj):
    obj.__class__ = cls
    return obj


def _argv(files, kind, extra=()):
    base = {"rag_ted": ["--model_path", files["ted_rag"], "--data_dir", files["ted"],
                        "--eval_model_path", files["ted_eval"]],
            "rag_beat": ["--model_path", files["beat_rag"], "--data_dir", files["beat"],
                         "--eval_model_path", files["beat_eval"]],
            "ls_ted": ["--model_path", files["ted_rag"], "--data_dir", files["ted"],
                       "--eval_model_path", files["ted_eval"]]}[kind]
    return base + ["--batch_size", "8"] + list(extra)


def _run_printing(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def jax_runs(files, tmp_path_factory):
    """Each JAX script once, its sampler or composition stubbed: {kind:
    (printed text, recorded metric returns)}, and BEAT's run_sweep
    results."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LS_TPU_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
        mp.syspath_prepend(os.path.join(REPO, "scripts"))
        import eval_livelyspeaker_beat as j_ls_beat
        import eval_livelyspeaker_ted as j_ls_ted
        import eval_rag_beat as j_rag_beat
        import eval_rag_ted as j_rag_ted
        from livelyspeaker_tpu.data import DataLoader as JLoader
        from livelyspeaker_tpu.data.beat import BeatWindowDataset as JBeat

        for kind, module, patch in (("rag_ted", j_rag_ted, "RAGSampler"),
                                    ("rag_beat", j_rag_beat, "RAGSampler"),
                                    ("ls_ted", j_ls_ted, "build_pipeline")):
            log = {}
            with pytest.MonkeyPatch.context() as inner:
                _instrument(inner, module, log)
                inner.setattr(module, patch, StubPipe if patch == "build_pipeline"
                              else StubSampler)
                inner.setattr(sys, "argv", [f"{kind}.py"] + _argv(files, kind))
                _, text = _run_printing(module.main)
            runs[kind] = (text, log)
        args = type("A", (), {"eval_model_path": files["beat_eval"]})()
        ds = JBeat(files["beat"])
        loader = JLoader(ds, batch_size=4, shuffle=True, drop_last=True, seed=233)
        runs["ls_beat"] = _run_printing(j_ls_beat.run_sweep, ds, loader, StubPipe(),
                                        j_ls_beat.load_beat_embedder(args), 47, 34)
    return runs


def _port_run(kind, files, monkeypatch):
    module = {"rag_ted": eval_rag_ted, "rag_beat": eval_rag_beat,
              "ls_ted": eval_livelyspeaker_ted}[kind]
    log = {}
    _instrument(monkeypatch, module, log)
    if kind == "ls_ted":  # its batches are scored by eval_rag_ted's helpers
        monkeypatch.setattr(eval_rag_ted, "ted_beat_align_batch", _recording(
            log.setdefault("ted_beat_align_batch", []), eval_rag_ted.ted_beat_align_batch))
    if kind == "ls_ted":
        monkeypatch.setattr(module, "build_pipeline", StubPipe)
    else:
        monkeypatch.setattr(eval_rag_ted, "RAGSampler", StubSampler)
    results, text = _run_printing(module.main, _argv(files, kind, ["--device", "cpu"]))
    return results, text, log


def _close(a, b, rel=TOL, abs_=0.0):
    return abs(a - b) <= max(rel * abs(b), abs_)


def _lines(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def _fields(line):
    return dict(re.findall(r"(\w+)=([-\w.]+)", line))


@pytest.mark.parametrize("kind", ["rag_ted", "ls_ted"])
def test_ted_scripts_match_jax(kind, files, jax_runs, monkeypatch):
    jtext, jlog = jax_runs[kind]
    results, text, log = _port_run(kind, files, monkeypatch)
    # every batch's beat-align sums, in order, bit for bit
    assert log["ted_beat_align_batch"] == jlog["ted_beat_align_batch"]
    assert len(log["ted_beat_align_batch"]) == (3 if kind == "rag_ted" else 2) * 4
    for (fd, feat), (jfd, jfeat) in zip(log["get_scores"], jlog["get_scores"], strict=True):
        assert _close(fd, jfd) and _close(feat, jfeat), (fd, jfd, feat, jfeat)
    for d, jd in zip(log["get_diversity_scores"], jlog["get_diversity_scores"], strict=True):
        assert _close(d, jd)
    prefix = "guidance=" if kind == "rag_ted" else "skip="
    ours, theirs = _lines(text, prefix), _lines(jtext, prefix)
    assert len(ours) == len(theirs) == len(results) == (3 if kind == "rag_ted" else 2)
    for line, jline, r in zip(ours, theirs, results):
        a, b = _fields(line), _fields(jline)
        assert a.keys() == b.keys()
        assert a["beat_align"] == b["beat_align"] and a.get("motion_beats") == b.get(
            "motion_beats")
        for k in ("FGD", "diversity", "feat_dist"):
            if k in a:  # printed with 4 decimals
                assert _close(float(a[k]), float(b[k]), abs_=1e-4), (k, a[k], b[k])
        assert r[0] == float(a["guidance"])
    if kind == "rag_ted":  # the JAX script prints its results tuples
        jresults = [ast.literal_eval(line) for line in _lines(jtext, "(")]
        for r, jr in zip(results, jresults, strict=True):
            assert r[0] == jr[0] and r[2] == jr[2]  # guidance, beat-align
            assert _close(r[1], jr[1]) and _close(r[3], jr[3])  # FGD, diversity
    assert _lines(text, "seconds: wall=")


def test_rag_beat_script_matches_jax(files, jax_runs, monkeypatch):
    jtext, jlog = jax_runs["rag_beat"]
    results, text, log = _port_run("rag_beat", files, monkeypatch)
    assert len(log["Alignment.score"]) == len(jlog["Alignment.score"]) == 2 * 8
    for a, b in zip(log["Alignment.score"], jlog["Alignment.score"]):
        assert abs(a - b) <= BEAT_ABS
    for a, b in zip(log["SRGR.avg"], jlog["SRGR.avg"], strict=True):
        assert abs(a - b) <= BEAT_ABS
    for name in ("frechet_from_samples", "diversity_score"):
        for a, b in zip(log[name], jlog[name], strict=True):
            assert _close(a, b), (name, a, b)
    ours, theirs = _lines(text, "guidance="), _lines(jtext, "guidance=")
    assert len(ours) == len(theirs) == len(results) == 2
    for line, jline, r, fid, div, srgr in zip(ours, theirs, results, log["frechet_from_samples"],
                                              log["diversity_score"], log["SRGR.avg"]):
        a, b = _fields(line), _fields(jline)
        assert a.keys() == b.keys() == {"guidance", "FID", "align", "SRGR", "diversity"}
        for k in ("FID", "align", "SRGR", "diversity"):
            assert _close(float(a[k]), float(b[k]), abs_=1e-4), (k, a[k], b[k])
        assert (r[1], r[3], r[4]) == (fid, div, srgr)


def test_livelyspeaker_beat_run_sweep_matches_jax(files, jax_runs):
    """Both run_sweeps get one stub composition; each its own loader and
    the embedder of its own package on the same checkpoint."""
    from livelyspeaker_tpu_torch.data import DataLoader
    from livelyspeaker_tpu_torch.data.beat import BeatWindowDataset

    jresults, jtext = jax_runs["ls_beat"]
    args = type("A", (), {"eval_model_path": files["beat_eval"], "device": "cpu"})()
    ds = BeatWindowDataset(files["beat"])
    loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True, seed=233)
    results, text = _run_printing(eval_livelyspeaker_beat.run_sweep, ds, loader, StubPipe(),
                                  eval_common.load_beat_embedder(args), 47, 34)
    assert len(results) == len(jresults) == 2
    for (g, fid, align, div, srgr), (jg, jfid, jalign, jdiv, jsrgr) in zip(results, jresults):
        assert g == jg and np.isfinite([fid, align, div, srgr]).all()
        assert _close(fid, jfid) and _close(div, jdiv), (fid, jfid, div, jdiv)
        assert abs(align - jalign) <= BEAT_ABS and abs(srgr - jsrgr) <= BEAT_ABS
    assert [_fields(x).keys() for x in _lines(text, "skip=")] == [
        _fields(x).keys() for x in _lines(jtext, "skip=")]


SMALL = ["--device", "cpu", "--timestep_respacing", "ddim10", "--batch_size", "8"]
REAL_RUNS = {
    "eval_rag_ted": lambda f: _argv(f, "rag_ted"),
    "eval_rag_beat": lambda f: _argv(f, "rag_beat", ["--sag_path", f["beat_sag"],
                                                      "--skip_steps", "8"]),
    "eval_livelyspeaker_ted": lambda f: _argv(f, "ls_ted", ["--skip_steps", "8"]),
    "eval_livelyspeaker_beat": lambda f: ["--model_path", f["beat_rag"], "--data_dir",
                                          f["beat"], "--eval_model_path", f["beat_eval"],
                                          "--sag_path", f["beat_sag"], "--skip_steps", "8"],
}


@pytest.mark.parametrize("script", list(REAL_RUNS))
def test_real_run_on_the_cpu_is_finite(script, files):
    """The scripts as they ship, sampling through the fused path's plain
    version on the CPU: every number of every guidance is finite."""
    module = sys.modules[f"livelyspeaker_tpu_torch.scripts.{script}"]
    argv = REAL_RUNS[script](files) + SMALL + ["--fused"]
    results, text = _run_printing(module.main, argv)
    assert results and all(np.isfinite(r).all() for r in results), results
    clock = _fields(_lines(text, "seconds: ")[0])
    assert float(clock["sampling"]) > 0 and float(clock["wall"]) >= float(clock["sampling"])


def test_data_parallel_raises_rather_than_run_on_one_card(files):
    with pytest.raises(SystemExit, match="not ported"):
        eval_rag_ted.main(_argv(files, "rag_ted", ["--device", "cpu", "--data_parallel", "2"]))


def test_final_npz_picks_the_latest_model_and_not_the_ema(tmp_path):
    for name in ("model000000010.npz", "model000000200.npz", "model_ema000000300.npz"):
        (tmp_path / name).write_bytes(b"")
    assert eval_common.final_npz(str(tmp_path)).endswith("model000000200.npz")
    assert eval_common.final_npz(str(tmp_path), "model_ema").endswith("model_ema000000300.npz")
    with pytest.raises(FileNotFoundError):
        eval_common.final_npz(str(tmp_path), "sag")


def test_reference_checkpoints_load_through_the_eval_loaders(files, tmp_path):
    """``load_rag_params`` and ``load_sag_params`` on the released layouts."""
    args = type("A", (), {"layers": 8, "num_emotions": 0})()
    path = str(tmp_path / "RAG.pt")
    torch.save(reference_state_dict("rag_ted"), path)
    RAG(RAGConfig.ted()).load_state_dict(eval_rag_ted.load_rag_params(path, args))
    path = str(tmp_path / "SAG.pth")
    torch.save(reference_state_dict("sag"), path)
    SAG().load_state_dict(eval_common.load_sag_params(path))
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        eval_rag_ted.load_rag_params("rag.ckpt", args)
