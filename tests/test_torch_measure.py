"""The port's measurement entry points and small utilities against the JAX
package, on the CPU.

- ``utils/profiling.py``: ``device_trace`` and ``annotate`` write a Chrome
  trace here.
- ``utils/seeding.py``: ``fixseed`` leaves numpy's and Python's RNGs in the
  JAX function's state.
- ``utils/plotting.py``: ``farthest_point_sample`` picks the JAX scan's
  indices for the same start (exactly); ``pca_2d_tracks`` within 1e-5.
- ``utils/visualize.py``: ``render_ted_clip``'s pose frames within 1e-6 and
  its GIF's frames; ``export_beat_bvh`` the same BVH text.
- The fused training backbone under bf16 (``bench_train``'s default dtypes
  with ``--fused_train``): the JAX package runs it, so the port computes it
  as the JAX kernel does, held against it in interpret mode.
- The scripts (``bench_data``, ``bench_train``, ``bench_serve``,
  ``profile``, ``soak_serve``) run on ``--device cpu`` at small width, and
  their rows carry the keys the JAX scripts print (``bench_train``'s peak
  keys excepted: the port reports its share of the H100's f32 peak instead).
"""

import ast
import json
import os
import random
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.utils import plotting, profiling, seeding, visualize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--latent_dim", "32", "--layers", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's CPU thread pool costs more than it gives here,
    and its spinning threads slow the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_row_keys(script, func):
    """The string keys of the row ``func`` of ``scripts/<script>`` builds:
    the dict it returns, appends or prints as JSON."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", script)).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call) and n.args]
    rows = [n.value for n in ast.walk(fn) if isinstance(n, ast.Return)]
    rows += [n.args[0] for n in calls
             if isinstance(n.func, ast.Attribute) and n.func.attr == "append"]
    rows += [n.args[0].args[0] for n in calls  # print(json.dumps({...}))
             if isinstance(n.func, ast.Name) and n.func.id == "print"
             and isinstance(n.args[0], ast.Call) and n.args[0].args]
    keys = {k.value for d in rows if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}
    assert keys, f"no row in {script}:{func}"
    return keys


# --- utils -----------------------------------------------------------------

def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("ls_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "ls_region" for e in events)
    assert any(e.key == "ls_region" for e in prof.key_averages())


def test_fixseed_matches_jax():
    from livelyspeaker_tpu.utils.seeding import fixseed as jfixseed

    jfixseed(7)
    want = (np.random.get_state()[1].copy(), random.getstate())
    np.random.seed(0)
    random.seed(0)
    g = seeding.fixseed(7)
    assert np.array_equal(np.random.get_state()[1], want[0]) and random.getstate() == want[1]
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(7)))


@pytest.mark.parametrize("start", ["given", "default"])
def test_farthest_point_sample_matches_jax(start, rng_np):
    """The same indices as the JAX scan (tests/test_plotting.py:34)."""
    from livelyspeaker_tpu.utils.plotting import farthest_point_sample as jfps

    xyz = rng_np.normal(size=(3, 64, 3)).astype(np.float32)
    s = rng_np.integers(0, 64, size=3) if start == "given" else None
    want = np.asarray(jfps(xyz, 8, start=s))
    got = plotting.farthest_point_sample(torch.from_numpy(xyz), 8, start=s)
    assert got.dtype == torch.int64 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_farthest_point_sample_spreads_points():
    centers = np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0], [0, 0, 10]], np.float32)
    cloud = np.repeat(centers, 16, axis=0)[None]
    idx = plotting.farthest_point_sample(cloud, 4).numpy()
    assert len({tuple(p) for p in cloud[0, idx[0]]}) == 4


def test_pca_2d_tracks_matches_jax(rng_np):
    from livelyspeaker_tpu.utils.plotting import pca_2d_tracks as jpca

    batches = [rng_np.normal(size=(100, 8)) @ rng_np.normal(size=(8, 8)) for _ in range(3)]
    for whiten in (True, False):
        for a, b in zip(plotting.pca_2d_tracks(batches, whiten), jpca(batches, whiten),
                        strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_plotters_draw(tmp_path, rng_np):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(9, 6))
    plotting.pca2d(axes[0, 0], [0, 1], [rng_np.normal(size=(120, 6)) for _ in range(2)], "pca")
    plotting.distribution(axes[0, 1], rng_np.normal(size=(50, 4)), "dist")
    plotting.circles(axes[0, 2], rng_np.uniform(0, 1, 5), rng_np.uniform(0.2, 1, 5),
                     title="circles", show_axes=False)
    plotting.functions(axes[1, 0], np.sin(np.linspace(0, 6, 160)).reshape(2, 80), 0, 6, -1, 1)
    plotting.phase_1d(axes[1, 1], rng_np.uniform(-0.5, 0.5, 60), rng_np.uniform(0, 1, 60))
    plotting.phase_2d(axes[1, 2], rng_np.uniform(0, 1, 60), rng_np.uniform(0.2, 1, 60))
    out = tmp_path / "plots.png"
    fig.savefig(out)
    plt.close(fig)
    assert out.stat().st_size > 1000


def test_render_ted_clip_matches_jax(tmp_path, rng_np):
    """The pose frames within 1e-6, and a GIF of as many frames (no ffmpeg
    here) from both (tests/test_visualize_and_tokenizer.py:27)."""
    from PIL import Image

    from livelyspeaker_tpu.utils import visualize as jvis

    motion = rng_np.normal(size=(8, 27)).astype(np.float32) * 0.1
    np.testing.assert_allclose(visualize._pose_frames_from_dir_vec(motion),
                               np.asarray(jvis._pose_frames_from_dir_vec(motion)),
                               rtol=1e-6, atol=1e-6)
    outs = [mod.render_ted_clip(motion, str(tmp_path / f"{name}.mp4"), title="test")
            for name, mod in (("ours", visualize), ("theirs", jvis))]
    for out in outs:
        assert os.path.getsize(out) > 1000
    assert os.path.splitext(outs[0])[1] == os.path.splitext(outs[1])[1]
    if outs[0].endswith(".gif"):
        frames = [Image.open(o).n_frames for o in outs]
        assert frames[0] == frames[1] == len(motion)


def test_export_beat_bvh_matches_jax(tmp_path, rng_np):
    """The same BVH text (tests/test_visualize_and_tokenizer.py:37)."""
    from livelyspeaker_tpu.utils.visualize import export_beat_bvh as jexport
    from livelyspeaker_tpu_torch.data.bvh import parse_bvh
    from tests.test_beat_pipeline import SIMPLE_BVH

    tpl = tmp_path / "template.bvh"
    tpl.write_text(SIMPLE_BVH)
    euler = rng_np.uniform(-30, 30, size=(5, 6)).astype(np.float32)
    ours = visualize.export_beat_bvh(euler, str(tpl), str(tmp_path / "ours.bvh"),
                                     joints=["Spine", "Neck"])
    theirs = jexport(euler, str(tpl), str(tmp_path / "theirs.bvh"), joints=["Spine", "Neck"])
    assert open(ours).read() == open(theirs).read()
    b = parse_bvh(ours)
    assert b.frames.shape == (5, 12) and b.fps == pytest.approx(15.0, rel=1e-5)
    np.testing.assert_allclose(b.joint_channels("Spine")[:, :3], euler[:, :3], atol=1e-4)


# --- the fused training backbone under bf16 ---------------------------------

def test_fused_backbone_bf16_matches_the_jax_kernel():
    """JAX runs ``fused_transmlp_train`` on bf16 inputs (the trainer's
    compute_dtype): the stack in f32 on the bf16 values, the output cast to
    bf16. The port computes the same: its output and gradients within one
    bf16 rounding of JAX's (the port's gradients reach the bf16 inputs in
    bf16, JAX's custom VJP hands on f32)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from livelyspeaker_tpu.ops.pallas import fused_mlp as jfused
    from livelyspeaker_tpu.ops.pallas import fused_mlp_train as jtrain
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2
    from test_torch_fused_mlp_train import _backbones

    seq, dim, layers, b = 35, 64, 2, 3
    params, tm = _backbones(seq, dim, layers, "silu", seed=5)
    rng = np.random.default_rng(6)
    x, emb, cot = (rng.normal(size=s).astype(np.float32)
                   for s in ((b, seq, dim), (b, dim), (b, seq, dim)))
    bf = jnp.bfloat16
    jparams = jax.tree.map(lambda p: jnp.asarray(p).astype(bf), params)
    jp = jfused.pack_transmlp_params(jparams, layers)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda xx, ee, pp: jtrain.fused_transmlp_train(xx, ee, pp, "silu", 4),
                         jnp.asarray(x).astype(bf), jnp.asarray(emb).astype(bf), jp)
        jgx, jgemb, jgp = vjp(jnp.asarray(cot).astype(bf))
    assert y.dtype == bf

    tm = tm.to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    et = torch.from_numpy(emb).to(torch.bfloat16).requires_grad_(True)
    packed = k2.pack_transmlp_train_params(tm)
    out = k2.fused_transmlp_train(xt, et, packed, "silu")
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, [xt, et, *packed.values()],
                                torch.from_numpy(cot).to(torch.bfloat16))

    def close(a, ref, name):
        a, ref = a.float().numpy(), np.asarray(ref, np.float32)
        # one bf16 rounding (2^-8 relative) either side of f32 sums in
        # another order
        np.testing.assert_allclose(a, ref, rtol=2 ** -7, atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)

    close(out.detach(), y.astype(jnp.float32), "out")
    close(grads[0], jgx, "dx")
    close(grads[1], jgemb, "d_emb")
    for k, g in zip(packed, grads[2:]):
        ref = np.asarray(jgp[k], np.float32)
        if k == "token_w":
            ref = ref[:, :seq, :seq]
        elif k == "token_b":
            ref = ref[:, :seq, 0]
        close(g, ref, k)


# --- the scripts ---------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records

    d = str(tmp_path_factory.mktemp("records"))
    build_synthetic_ted_records(d, n_clips=2, clip_seconds=8, seed=5)
    return d


def test_bench_train_rows(records, capsys):
    from livelyspeaker_tpu_torch.scripts import bench_train

    rows = bench_train.main(SMALL + ["--batch", "2", "--steps", "1", "--dtypes", "float32",
                                     "bfloat16", "--fused_train", "--loaders",
                                     "--data_dir", records])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and len(rows) == 4
    want = _jax_row_keys("bench_train.py", "bench_dtype") - {"mxu_tflops", "pct_mxu_peak"}
    for r, dt in zip(rows[:2], ("float32", "bfloat16")):
        assert want <= r.keys() and {"tflops", "pct_f32_peak"} <= r.keys()
        assert r["compute_dtype"] == dt and r["fused_train"] and np.isfinite(r["final_loss"])
    want = _jax_row_keys("bench_train.py", "bench_loaders")
    assert [r["loader"] for r in rows[2:]] == ["streaming", "device_resident"]
    assert all(want <= r.keys() and r["value"] > 0 for r in rows[2:])


def test_train_step_flops_match_bench_py():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
    from livelyspeaker_tpu_torch.models import RAGConfig
    from livelyspeaker_tpu_torch.scripts.bench_train import train_step_matmul_flops

    for name in ("ted", "beat"):
        assert train_step_matmul_flops(getattr(RAGConfig, name)(), 512) == \
            bench.train_step_matmul_flops(getattr(JRAGConfig, name)(), 512)


def test_bench_data_rows(records, capsys):
    from livelyspeaker_tpu_torch.scripts import bench_data

    rows = bench_data.main(["--device", "cpu", "--batch", "4", "--epochs", "1",
                            "--data_dir", records])
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    assert [r["metric"] for r in rows] == ["ted_loader_clips_per_sec_train_fields",
                                           "ted_loader_clips_per_sec_all_fields"]
    want = _jax_row_keys("bench_data.py", "main")
    for r in rows:
        assert want <= r.keys() and r["value"] > 0
        assert r["train_step_demand"] == bench_data.TRAIN_STEP_DEMAND


# the JAX script's lines (scripts/bench_serve.py:174-181, :229-240)
SINGLE_LINE = re.compile(r"^single-request latency \(n=\d+, max_batch=\d+, wait=[\d.]+ms\): "
                         r"p50=\d+ms min=\d+ms max=\d+ms$")
BURST_LINE = re.compile(r"^\[(ted|beat)( text_frac=[\d.]+)?\] burst=\d+ max_batch=\d+ depth=\d+ "
                        r"sampler=\w+-\w+: [\d.]+s \([\d.]+ clips/s\), submit drain [\d.]+s, "
                        r"occupancy [\d.]+/\d+, p50=\d+ms p95=\d+ms p99=\d+ms$")


@pytest.mark.parametrize("dataset,depth", [("ted", 0), ("beat", 1)])
def test_bench_serve_lines(dataset, depth, capsys):
    from livelyspeaker_tpu_torch.scripts import bench_serve

    out = bench_serve.main(SMALL + ["--dataset", dataset, "--burst", "6", "--max_batch", "4",
                                    "--clients", "2", "--single", "2", "--pipeline_depth",
                                    str(depth), "--max_wait_ms", "5", "--steps", "20",
                                    "--timestep_respacing", "ddim2", "--sampler", "ddim"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and SINGLE_LINE.match(lines[0]) and BURST_LINE.match(lines[1])
    assert out["depth"] == depth and out["clips_per_sec"] > 0 and out["burst_batches"] >= 2
    # the warm-up's batch, the two single requests' and the burst's
    assert out["batches"] == 1 + 2 + out["burst_batches"]


def test_profile_writes_traces(tmp_path):
    from livelyspeaker_tpu_torch.scripts import profile

    for what, extra in (("sampler", ["--steps", "20", "--timestep_respacing", "ddim2",
                                     "--sampler", "ddim"]),
                        ("train", [])):
        path = profile.main(["--device", "cpu", "--what", what, "--batch", "2", "--iters", "1",
                             "--trace_dir", str(tmp_path / what)] + extra)
        events = json.loads(open(path).read())["traceEvents"]
        assert path == str(tmp_path / what / profiling.TRACE_FILE) and events


SOAK_SECONDS = 240  # the soak's own limit here: its server is a process of its own


def test_soak_serve_on_a_cpu_server(tmp_path):
    """The soak against a CPU server subprocess for a few seconds: it passes
    its own asserts (no transport error, finite motion, frame counts,
    param_version = reloads, exit 0 on SIGTERM) and prints its summary."""
    cmd = [sys.executable, "-m", "livelyspeaker_tpu_torch.scripts.soak_serve", *SMALL,
           "--seconds", "4", "--clients", "2", "--reload_every", "1.5", "--max_batch", "4",
           "--out", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        out, err = proc.communicate(timeout=SOAK_SECONDS)
    finally:
        if proc.poll() is None:  # the soak and its server: one process group
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    summary = json.loads(out.strip().splitlines()[-1])
    counts = {"short", "text", "long", "stream", "reload", "overloaded"}  # its **counts
    assert _jax_row_keys("soak_serve.py", "main") | counts <= summary.keys()
    assert summary["errors"] == 0 and summary["sigterm_exit_code"] == 0
    assert summary["param_version"] == summary["reload"] >= 1
    assert summary["requests_served"] > 0 and summary["short"] + summary["long"] > 0
