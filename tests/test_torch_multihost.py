"""Multi-process data parallelism of the port (``parallel/multihost.py``)
over ``torch.distributed`` with gloo on the CPU.

Two spawned runs of two torch processes each (no JAX process: the JAX
side is ``tests/test_multihost.py``), each run under a timeout of its own,
every child killed and joined in a ``finally``:

- a worker of this module a rank, one CPU shard a process, trains the
  small RAG (latent 32, 2 blocks) for two data-parallel steps and two FSDP
  steps with injected t, noise, style and drop. Its loss, per-sample
  losses and params must be bit-identical to the single-process step on a
  mesh of ``[cpu, cpu]`` over the same global batch (the sum of two
  gradients is commutative), and both ranks must hold the same bits;
- the demo script (``scripts/train_multihost_demo.py``): both processes
  print the same losses.

This module imports no JAX, so that the workers import it.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch import parallel
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import RAG, RAGConfig, audio_samples_for_frames
from livelyspeaker_tpu_torch.training import TrainConfig, init_train_state
from livelyspeaker_tpu_torch.training.trainer import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 180  # seconds a spawned run may take
KW = dict(latent_dim=32, num_layers=2, n_speakers=6)
B, STEPS = 8, 2  # the global batch: 4 rows a process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(cmds, timeout=RUN_TIMEOUT):
    """Run the commands together from the repo root; (return codes,
    outputs). Every child is killed and joined, whatever happens."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    return [p.returncode for p in procs], outs


def _batches():
    """STEPS global batches with their injected draws, from a seed."""
    rng = np.random.default_rng(70)
    out = []
    for _ in range(STEPS):
        batch = {"motion": (0.3 * rng.normal(size=(B, 9, 3, 34))).astype(np.float32),
                 "audio": (0.1 * rng.normal(size=(B, audio_samples_for_frames(34))))
                 .astype(np.float32),
                 "vid": rng.integers(0, KW["n_speakers"], size=(B,))}
        draws = {"t": rng.integers(0, 20, size=(B,)),
                 "noise": rng.normal(size=(B, 9, 3, 34)).astype(np.float32),
                 "style_eps": rng.normal(size=(B, 1, KW["latent_dim"])).astype(np.float32),
                 "cond_drop": (rng.random(B) < 0.3).astype(np.float32)}
        out.append((batch, draws))
    return out


def _train(kind, mesh, rows=slice(None)):
    """STEPS steps of the data-parallel ('dp') or FSDP step over ``mesh`` on
    ``rows`` of each global batch: the metrics of the last step and the
    full params (gathered under FSDP)."""
    model = RAG(RAGConfig.ted(**KW), generator=torch.Generator().manual_seed(0))
    tx = AdamW(1e-3, weight_decay=1e-2)
    cfg = TrainConfig(lr=1e-3, ema_rate=0.9)
    sched = DiffusionSchedule.create(steps=20)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=cfg)
    if kind == "dp":
        step = parallel.shard_train_step(model, sched, tx, cfg, mesh)
    else:
        step = parallel.fsdp_train_step(model, sched, tx, cfg, mesh, min_size=1)
    for batch, draws in _batches():
        local = {k: v[rows] for k, v in batch.items()}
        state, m = step(state, parallel.global_batch(local, mesh), None,
                        **{k: v[rows] for k, v in draws.items()})
    full = step.gathered_state() if kind == "fsdp" else state
    return m, {k: v.detach().clone() for k, v in full.params.items()}, state, step


def _worker(rank: int, port: int, out: str) -> None:
    """One rank of the two-process run: its results in ``out`` (npz)."""
    import torch.distributed as dist

    torch.set_num_threads(1)  # as the test process: the same sums, the same bits
    parallel.init_distributed(f"localhost:{port}", 2, rank, backend="gloo", device="cpu")
    try:
        mesh = parallel.create_mesh(devices=["cpu"])
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        res = {"shape": np.array([mesh.shape["data"], mesh.size, mesh.shard_index(0)]),
               "local_batch": np.array(parallel.process_local_batch_size(B))}
        try:
            parallel.process_local_batch_size(B + 1)
            res["indivisible_raised"] = np.array(False)
        except ValueError:
            res["indivisible_raised"] = np.array(True)
        for kind in ("dp", "fsdp"):
            m, params, state, step = _train(kind, mesh, rows)
            res[f"{kind}_loss"] = np.array(m["loss"])
            res[f"{kind}_lps"] = m["loss_per_sample"].numpy()
            res[f"{kind}_t"] = m["t"].numpy()
            res.update({f"{kind}/{k}": v.numpy() for k, v in params.items()})
            if kind == "fsdp":  # the slice each rank holds of one sharded leaf
                k, d = next(iter(step.shards.dims.items()))
                res["fsdp_slice"] = np.array([state.params[k].shape[d], params[k].shape[d]])
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The workers' thread count, so that both sides sum alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    port = _free_port()
    outs = [str(root / f"rank{r}.npz") for r in (0, 1)]
    code = ("import sys; sys.path.insert(0, {tests!r}); import test_torch_multihost as t; "
            "t._worker({rank}, {port}, {out!r})")
    cmds = [[sys.executable, "-c", code.format(tests=os.path.join(ROOT, "tests"), rank=r,
                                               port=port, out=outs[r])] for r in (0, 1)]
    rcs, logs = _spawn(cmds)
    assert rcs == [0, 0], logs
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("kind", ["dp", "fsdp"])
def test_two_processes_equal_one_process_of_two_shards(two_ranks, kind):
    """Bit for bit: the loss, the per-sample losses and t in global shard
    order, and every param, against the single-process [cpu, cpu] step on
    the same global batch and draws; both ranks hold the same bits."""
    m, params, _, _ = _train(kind, parallel.create_mesh(devices=["cpu", "cpu"]))
    for r in two_ranks:
        assert r[f"{kind}_loss"] == np.float64(m["loss"])
        np.testing.assert_array_equal(r[f"{kind}_lps"], m["loss_per_sample"].numpy())
        np.testing.assert_array_equal(r[f"{kind}_t"], m["t"].numpy())
        for k, v in params.items():
            np.testing.assert_array_equal(r[f"{kind}/{k}"], v.numpy(), err_msg=k)
    for k in params:
        assert two_ranks[0][f"{kind}/{k}"].tobytes() == two_ranks[1][f"{kind}/{k}"].tobytes()


def test_the_mesh_spans_the_process_group(two_ranks):
    """Each rank's mesh: 2 global shards, 1 local, its global index; the
    batch split; an indivisible batch raises; an FSDP rank holds half."""
    for rank, r in enumerate(two_ranks):
        assert r["shape"].tolist() == [2, 1, rank]
        assert int(r["local_batch"]) == B // 2 and bool(r["indivisible_raised"])
        held, full = r["fsdp_slice"].tolist()
        assert 2 * held == full


def test_without_a_process_group_the_mesh_is_the_process_s():
    mesh = parallel.create_mesh(devices=["cpu", "cpu"])
    assert mesh.shape["data"] == mesh.size == 2 and mesh.process_count == 1
    assert [mesh.shard_index(i) for i in range(2)] == [0, 1]
    assert parallel.process_local_batch_size(6) == 6
    shards = parallel.global_batch({"x": np.arange(6), "tag": "a"}, mesh)
    assert [s["x"].tolist() for s in shards] == [[0, 1, 2], [3, 4, 5]]
    assert all(s["tag"] == "a" for s in shards)


def test_the_demo_prints_the_same_losses_on_both_processes():
    port = _free_port()
    cmds = [[sys.executable, "-m", "livelyspeaker_tpu_torch.scripts.train_multihost_demo",
             "--process_id", str(r), "--coordinator", f"localhost:{port}", "--platform", "cpu",
             "--devices_per_process", "1", "--steps", "2", "--local_batch", "4"]
            for r in (0, 1)]
    rcs, outs = _spawn(cmds)
    assert rcs == [0, 0], outs
    for out in outs:
        assert "multihost demo OK" in out and "2 global devices" in out, out
        assert "global_batch=8" in out, out
    losses = [re.findall(r"loss=([0-9.]+)", o) for o in outs]
    assert len(losses[0]) == 2 and losses[0] == losses[1], outs
