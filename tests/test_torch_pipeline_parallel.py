"""GPipe stages of the port (``parallel/pipeline.py``) against the JAX
package's, and wired through the train step, FSDP and ``train_rag``.

The pipeline mesh names the CPU once a stage (``[cpu] * S``), which runs the
code a mesh of S cards runs. The JAX side runs on S of the eight virtual
CPU devices of ``tests/conftest.py``. The mixer stack is 8 blocks at width
32 over 35 tokens, batch 16, with seeded unit-fan-in weights on both
sides. Tolerances are ``tests/test_pipeline_parallel.py``'s:

- the forward for (stages, microbatches) in {(2, 2), (4, 4), (4, 8)}
  against the port's sequential TransMLP and against JAX
  ``pipeline_forward``: atol 1e-5;
- the gradients through the schedule against the sequential stack's:
  rtol 2e-3, atol 2e-4;
- a train step through the pipeline backbone against the plain step (the
  small RAG, latent 32, 2 blocks, 2 stages, 2 microbatches, the same
  injected draws): loss rtol 1e-5, params atol 2e-5; with FSDP over 2 data
  rows of 2 stages: loss rtol 1e-5 against the replicated pipeline step,
  the state still sliced.
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.models.mlp_backbone import TimestepEmbedder as JTimestepEmbedder
from livelyspeaker_tpu.models.mlp_backbone import TransMLP as JTransMLP
from livelyspeaker_tpu.parallel import create_pipeline_mesh as jcreate_pipeline_mesh
from livelyspeaker_tpu.parallel import pipeline_forward as jpipeline_forward
from livelyspeaker_tpu.parallel import stack_block_params as jstack_block_params
from livelyspeaker_tpu_torch import parallel
from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import RAG, RAGConfig, audio_samples_for_frames
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
from livelyspeaker_tpu_torch.scripts import train_rag
from livelyspeaker_tpu_torch.training import TrainConfig, init_train_state, make_train_step
from livelyspeaker_tpu_torch.training.loop import TrainLoop
from livelyspeaker_tpu_torch.training.trainer import AdamW
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, \
    random_normal_params

L, T, D, B = 8, 35, 32, 16
CONFIGS = [(2, 2), (4, 4), (4, 8)]  # (stages, microbatches)
KW = dict(latent_dim=32, num_layers=2, n_speakers=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs():
    """(x, t, Flax params of the stack): seeded unit-fan-in weights."""
    rng = np.random.default_rng(90)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    t = rng.integers(0, 1000, size=(B,))
    shapes = jax.eval_shape(JTransMLP(seq_len=T, num_layers=L, dim=D).init,
                            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return x, t, random_normal_params(zeros, rng)  # it reads only the shapes


@functools.lru_cache(maxsize=None)
def _jax_outputs():
    """JAX pipeline_forward's output for each config, each jitted once."""
    x, t, params = _inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    emb = JTimestepEmbedder(D).apply({"params": jp["embed_timestep"]}, jnp.asarray(t))
    stacked = jstack_block_params(jp, L)
    outs = {}
    for s, m in CONFIGS:
        mesh = jcreate_pipeline_mesh(n_devices=s, pipeline_parallel=s)
        fn = functools.partial(jpipeline_forward, mesh=mesh, num_microbatches=m)
        outs[s, m] = np.asarray(jax.jit(fn)(stacked, jnp.asarray(x), emb))
    return outs


def _port_stack():
    """(backbone, x, t, emb, stacked) of the port on the same weights."""
    x, t, params = _inputs()
    backbone = TransMLP(T, L, D)
    backbone.load_state_dict(jax_params_to_state_dict(params))
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    stacked = parallel.stack_block_params(dict(backbone.named_parameters()), L)
    return backbone, xt, tt, backbone.embed_timestep(tt), stacked


@pytest.mark.parametrize("stages,micro", CONFIGS)
def test_pipeline_matches_sequential_and_jax(stages, micro):
    backbone, x, t, emb, stacked = _port_stack()
    mesh = parallel.create_pipeline_mesh(devices=["cpu"] * stages, pipeline_parallel=stages)
    assert mesh.shape == {parallel.DATA_AXIS: 1, parallel.STAGE_AXIS: stages}
    with torch.no_grad():
        out = parallel.pipeline_forward(stacked, x, emb, mesh, num_microbatches=micro)
        seq = backbone(x, t)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), _jax_outputs()[stages, micro], rtol=0, atol=1e-5)


def test_pipeline_with_data_rows():
    """Two data rows of two stages: each row its own pipeline on its half;
    with ``data_sharded=False`` the first row runs the whole batch."""
    backbone, x, t, emb, stacked = _port_stack()
    mesh = parallel.create_pipeline_mesh(devices=["cpu"] * 4, pipeline_parallel=2)
    assert mesh.shape == {parallel.DATA_AXIS: 2, parallel.STAGE_AXIS: 2}
    assert mesh.size == 2 and len(mesh.grid) == 2
    with torch.no_grad():
        seq = backbone(x, t).numpy()
        out = parallel.pipeline_forward(stacked, x, emb, mesh, num_microbatches=2)
        np.testing.assert_allclose(out.numpy(), seq, rtol=0, atol=1e-5)
        one_row = parallel.pipeline_forward(stacked, x, emb, mesh, num_microbatches=2,
                                            data_sharded=False)
        np.testing.assert_allclose(one_row.numpy(), seq, rtol=0, atol=1e-5)
    assert parallel.pipeline_spec(stacked)["ch_w"] == (parallel.STAGE_AXIS, None, None)


def test_pipeline_gradients_match_the_sequential_ones():
    backbone, x, t, emb, _ = _port_stack()
    mesh = parallel.create_pipeline_mesh(devices=["cpu"] * 4, pipeline_parallel=4)
    params = [p for k, p in backbone.named_parameters() if k.startswith("block_")]
    emb = emb.detach()

    def grads(fn):
        return torch.autograd.grad((fn() ** 2).sum(), params)

    def piped():
        stacked = parallel.stack_block_params(dict(backbone.named_parameters()), L)
        return parallel.pipeline_forward(stacked, x, emb, mesh)

    def sequential():
        h = x
        for blk in backbone.blocks():
            h = blk(h, emb)
        return h

    for g, r, (k, _) in zip(grads(piped), grads(sequential),
                            [kv for kv in backbone.named_parameters() if kv[0].startswith("block_")]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-3, atol=2e-4, err_msg=k)


def _rag_batch():
    rng = np.random.default_rng(91)
    b = 8
    batch = {"motion": (0.3 * rng.normal(size=(b, 9, 3, 34))).astype(np.float32),
             "audio": (0.1 * rng.normal(size=(b, audio_samples_for_frames(34))))
             .astype(np.float32),
             "vid": rng.integers(0, KW["n_speakers"], size=(b,))}
    draws = {"t": rng.integers(0, 20, size=(b,)),
             "noise": rng.normal(size=(b, 9, 3, 34)).astype(np.float32),
             "style_eps": rng.normal(size=(b, 1, KW["latent_dim"])).astype(np.float32),
             "cond_drop": (rng.random(b) < 0.3).astype(np.float32)}
    return batch, draws


def _rag_step(mesh=None, fsdp=False, backbone=True):
    """The small RAG's step: plain, or through the pipeline backbone of
    ``mesh`` (2 microbatches), replicated or FSDP (min_size 1)."""
    cfg = RAGConfig.ted(**KW)
    model = RAG(cfg, generator=torch.Generator().manual_seed(5))
    tx = AdamW(1e-3, eps=1e-3)
    tcfg = TrainConfig(lr=1e-3)
    sched = DiffusionSchedule.create(steps=20)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=tcfg)
    factory = None
    if backbone and mesh is not None:
        factory = parallel.make_pipeline_backbone_factory(cfg, mesh, num_microbatches=2)
    if fsdp:
        step = parallel.fsdp_train_step(model, sched, tx, tcfg, mesh, min_size=1,
                                        backbone_factory=factory)
    elif mesh is not None and mesh.shape["data"] > 1:
        step = parallel.shard_train_step(model, sched, tx, tcfg, mesh, backbone_factory=factory)
    else:
        step = make_train_step(model, sched, tx, tcfg, backbone_factory=factory)
    return model, state, step


def test_pipeline_train_step_matches_the_plain_one():
    """JAX ``test_pipeline_parallel.py:111``: the pipeline backbone through
    make_train_step, one row of 2 stages, against the plain step."""
    batch, draws = _rag_batch()
    out = []
    for mesh in (None, parallel.create_pipeline_mesh(devices=["cpu"] * 2)):
        model, state, step = _rag_step(mesh)
        state, m = step(state, batch, None, **draws)
        out.append((m["loss"], {k: v.detach().clone() for k, v in state.params.items()}))
    (lp, pp), (lq, pq) = out
    np.testing.assert_allclose(lq, lp, rtol=1e-5)
    for k in pp:
        np.testing.assert_allclose(pq[k].numpy(), pp[k].numpy(), rtol=0, atol=2e-5, err_msg=k)


def test_pipeline_composes_with_fsdp():
    """JAX ``test_pipeline_parallel.py:185``: 2 data rows of 2 stages, the
    state sliced over the rows (min_size 1): the loss of the replicated
    pipeline step, and the state still sliced after the step."""
    batch, draws = _rag_batch()
    mesh = parallel.create_pipeline_mesh(devices=["cpu"] * 4, pipeline_parallel=2)
    _, rstate, rstep = _rag_step(mesh)
    _, m_rep = rstep(rstate, batch, None, **draws)
    _, fstate, fstep = _rag_step(mesh, fsdp=True)
    fstate, m_f = fstep(fstate, batch, None, **draws)
    np.testing.assert_allclose(m_f["loss"], m_rep["loss"], rtol=1e-5)
    full = fstep.gathered_state()
    dims = fstep.shards.dims
    assert dims and all(2 * fstate.params[k].shape[d] == full.params[k].shape[d]
                        for k, d in dims.items())


@pytest.mark.parametrize("call,err,match", [
    (lambda s: parallel.pipeline_forward(
        s, torch.zeros(16, T, D), torch.zeros(16, 1, D),
        parallel.create_pipeline_mesh(devices=["cpu"] * 3, pipeline_parallel=3)),
     ValueError, "layers 8 not divisible by stages 3"),
    (lambda s: parallel.pipeline_forward(
        s, torch.zeros(16, T, D), torch.zeros(16, 1, D),
        parallel.create_pipeline_mesh(devices=["cpu"] * 2), num_microbatches=3),
     ValueError, "per-pipeline batch 16 not divisible by M=3"),
    (lambda s: parallel.create_pipeline_mesh(devices=["cpu"] * 4, model_parallel=2),
     NotImplementedError, "later slice"),
    (lambda s: parallel.pipeline_spec(s, tensor_parallel=True), NotImplementedError,
     "later slice"),
    (lambda s: TrainLoop(RAG(RAGConfig.ted(**KW)), DiffusionSchedule.create(steps=20), None,
                         [], mesh=parallel.create_mesh(devices=["cpu"] * 2),
                         use_shard_map=True, backbone_factory=lambda p, row=0: None),
     ValueError, "separate mesh programs"),
], ids=["layers", "microbatches", "tensor-parallel-mesh", "tensor-parallel-spec",
        "factory-with-shard-map"])
def test_pipeline_refusals(call, err, match):
    stacked = _port_stack()[4]
    with pytest.raises(err, match=match):
        call(stacked)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline_records"))
    build_synthetic_ted_records(root, n_clips=2, clip_seconds=10, seed=92)
    return root


SMALL = ["--latent_dim", "32", "--layers", "2", "--batch_size", "8", "--epochs", "5",
         "--lr_anneal_steps", "2", "--log_interval", "1"]


def test_train_rag_with_pipeline_stages_and_fsdp(records, tmp_path):
    """train_rag --device cpu,cpu,cpu,cpu --pipeline_parallel 2 --fsdp: two
    steps over 2 data rows of 2 stages, finite losses, the state sliced and
    the checkpoint whole."""
    loop = train_rag.main(["--dataset", "ted", "--data_dir", records, "--save_dir",
                           str(tmp_path), "--device", "cpu,cpu,cpu,cpu", "--pipeline_parallel",
                           "2", "--fsdp", *SMALL])
    assert loop.step == 2 and loop.fsdp and loop.mesh.shape == {"data": 2, "stage": 2}
    with open(os.path.join(str(tmp_path), "progress.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if line.strip()]
    assert len(losses) == 2 and np.isfinite(losses).all()
    full = loop.step_fn.gathered_state()
    assert any(v.shape != full.params[k].shape for k, v in loop.state.params.items())
    assert os.path.exists(os.path.join(str(tmp_path), "model000000002.npz"))


@pytest.mark.parametrize("flags,message", [
    (["--pipeline_parallel", "2", "--fused_train"],
     "--pipeline_parallel does not compose with --fused_train (the fused custom-VJP kernel "
     "is a single-chip whole-stack program; the pipeline shards the stack over 'stage')"),
    (["--pipeline_parallel", "2", "--layers", "3"],
     "--layers 3 not divisible by --pipeline_parallel 2"),
    (["--fsdp", "--fused_train", "--device", "cpu,cpu"],
     "--fsdp needs the GSPMD train step (params gathered at use sites), but --fused_train on "
     "a multi-device mesh runs the explicit shard_map DP step over replicated params; drop "
     "one."),
], ids=["pipeline-fused", "layers", "fsdp-fused"])
def test_train_rag_keeps_the_jax_refusals(records, tmp_path, flags, message):
    with pytest.raises(SystemExit) as e:
        train_rag.main(["--dataset", "ted", "--data_dir", records, "--save_dir",
                        str(tmp_path), "--device", "cpu,cpu", *flags])
    assert str(e.value) == message
