"""Data parallelism of the port (``parallel/``) against the JAX package's.

The port's mesh is a list of devices driven by one process; on the CPU it
names the CPU twice (``[cpu, cpu]``), which runs the same code a mesh of
two cards runs. The JAX side runs on two of the eight virtual CPU devices
of ``tests/conftest.py``. Small widths (``test_torch_training.KW``: latent
32, one block), the same seeded numpy inputs and randomised weights on
both sides. Tolerances:

- the data-parallel train step with injected t, noise, style and drop
  against the mean of the JAX package's per-shard ``value_and_grad``
  under ``shard_map`` followed by ``optax.adamw``: loss rtol 1e-5, params
  atol 1e-6 (``test_train_step_matches_jax_loss_and_adamw``'s);
- identical shards with ``fold_shard_rng=False``: the single step's
  loss (rel 1e-6) and params (atol 1e-6), as the JAX test holds them;
- the sharded sampler (DDIM at eta 0 from injected noise) against the
  port's unsharded sampler and against JAX ``RAGSampler(mesh=...)`` on
  the XLA denoiser: 1e-5 of max|x|; the sharded composition against JAX
  ``LivelySpeakerPipeline(mesh=...)``: 1e-4 of max|x| (the gate of
  ``test_torch_composition``).
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from livelyspeaker_tpu.diffusion import losses as jl
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu.data.clip_tokenizer import HashTokenizer as JHashTokenizer
from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.models import clip_text as jclip
from livelyspeaker_tpu.models import sag as jsag
from livelyspeaker_tpu.parallel import create_mesh as jcreate_mesh
from livelyspeaker_tpu.parallel.mesh import shard_map
from livelyspeaker_tpu.pipeline import LivelySpeakerPipeline as JPipeline
from livelyspeaker_tpu.pipeline import RAGSampler as JRAGSampler
from livelyspeaker_tpu_torch import parallel
from livelyspeaker_tpu_torch.data import DataLoader, DeviceDataLoader, HashTokenizer
from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import SAG, RAG, CLIPTextConfig, CLIPTextEncoder, RAGConfig
from livelyspeaker_tpu_torch.parallel import create_mesh, fold_in, shard_sample_fn, \
    shard_train_step
from livelyspeaker_tpu_torch.parallel.mesh import shard_batch
from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline, RAGSampler, \
    generate_long_form
from livelyspeaker_tpu_torch.scripts import eval_rag_ted, train_rag
from livelyspeaker_tpu_torch.serving import ServeConfig, build_rag_server, serving_mesh
from livelyspeaker_tpu_torch.training import TrainConfig, init_train_state, make_optimizer, \
    make_train_step
from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz
from livelyspeaker_tpu_torch.training.loop import TrainLoop
from livelyspeaker_tpu_torch.training.trainer import AdamW
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, random_normal_params

from test_torch_training import KW, ZERO_GRAD, _batch, _own_init_model

CPU2 = ["cpu", "cpu"]
B_LOCAL = 4
SAMPLE_TOL = 1e-5
COMPOSITION_TOL = 1e-4
LR, WD = 1e-3, 1e-2
SKETCH_TOL = 1e-5  # test_torch_composition's
CLIP = dict(vocab_size=49408, context_length=77, width=32, layers=1, heads=2, embed_dim=32)
SAG_KW = dict(njoints=9, nfeats=3, latent_dim=32, ff_size=64, num_layers=1, num_heads=2)
SENTENCES = ["so we went down to the river", 'She said: "I never expected that, honestly!"',
             "and then", "nothing at all, really"] * 2


def _random_params(module, seed, *init_args):
    """Seeded normals in the shapes of ``module``'s params (``jax.eval_shape``
    of its init: no forward runs)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init({"params": key, "style": key}, *init_args))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes["params"])
    return random_normal_params(zeros, np.random.default_rng(seed))


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX RAG (``KW``), SAG and CLIP text tower with their params,
    built once a process; the port's models load these params."""
    jcfg = JRAGConfig.ted(**KW)
    b = _batch(np.random.default_rng(0), jcfg, 2)
    cond = {"audio": jnp.asarray(b["audio"]), "vid": jnp.asarray(b["vid"]),
            "origin_x": jnp.asarray(b["motion"])}
    x = jnp.zeros((2, 9, 3, 34))
    models = {"rag": JRAG(jcfg), "sag": jsag.SAG(**SAG_KW),
              "clip": jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**CLIP))}
    params = {"rag": _random_params(models["rag"], 1, x, jnp.zeros((2,), jnp.int32), cond),
              "sag": _random_params(models["sag"], 2, x),
              "clip": _random_params(models["clip"], 3, jnp.zeros((1, 77), jnp.int32))}
    return models, params


def _port_model(**cfg_kw):
    model = RAG(RAGConfig.ted(**KW, **cfg_kw))
    model.load_state_dict(jax_params_to_state_dict(_jax_models()[1]["rag"]))
    return model


def _port_stages():
    params = _jax_models()[1]
    sag, clip = SAG(**SAG_KW), CLIPTextEncoder(CLIPTextConfig(**CLIP))
    sag.load_state_dict(jax_params_to_state_dict(params["sag"]))
    clip.load_state_dict(jax_params_to_state_dict(params["clip"]))
    return sag.eval(), clip.eval()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's CPU thread pool costs more than it gives
    here, and its spinning threads slow the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return create_mesh(devices=CPU2)


def _step(model, mesh=None, fold=True, eps=None, **cfg_kw):
    cfg = TrainConfig(lr=LR, **cfg_kw)
    tx = make_optimizer(cfg) if eps is None else AdamW(LR, eps=eps)
    sched = DiffusionSchedule.create(steps=20)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=cfg,
                             num_timesteps=sched.num_timesteps)
    if mesh is None:
        return state, make_train_step(model, sched, tx, cfg)
    return state, shard_train_step(model, sched, tx, cfg, mesh, fold_shard_rng=fold)


def _global_batch(seed, b=2 * B_LOCAL):
    return _batch(np.random.default_rng(seed), RAGConfig.ted(**KW), b)


# --- the mesh ----------------------------------------------------------------

def test_create_mesh_shapes():
    mesh = create_mesh(devices=CPU2)
    assert mesh.shape == {parallel.DATA_AXIS: 2, parallel.MODEL_AXIS: 1}
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert create_mesh(n_devices=1, devices=CPU2).size == 1
    shards = shard_batch({"x": torch.arange(6.0), "s": list("abcdef"), "g": 1.5,
                          "n": np.arange(6)}, create_mesh(devices=["cpu"] * 3))
    assert [s["x"].tolist() for s in shards] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    assert [s["s"] for s in shards] == [["a", "b"], ["c", "d"], ["e", "f"]]
    assert all(s["g"] == 1.5 and s["n"].dtype == torch.int64 for s in shards)
    assert parallel.gather_batch(shards)["s"] == list("abcdef")


@pytest.mark.parametrize("call,err,match", [
    (lambda: create_mesh(n_devices=torch.cuda.device_count() + 1),
     (ValueError, RuntimeError), "CUDA devices|is_available"),
    (lambda: create_mesh(n_devices=3, devices=CPU2), ValueError, "2 devices named"),
    (lambda: create_mesh(devices=["cuda:0", "cpu"]), ValueError, "one type|CUDA devices"),
    (lambda: create_mesh(devices=["cpu"] * 3, model_parallel=2), ValueError,
     "3 devices do not divide into model groups of model_parallel=2"),
    (lambda: RAGSampler(_port_model(), use_fused=True,
                        mesh=create_mesh(devices=["cpu"] * 4, model_parallel=2)), ValueError,
     "shard_map sampling mode is data-parallel only; got model axis of size 2"),
    (lambda: parallel.fsdp_train_step(_own_init_model(fused_train_backbone=True),
                                      DiffusionSchedule.create(steps=20), AdamW(LR),
                                      TrainConfig(), _mesh()), ValueError, "--fsdp needs"),
    (lambda: parallel.create_pipeline_mesh(devices=["cpu"] * 3), ValueError, "pipeline"),
    (lambda: shard_batch({"x": torch.zeros(3)}, create_mesh(devices=CPU2)), ValueError,
     "must divide"),
], ids=["more-cards", "more-than-named", "mixed", "model-parallel", "tp", "fsdp",
        "pipeline", "indivisible"])
def test_mesh_refuses(call, err, match):
    with pytest.raises(err, match=match):
        call()


def test_fold_in_gives_each_shard_its_own_stream():
    """Each shard computes fn on its slice with fold_in(generator, shard)
    (JAX ``test_shard_sample_fn_shard_map_folds_keys``); the shards draw
    differently, and the parent advances, so a second call draws anew."""
    mesh = _mesh()
    x = torch.zeros(4, 3)
    fn = lambda _, x, g: x + torch.randn(x.shape, generator=g)
    wrapped = shard_sample_fn(fn, mesh, [None, None], batched=(True, False), rng_arg=1)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    out = wrapped(x, g)
    parent = torch.Generator()
    parent.set_state(state)
    for i in (0, 1):
        expect = fn(None, x[2 * i: 2 * i + 2], fold_in(parent, i))
        torch.testing.assert_close(out[2 * i: 2 * i + 2], expect, rtol=0, atol=0)
    assert not torch.allclose(out[:2], out[2:])
    assert not torch.allclose(wrapped(x, g), out)


# --- training ----------------------------------------------------------------

def test_identical_shards_equal_the_single_step():
    """fold_shard_rng=False and the same shard on both: every replica sees
    the parent's stream, the mean of two equal gradients is that gradient,
    and three steps equal three single-device steps on the shard."""
    shard = _global_batch(1, B_LOCAL)
    both = {k: np.concatenate([v, v]) for k, v in shard.items()}
    single, ref = _own_init_model(), _own_init_model()
    state, step = _step(ref)
    dstate, dstep = _step(single, _mesh(), fold=False)
    for i in range(3):
        state, m = step(state, shard, torch.Generator().manual_seed(i))
        dstate, dm = dstep(dstate, both, torch.Generator().manual_seed(i))
        assert dm["loss"] == pytest.approx(m["loss"], rel=1e-6)
        assert torch.equal(dm["t"], torch.cat([m["t"], m["t"]]))
    for k, p in ref.state_dict().items():
        np.testing.assert_allclose(single.state_dict()[k].numpy(), p.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_data_parallel_step():
    """The JAX reference on two devices: each shard's value_and_grad with
    the injected draws, pmean of loss and grads and all_gather of the
    per-sample losses under shard_map (``trainer.py:251-259``), then
    optax.adamw. Compiled once a process."""
    params = _jax_models()[1]["rag"]
    jcfg = JRAGConfig.ted(**KW)
    rng = np.random.default_rng(30)
    b = 2 * B_LOCAL
    batch = _batch(rng, jcfg, b)
    draws = {"t": rng.integers(0, 20, size=(b,)),
             "noise": rng.normal(size=batch["motion"].shape).astype(np.float32),
             "style_eps": rng.normal(size=(b, 1, jcfg.latent_dim)).astype(np.float32),
             "cond_drop": (rng.random(b) < 0.3).astype(np.float32)}
    jm, jsched = JRAG(jcfg), JSchedule.create(steps=20)

    def local(p, motion, audio, vid, t, noise, style, drop):
        cond = {"audio": audio, "vid": vid, "origin_x": motion, "style_eps": style,
                "cond_drop": drop}

        def loss_fn(p):
            fn = lambda x_t, tm: jm.apply({"params": p}, x_t, tm, cond, train=True)
            terms = jl.training_losses(fn, jsched, motion, t, jax.random.PRNGKey(0),
                                       noise=noise)
            return jnp.mean(terms["loss_per_sample"]) + 0.01 * terms["kld"], terms

        (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return (jax.lax.pmean(loss, "data"), jax.lax.pmean(grads, "data"),
                jax.lax.all_gather(terms["loss_per_sample"], "data", tiled=True))

    step = jax.jit(shard_map(local, mesh=jcreate_mesh(n_devices=2),
                             in_specs=(P(),) + (P("data"),) * 7, out_specs=(P(), P(), P()),
                             check_vma=False))
    args = [jnp.asarray(batch[k]) for k in ("motion", "audio", "vid")] + [
        jnp.asarray(draws[k]) for k in ("t", "noise", "style_eps", "cond_drop")]
    loss, grads, lps = step(params, *args)
    tx = optax.adamw(LR, eps=1e-3, weight_decay=WD)
    new = optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])
    return batch, draws, float(loss), np.asarray(lps), jax_params_to_state_dict(
        jax.device_get(new))


def test_different_shards_match_the_jax_mean_of_shard_gradients():
    """Two different shards with injected draws: the averaged loss, the
    per-sample losses gathered in shard order, t in shard order, and the
    AdamW update of the averaged gradient."""
    batch, draws, loss, lps, ref = _jax_data_parallel_step()
    tm = _port_model()
    tx = AdamW(LR, weight_decay=WD, eps=1e-3)
    cfg = TrainConfig(lr=LR, weight_decay=WD, kld_weight=0.01)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
    step = shard_train_step(tm, DiffusionSchedule.create(steps=20), tx, cfg, _mesh())
    state, m = step(state, batch, None, **draws)
    np.testing.assert_allclose(m["loss"], loss, rtol=1e-5)
    assert m["t"].shape == m["loss_per_sample"].shape == (2 * B_LOCAL,)
    assert m["t"].tolist() == draws["t"].tolist()
    np.testing.assert_allclose(m["loss_per_sample"].numpy(), lps, rtol=1e-5)
    assert state.step == 1 and state.opt_state.count == 1 and m["skipped_nonfinite"] == 0.0
    for k, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_different_shards_equal_the_single_step_on_the_global_batch():
    """The same injected draws through the port's single step on the
    whole batch: the mean of the shards' losses and gradients is the
    global batch's. Adam's eps is 1e-3, as in the JAX comparison: its
    first step is g / (|g| + eps), which at 1e-8 turns the round-off of a
    near-zero gradient into a step of up to lr."""
    batch, draws, *_ = _jax_data_parallel_step()
    outs = []
    for mesh in (None, _mesh()):
        tm = _port_model()
        tx = AdamW(LR, weight_decay=WD, eps=1e-3)
        cfg = TrainConfig(lr=LR, weight_decay=WD)
        state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
        sched = DiffusionSchedule.create(steps=20)
        step = (make_train_step(tm, sched, tx, cfg) if mesh is None
                else shard_train_step(tm, sched, tx, cfg, mesh))
        state, m = step(state, batch, None, **draws)
        outs.append((m["loss"], m["loss_per_sample"], tm.state_dict()))
    (l1, ps1, p1), (l2, ps2, p2) = outs
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    np.testing.assert_allclose(ps2.numpy(), ps1.numpy(), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_loss_aware_history_sees_the_global_batch():
    """One count a global sample, on every replica's (shared) history; the
    folded streams draw different timesteps on the two shards."""
    tm = _own_init_model()
    state, step = _step(tm, _mesh(), schedule_sampler="loss-second-moment")
    state, m = step(state, _global_batch(2), torch.Generator().manual_seed(4))
    assert int(state.sampler_state.counts.sum()) == 2 * B_LOCAL
    assert not torch.equal(m["t"][:B_LOCAL], m["t"][B_LOCAL:])
    assert all(s.sampler_state is state.sampler_state for s in step.states())


def test_replicas_stay_bit_identical_and_the_fused_step_matches_eager():
    """Three steps of different shards with folded streams through the fused
    backbone (its plain versions on the CPU) and the eager one: the two
    replicas hold the same bits, moments included; after the first step
    fused matches eager within the single-device gate (loss rtol 1e-5,
    params atol 1e-5). Adam's eps is 1e-3, as in the JAX comparisons: at
    1e-8 its first step g / (|g| + eps) turns the round-off of a near-zero
    gradient into a step of up to lr."""
    out = []
    for fused in (False, True):
        tm = _port_model(fused_train_backbone=fused)
        state, step = _step(tm, _mesh(), eps=1e-3)
        for i in range(3):
            state, m = step(state, _global_batch(10 + i), torch.Generator().manual_seed(i))
            if i == 0:
                out.append((m["loss"], {k: v.clone() for k, v in tm.state_dict().items()}))
        r0, r1 = step.replicas
        s0, s1 = step.states()
        for (k, a), b in zip(r0.named_parameters(), r1.parameters()):
            assert torch.equal(a, b), k
            assert torch.equal(s0.opt_state.mu[k], s1.opt_state.mu[k]), k
            assert torch.equal(s0.opt_state.nu[k], s1.opt_state.nu[k]), k
        assert s0.opt_state.count == s1.opt_state.count == 3
    (le, pe), (lf, pf) = out
    np.testing.assert_allclose(lf, le, rtol=1e-5)
    for k in pe:
        if k not in ZERO_GRAD:
            np.testing.assert_allclose(pf[k].numpy(), pe[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_trainloop_with_a_mesh_resumes_bit_exact(tmp_path):
    """TrainLoop(mesh=[cpu, cpu]): 4 epochs of 2 global batches straight
    through, against 2 epochs and a resume to 4 from the one checkpoint
    written: shard 0's params and moments bit for bit, and both replicas
    equal after the resume."""
    tm = _own_init_model()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    batches = [_global_batch(20 + i) for i in range(2)]

    def loop(save_dir, epochs, resume=False):
        return TrainLoop(tm, DiffusionSchedule.create(steps=20), init, batches,
                         cfg=TrainConfig(lr=LR, ema_rate=0.9), save_dir=save_dir,
                         num_epochs=epochs, log_interval=1, save_after_epoch=-1,
                         save_every_epochs=1, seed=7, mesh=_mesh(), resume=resume)

    full = loop(str(tmp_path / "full"), 4).run_loop()
    full_params = {k: v.clone() for k, v in full.params.items()}
    full_mu = {k: v.clone() for k, v in full.opt_state.mu.items()}
    loop(str(tmp_path / "split"), 2).run_loop()
    resumed_loop = loop(str(tmp_path / "split"), 4, resume=True)
    assert resumed_loop.start_step == 4
    resumed = resumed_loop.run_loop()
    assert resumed.step == 8 and resumed.opt_state.count == 8
    for k, v in full_params.items():
        assert torch.equal(resumed.params[k], v), k
        assert torch.equal(resumed.opt_state.mu[k], full_mu[k]), k
    r0, r1 = resumed_loop.step_fn.replicas
    assert all(torch.equal(a, b) for a, b in zip(r0.parameters(), r1.parameters()))


def test_trainloop_mesh_options():
    tm = _own_init_model()
    sched = DiffusionSchedule.create(steps=20)
    with pytest.raises(ValueError, match="requires a mesh"):
        TrainLoop(tm, sched, None, [], use_shard_map=True, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        TrainLoop(tm, sched, None, [], mesh=_mesh(), device="cpu")
    one = TrainLoop(tm, sched, None, [], mesh=create_mesh(devices=["cpu"]))
    assert not hasattr(one.step_fn, "replicas")  # one device: the plain step
    assert hasattr(TrainLoop(tm, sched, None, [], mesh=create_mesh(devices=["cpu"]),
                             use_shard_map=True).step_fn, "replicas")


class _Rows:
    def __init__(self, n=24):
        rng = np.random.default_rng(5)
        self.audio = rng.normal(size=(n, 7)).astype(np.float32)
        self.vid = np.arange(n, dtype=np.int32)

    def __len__(self):
        return len(self.vid)

    def batch(self, idx, fields=None):
        return {"audio": self.audio[idx], "vid": self.vid[idx], "sentence": [str(i) for i in idx]}


@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
def test_loaders_yield_one_batch_a_shard(resident):
    """A mesh that names the CPU twice: each batch is a list of two shards
    whose concatenation is the single-device batch; the resident copy is
    held once."""
    ds, mesh = _Rows(), _mesh()
    kw = dict(batch_size=8, seed=4)
    if resident:
        sharded = DeviceDataLoader(ds, mesh=mesh, **kw)
        assert list(sharded._dev) == [torch.device("cpu")]
    else:
        sharded = DataLoader(ds, mesh=mesh, **kw)
    whole = DataLoader(ds, device="cpu", **kw)
    n = 0
    for shards, b in zip(sharded, whole, strict=True):
        assert len(shards) == 2
        for k in ("audio", "vid"):
            assert torch.equal(torch.cat([s[k] for s in shards]), b[k])
        n += 1
    assert n == 3
    with pytest.raises(ValueError, match="not both"):
        DataLoader(ds, mesh=mesh, device="cpu", **kw)


# --- sampling ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_sharded_sample():
    """JAX RAGSampler(mesh=create_mesh(2)) on the XLA denoiser, DDIM-5 at
    eta 0, and the initial noise it draws from its key."""
    params = _jax_models()[1]["rag"]
    rng = np.random.default_rng(40)
    b = 2 * B_LOCAL
    full = _batch(rng, JRAGConfig.ted(**KW), b)
    cond = {"audio": full["audio"], "vid": full["vid"], "origin_x": full["motion"],
            "style_eps": rng.normal(size=(b, 1, KW["latent_dim"])).astype(np.float32)}
    key = jax.random.PRNGKey(11)
    sampler = JRAGSampler(JRAG(JRAGConfig.ted(**KW)), jax.tree_util.tree_map(jnp.asarray, params),
                          steps=50, timestep_respacing="ddim5", method="ddim",
                          mesh=jcreate_mesh(n_devices=2))
    out = np.asarray(sampler({k: jnp.asarray(v) for k, v in cond.items()}, key, guidance=1.5))
    noise = np.array(jax.random.normal(jax.random.split(key)[1], out.shape, jnp.float32))
    return cond, noise, out


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("use_fused", [False, True], ids=["eager", "fused"])
def test_sharded_sampler_matches_single_device_and_jax(use_fused):
    cond, noise, ref = _jax_sharded_sample()
    tm = _port_model()
    tcond = {k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()}
    kw = dict(steps=50, timestep_respacing="ddim5", method="ddim", use_fused=use_fused)
    sharded = RAGSampler(tm, mesh=_mesh(), **kw)(
        tcond, torch.Generator().manual_seed(0), guidance=1.5, noise=torch.from_numpy(noise))
    single = RAGSampler(_port_model(), device="cpu", **kw)(
        tcond, None, guidance=1.5, noise=torch.from_numpy(noise))
    assert sharded.shape == ref.shape and torch.isfinite(sharded).all()
    assert _rel(sharded, single) <= SAMPLE_TOL
    assert _rel(sharded, ref) <= SAMPLE_TOL


@pytest.mark.parametrize("method,skip,inpaint", [
    ("ddpm", 0, False), ("ddim", 2, True), ("plms", 0, True), ("dpmpp", 1, False)])
def test_each_shard_samples_its_rows_with_its_folded_stream(method, skip, inpaint):
    """Every method, 'step:T0' guidance, skip with an init image, and
    inpainting with a mask broadcast over the batch: shard i of the sharded
    call is the unsharded sampler on rows of shard i with fold_in(generator,
    i) (JAX ``test_rag_sampler_fused_mesh_shard_map``), bit for bit."""
    from livelyspeaker_tpu_torch.diffusion.sampling import Inpainting

    cond, noise, _ = _jax_sharded_sample()
    tcond = {k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()
             if k != "style_eps"}
    b = tcond["vid"].shape[0]
    kw = dict(steps=50, timestep_respacing="ddim5", method=method, use_fused=True,
              guidance_schedule="step:500")
    rng = np.random.default_rng(41)
    guidance = torch.from_numpy(rng.uniform(1.0, 2.5, size=b).astype(np.float32))
    init = torch.from_numpy(rng.normal(size=(b, 9, 3, 34)).astype(np.float32)) if skip else None
    inpainting = None
    if inpaint:
        mask = torch.zeros(1, 1, 1, 34, dtype=torch.bool)
        mask[..., :4] = True
        inpainting = Inpainting(mask, torch.from_numpy(noise), noised=method != "plms")
    g = torch.Generator().manual_seed(8)
    parent = torch.Generator()
    parent.set_state(g.get_state())
    out = RAGSampler(_port_model(), mesh=_mesh(), **kw)(
        tcond, g, guidance=guidance, skip_timesteps=skip, init_image=init,
        inpainting=inpainting)
    single = RAGSampler(_port_model(), device="cpu", **kw)
    for i in (0, 1):
        rows = slice(i * b // 2, (i + 1) * b // 2)
        part = None if inpainting is None else Inpainting(
            inpainting.mask.expand(b, 9, 3, 34)[rows], inpainting.motion[rows],
            inpainting.noised)
        expect = single({k: v[rows] for k, v in tcond.items()}, fold_in(parent, i),
                        guidance=guidance[rows], skip_timesteps=skip,
                        init_image=None if init is None else init[rows], inpainting=part)
        torch.testing.assert_close(out[rows], expect, rtol=0, atol=0)
    if inpaint:  # the held frames are the constraint's, q-sampled or clean
        assert torch.isfinite(out).all()


def test_sharded_sampler_refuses_an_indivisible_batch_and_reloads_every_replica():
    cond, noise, _ = _jax_sharded_sample()
    tm = _port_model()
    sampler = RAGSampler(tm, steps=50, timestep_respacing="ddim2", mesh=_mesh())
    tcond = {k: torch.from_numpy(np.asarray(v)[:3]) for k, v in cond.items()}
    with pytest.raises(ValueError, match="must divide"):
        sampler(tcond)
    new = {k: v + 0.01 for k, v in tm.state_dict().items()}
    sampler.update_params(new)
    for r in sampler.replicas:
        assert all(torch.equal(v, new[k]) for k, v in r.state_dict().items())
    with pytest.raises(ValueError, match="not both"):
        RAGSampler(tm, mesh=_mesh(), device="cpu")


def test_sharded_composition_matches_jax():
    """JAX LivelySpeakerPipeline(mesh=create_mesh(2)) at ddim100, skip 80,
    guidance 1.5 (XLA denoiser) against the port's on [cpu, cpu]: the
    sharded sketch (CLIP encode and SAG decode a shard), refined by the
    sharded sampler from the noise the JAX key draws. Then __call__ runs."""
    models, params = _jax_models()
    on_jax = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    meshed = JPipeline(models["rag"], on_jax(params["rag"]), models["sag"],
                       on_jax(params["sag"]), models["clip"], on_jax(params["clip"]),
                       JHashTokenizer(), mesh=jcreate_mesh(n_devices=2))
    cond = _jax_sharded_sample()[0]
    key = jax.random.PRNGKey(12)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    ref = np.asarray(meshed(SENTENCES, jcond, key, guidance=1.5))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], ref.shape, jnp.float32))
    sag, clip_text = _port_stages()
    pipe = LivelySpeakerPipeline(_port_model(), sag, clip_text, HashTokenizer(), mesh=_mesh())
    tcond = {k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()}
    sketch = pipe.semantic_sketch(SENTENCES, tcond["origin_x"])
    jsketch = np.asarray(meshed.semantic_sketch(SENTENCES, jcond["origin_x"]))
    assert _rel(sketch, jsketch) <= SKETCH_TOL
    out = pipe.rag_sampler(tcond, None, guidance=1.5, skip_timesteps=80, init_image=sketch,
                           noise=torch.from_numpy(noise))
    assert _rel(out, ref) <= COMPOSITION_TOL
    clip = pipe(SENTENCES, tcond, torch.Generator().manual_seed(1))
    assert clip.shape == ref.shape and torch.isfinite(clip).all()


# --- the entry points --------------------------------------------------------

def test_two_shard_server_answers_plain_text_and_long_requests():
    """build_rag_server on a mesh of two shards, with a composition on the
    same mesh: plain and text requests and a long-form chain are answered
    with finite clips; serving_mesh refuses what it cannot split."""
    trag, (tsag, tclip) = _port_model(), _port_stages()
    mesh = serving_mesh(ServeConfig(max_batch=2, data_parallel=2), "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 2
    comp = LivelySpeakerPipeline(trag, tsag, tclip, HashTokenizer(), timestep_respacing="ddim10",
                                 skip_timesteps=8, use_fused=True, mesh=mesh)
    cfg = ServeConfig(max_batch=2, data_parallel=2, steps=50, timestep_respacing="ddim5",
                      sampler="ddim", max_wait_ms=50.0)
    batcher = build_rag_server(trag, cfg, composition=comp, mesh=mesh)
    try:
        audio = np.zeros(batcher.n_samples, np.float32)
        reqs = [batcher.submit(audio, speaker=1), batcher.submit(audio, text="hello there")]
        for r in reqs:
            clip = r.wait(120)
            assert clip.shape == (9, 3, 34) and np.isfinite(clip).all()
        long = batcher.long_form(np.zeros(40000, np.float32), speaker=2)
        assert long.shape == (9, 3, 37) and np.isfinite(long).all()
        assert batcher.sampler.mesh is mesh and len(batcher.sampler.replicas) == 2
    finally:
        batcher.close()
    with pytest.raises(ValueError, match="multiple"):
        serving_mesh(ServeConfig(max_batch=3, data_parallel=2), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            serving_mesh(ServeConfig(data_parallel=2))


def test_long_form_over_a_sharded_sampler():
    """generate_long_form with a sampler on a mesh runs each window as a
    batch of the mesh's size and keeps row 0: finite, the window grid's
    length."""
    sampler = RAGSampler(_port_model(), steps=50, timestep_respacing="ddim2", mesh=_mesh())
    out = generate_long_form(sampler, np.zeros(40000, np.float32), 1,
                             torch.Generator().manual_seed(2))
    assert out.shape == (9, 3, 37) and np.isfinite(out).all()


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """Small TED records and a RAG npz (latent 32, 1 block) with its
    args.json."""
    root = tmp_path_factory.mktemp("parallel_runs")
    ted = str(root / "ted")
    build_synthetic_ted_records(ted, n_clips=2, clip_seconds=10, seed=33)
    model = RAG(RAGConfig.ted(latent_dim=32, num_layers=1, n_speakers=40),
                generator=torch.Generator().manual_seed(6))
    save_params_npz(str(root / "model000000010.npz"), model.state_dict(), model)
    save_args(str(root), {"latent_dim": 32, "layers": 1, "n_speakers": 40})
    return {"ted": ted, "rag": str(root / "model000000010.npz")}


def test_eval_data_parallel_gives_the_single_device_numbers(run_files, monkeypatch):
    """eval_rag_ted --device cpu --data_parallel 2 against --data_parallel
    1 on a deterministic route: a denoiser that answers each row from its
    own conditioning and ignores x, so that DDIM at eta 0 ends on it
    whatever the noise. The same numbers, and twice the denoiser builds
    (one a shard a batch)."""
    import livelyspeaker_tpu_torch.pipeline as pipeline_mod

    builds = []

    def stub(model, cond, guidance, guidance_schedule=None):
        b = cond["vid"].shape[0]
        builds.append(b)
        scale = torch.as_tensor(guidance, dtype=torch.float32).expand(b).reshape(b, 1, 1, 1)
        row = cond["origin_x"] * 0.9 + 0.01 * cond["vid"].float().reshape(b, 1, 1, 1)
        return lambda x, t, generator=None: row * scale

    monkeypatch.setattr(pipeline_mod, "make_fused_cfg_denoiser", stub)
    results = {}
    for dp in (1, 2):
        builds.clear()
        results[dp] = eval_rag_ted.main(["--model_path", run_files["rag"], "--data_dir",
                                         run_files["ted"], "--device", "cpu", "--fused",
                                         "--timestep_respacing", "ddim5", "--batch_size", "8",
                                         "--data_parallel", str(dp)])
        results[dp, "builds"] = list(builds)
    np.testing.assert_array_equal(np.asarray(results[2]), np.asarray(results[1]))
    assert results[2, "builds"] == [4] * (2 * len(results[1, "builds"]))
    assert results[1, "builds"] and set(results[1, "builds"]) == {8}


def test_train_rag_on_a_list_of_devices(run_files, tmp_path):
    """train_rag --device cpu,cpu --fused_train: two data-parallel steps
    (the LR anneal stops the loop), finite losses, both replicas equal."""
    loop = train_rag.main(["--dataset", "ted", "--data_dir", run_files["ted"], "--save_dir",
                           str(tmp_path), "--device", "cpu,cpu", "--fused_train",
                           "--latent_dim", "32", "--layers", "1", "--batch_size", "8",
                           "--lr_anneal_steps", "2", "--log_interval", "1", "--epochs", "5"])
    assert loop.step == 2 and loop.mesh.size == 2
    r0, r1 = loop.step_fn.replicas
    assert all(torch.equal(a, b) for a, b in zip(r0.parameters(), r1.parameters()))
    with open(os.path.join(str(tmp_path), "progress.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if line.strip()]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.exists(os.path.join(str(tmp_path), "model000000002.npz"))
    with pytest.raises(SystemExit, match="multiple"):
        train_rag.main(["--dataset", "ted", "--data_dir", run_files["ted"], "--save_dir",
                        str(tmp_path), "--device", "cpu,cpu,cpu", "--latent_dim", "32",
                        "--layers", "1", "--batch_size", "8", "--epochs", "1"])
