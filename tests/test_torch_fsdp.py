"""The parameter rules and FSDP of the port (``parallel/mesh.py``,
``parallel/training.py: fsdp_train_step``) against the JAX package's.

The rules: the port's spec of every RAG parameter (TED, full width, on a
mesh of two data shards) is the JAX spec of its Flax counterpart carried
through the converter's layout (``utils/convert.py``), leaf for leaf, for
``param_spec`` and for ``fsdp_param_shardings`` at the default
``min_size`` and at 1. The step: the small RAG (latent 32, 2 blocks), the
same seeded numpy inputs and randomised weights on both sides; one FSDP
step on ``[cpu, cpu]`` with injected t, noise, style and drop against the
JAX FSDP step on two of the eight virtual CPU devices
(``tests/test_sharded_training.py:161``'s placement, with AdamW at eps
1e-3 as ``test_torch_parallel`` takes it) and against the port's
replicated step: loss rtol 1e-5, params atol 1e-6 (``test_torch_parallel``'s
gates); each shard holds half of each sharded leaf, moments and EMA
included. Then a sharded ``TrainLoop`` resumes bit-exact and stays sharded.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from livelyspeaker_tpu.diffusion import losses as jl
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.parallel import batch_sharding as jbatch_sharding
from livelyspeaker_tpu.parallel import create_mesh as jcreate_mesh
from livelyspeaker_tpu.parallel import create_pipeline_mesh as jcreate_pipeline_mesh
from livelyspeaker_tpu.parallel import fsdp_param_shardings as jfsdp_param_shardings
from livelyspeaker_tpu.parallel import fsdp_shard_params as jfsdp_shard_params
from livelyspeaker_tpu.parallel import preserve_state_shardings as jpreserve
from livelyspeaker_tpu.parallel.mesh import param_shardings as jparam_shardings
from livelyspeaker_tpu.parallel.mesh import param_spec as jparam_spec
from livelyspeaker_tpu_torch import parallel
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import RAG, RAGConfig, audio_samples_for_frames
from livelyspeaker_tpu_torch.training import TrainConfig, init_train_state
from livelyspeaker_tpu_torch.training.loop import TrainLoop
from livelyspeaker_tpu_torch.training.trainer import AdamW
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, \
    random_normal_params

KW = dict(latent_dim=32, num_layers=2, n_speakers=6)
B = 8  # the global batch, two shards of 4
LR, WD = 1e-3, 1e-2
CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, b=B):
    return {"motion": (0.3 * rng.normal(size=(b, 9, 3, 34))).astype(np.float32),
            "audio": (0.1 * rng.normal(size=(b, audio_samples_for_frames(34))))
            .astype(np.float32),
            "vid": rng.integers(0, KW["n_speakers"], size=(b,))}


def _init_args(jcfg, b=2):
    x = _batch(np.random.default_rng(0), b)
    cond = {"audio": jnp.asarray(x["audio"]), "vid": jnp.asarray(x["vid"]),
            "origin_x": jnp.asarray(x["motion"])}
    return jnp.asarray(x["motion"]), jnp.zeros((b,), jnp.int32), cond


def _jax_shapes(jcfg):
    """The JAX RAG's param tree as ShapeDtypeStructs (no forward runs)."""
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: JRAG(jcfg).init({"params": key, "style": key},
                                                  *_init_args(jcfg)))["params"]


def _zeros_like(shapes):
    """Zeros of a ShapeDtypeStruct tree: ``random_normal_params`` reads only
    their shapes, so no init runs."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _torch_terms(flax_specs):
    """{state_dict key: spec in torch's dims} of a {flax path: (ndim, spec)}
    dict, through the converter: a leaf of shape (2, 3, ...) converted by
    ``jax_params_to_state_dict`` says where each Flax dim went."""
    out = {}
    for path, (ndim, spec) in flax_specs.items():
        shape = tuple(range(2, 2 + ndim))
        tree = node = {}
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(shape, np.float32)
        ((name, t),) = jax_params_to_state_dict(tree).items()
        out[name] = tuple(spec[shape.index(s)] for s in t.shape)
    return out


def _padded(spec, ndim):
    return (tuple(spec) + (None,) * ndim)[:ndim]


def _flax_items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), leaf) for path, leaf in flat]


@pytest.fixture(scope="module")
def ted():
    """The TED RAG at full width: the JAX param shapes and the port's
    model (its own init; only the names and shapes matter here)."""
    return _jax_shapes(JRAGConfig.ted()), RAG(RAGConfig.ted())


def test_param_spec_matches_jax_for_every_parameter(ted):
    shapes, model = ted
    expect = _torch_terms({path: (leaf.ndim, _padded(jparam_spec(path, leaf), leaf.ndim))
                           for path, leaf in _flax_items(shapes)})
    got = {name: parallel.param_spec(model, name) for name, _ in model.named_parameters()}
    assert got == expect
    assert sum(parallel.MODEL_AXIS in s for s in got.values()) > 10  # the rules match


@pytest.mark.parametrize("kind", ["data", "pipeline"])
def test_param_shardings_match_jax_leaf_for_leaf(ted, kind):
    """On a mesh of two data shards (a model axis of 1: the rules' specs)
    and on a pipeline mesh of one row of two stages (no model axis: all
    replicated); ``shard_params`` gives one replica a shard."""
    shapes, model = ted
    if kind == "data":
        jmesh, mesh = jcreate_mesh(n_devices=2), parallel.create_mesh(devices=CPU2)
    else:
        jmesh = jcreate_pipeline_mesh(n_devices=2, pipeline_parallel=2)
        mesh = parallel.create_pipeline_mesh(devices=CPU2, pipeline_parallel=2)
    jspecs = jparam_shardings(shapes, jmesh)
    expect = _torch_terms({path: (leaf.ndim, _padded(s.spec, leaf.ndim)) for (path, leaf), s
                           in zip(_flax_items(shapes), jax.tree_util.tree_leaves(jspecs))})
    got = parallel.param_shardings(model, mesh)
    assert got == expect
    assert (sum(parallel.MODEL_AXIS in s for s in got.values()) > 10) == (kind == "data")
    replicas = parallel.shard_params(model, mesh)
    assert len(replicas) == mesh.size
    assert all(torch.equal(p, model.get_parameter(k)) for r in replicas
               for k, p in r.named_parameters())


@pytest.mark.parametrize("min_size", [parallel.FSDP_MIN_SIZE, 1], ids=["default", "one"])
def test_fsdp_param_shardings_match_jax_leaf_for_leaf(ted, min_size):
    shapes, model = ted
    jspecs = jfsdp_param_shardings(shapes, jcreate_mesh(n_devices=2), min_size=min_size)
    expect = _torch_terms({path: (leaf.ndim, _padded(s.spec, leaf.ndim)) for (path, leaf), s
                           in zip(_flax_items(shapes), jax.tree_util.tree_leaves(jspecs))})
    got = parallel.fsdp_param_shardings(model, parallel.create_mesh(devices=CPU2), min_size)
    assert got == expect
    n_sharded = sum(parallel.DATA_AXIS in s for s in got.values())
    assert n_sharded > (20 if min_size == 1 else 10)


@functools.lru_cache(maxsize=None)
def _jax_fsdp_step():
    """The JAX package's FSDP placement on two CPU devices (min_size 1),
    one jitted step of the global batch with the injected draws through
    optax.adamw, the state pinned to its placement. Compiled once."""
    jcfg = JRAGConfig.ted(**KW)
    rng = np.random.default_rng(80)
    key = jax.random.PRNGKey(0)
    params = random_normal_params(_zeros_like(_jax_shapes(jcfg)), rng)
    batch = _batch(rng)
    draws = {"t": rng.integers(0, 20, size=(B,)),
             "noise": rng.normal(size=batch["motion"].shape).astype(np.float32),
             "style_eps": rng.normal(size=(B, 1, KW["latent_dim"])).astype(np.float32),
             "cond_drop": (rng.random(B) < 0.3).astype(np.float32)}
    jm, jsched = JRAG(jcfg), JSchedule.create(steps=20)
    tx = optax.adamw(LR, eps=1e-3, weight_decay=WD)
    mesh = jcreate_mesh(n_devices=2)

    def step(st, data, _):
        p, opt = st

        def loss_fn(p):
            cond = {"audio": data["audio"], "vid": data["vid"], "origin_x": data["motion"],
                    "style_eps": data["style_eps"], "cond_drop": data["cond_drop"]}
            fn = lambda x_t, tm: jm.apply({"params": p}, x_t, tm, cond, train=True)
            terms = jl.training_losses(fn, jsched, data["motion"], data["t"], key,
                                       noise=data["noise"])
            return jnp.mean(terms["loss_per_sample"]) + 0.01 * terms["kld"]

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt = tx.update(grads, opt, p)
        return (optax.apply_updates(p, updates), opt), loss

    fparams = jfsdp_shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh, min_size=1)
    st = (fparams, tx.init(fparams))
    data = {k: jax.device_put(jnp.asarray(v), jbatch_sharding(mesh))
            for k, v in {**batch, **draws}.items()}
    (new, _), loss = jax.jit(jpreserve(step, st))(st, data, None)
    return params, batch, draws, float(loss), jax_params_to_state_dict(jax.device_get(new))


def _port_step(kind, params):
    tm = RAG(RAGConfig.ted(**KW))
    tm.load_state_dict(jax_params_to_state_dict(params))
    tx = AdamW(LR, weight_decay=WD, eps=1e-3)
    cfg = TrainConfig(lr=LR, weight_decay=WD, kld_weight=0.01, ema_rate=0.9)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
    mesh = parallel.create_mesh(devices=CPU2)
    make = parallel.fsdp_train_step if kind == "fsdp" else parallel.shard_train_step
    kw = {"min_size": 1} if kind == "fsdp" else {}
    return make(tm, DiffusionSchedule.create(steps=20), tx, cfg, mesh, **kw), state


def test_fsdp_step_matches_jax_and_the_replicated_step():
    params, batch, draws, jloss, jnew = _jax_fsdp_step()
    step, state = _port_step("fsdp", params)
    state, m = step(state, batch, None, **draws)
    rstep, rstate = _port_step("dp", params)
    rstate, rm = rstep(rstate, batch, None, **draws)
    full = step.gathered_state()
    np.testing.assert_allclose(m["loss"], jloss, rtol=1e-5)
    np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-5)
    assert m["t"].tolist() == draws["t"].tolist() and state.opt_state.count == 1
    for k, v in full.params.items():
        np.testing.assert_allclose(v.numpy(), jnew[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(v.numpy(), rstate.params[k].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(full.ema_params[k].numpy(), rstate.ema_params[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(full.opt_state.mu[k].numpy(),
                                   rstate.opt_state.mu[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)

    # ZeRO-3 memory: each shard holds half of every sharded leaf
    dims = step.shards.dims
    assert len(dims) > 20
    for s in step.states():
        for k, d in dims.items():
            for tree in (s.params, s.opt_state.mu, s.opt_state.nu, s.ema_params):
                assert 2 * tree[k].shape[d] == full.params[k].shape[d], k
    for r in step.replicas:  # the gathered weights are freed after the step
        assert all(p.numel() == 0 for k, p in r.named_parameters() if k in dims)


def test_fsdp_clips_by_the_global_norm():
    """With grad_clip, each shard clips its slices by the norm of the whole
    gradient: a step equals the replicated step within the gates (the norm
    comes from the slices' norms, summed on the host: 5e-7 relative from
    the replicated step's f32 norm)."""
    rng = np.random.default_rng(83)
    params = jax.tree_util.tree_map(lambda a: 0.1 * rng.normal(size=a.shape).astype(np.float32),
                                    _jax_shapes(JRAGConfig.ted(**KW)))
    batch, out = _batch(rng), []
    for kind in ("fsdp", "dp"):
        tm = RAG(RAGConfig.ted(**KW))
        tm.load_state_dict(jax_params_to_state_dict(params))
        cfg = TrainConfig(lr=LR, grad_clip=0.05)
        tx = AdamW(LR, grad_clip=0.05, eps=1e-3)
        state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
        make = parallel.fsdp_train_step if kind == "fsdp" else parallel.shard_train_step
        kw = {"min_size": 1} if kind == "fsdp" else {}
        step = make(tm, DiffusionSchedule.create(steps=20), tx, cfg,
                    parallel.create_mesh(devices=CPU2), **kw)
        state, m = step(state, batch, torch.Generator().manual_seed(1))
        full = step.gathered_state() if kind == "fsdp" else state
        out.append((m["grad_norm"], {k: v.detach().clone() for k, v in full.params.items()}))
    (nf, pf), (nr, pr) = out
    assert nr > 0.05  # the clip is active
    np.testing.assert_allclose(nf, nr, rtol=1e-5)
    for k in pr:
        np.testing.assert_allclose(pf[k].numpy(), pr[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_fsdp_refuses_the_fused_backbone_on_two_shards():
    tm = RAG(RAGConfig.ted(**KW, fused_train_backbone=True))
    cfg = TrainConfig()
    with pytest.raises(ValueError, match="--fsdp needs the GSPMD train step"):
        parallel.fsdp_train_step(tm, DiffusionSchedule.create(steps=20), AdamW(LR), cfg,
                                 parallel.create_mesh(devices=CPU2))


def test_preserve_state_shardings_raises_on_a_moved_leaf():
    rng = np.random.default_rng(82)
    params = jax.tree_util.tree_map(lambda a: 0.1 * rng.normal(size=a.shape).astype(np.float32),
                                    _jax_shapes(JRAGConfig.ted(**KW)))
    batch, draws = _batch(rng), {"t": rng.integers(0, 20, size=(B,))}
    step, state = _port_step("fsdp", params)
    state = step.shard(state)
    pinned = parallel.preserve_state_shardings(step, state)
    state, _ = pinned(state, batch, None, **draws)  # the slices stay as they were
    assert pinned.shards is step.shards

    def regathering(st, *args, **kw):
        return step.gathered_state(), {}

    with pytest.raises(RuntimeError, match="placement"):
        parallel.preserve_state_shardings(regathering, state)(state, batch)


def test_fsdp_trainloop_resumes_bit_exact_and_stays_sharded(tmp_path):
    """TrainLoop(mesh=[cpu, cpu], fsdp=True) at the default min_size: 2
    epochs of 2 global batches straight through, against 1 epoch and a
    resume to 2 from the one (gathered) checkpoint: the full params and
    moments bit for bit, and the resumed state still sliced."""
    rng = np.random.default_rng(81)
    batches = [_batch(rng) for _ in range(2)]
    init = {k: v.clone() for k, v in
            RAG(RAGConfig.ted(**KW), generator=torch.Generator().manual_seed(3))
            .state_dict().items()}

    def loop(save_dir, epochs, resume=False):
        return TrainLoop(RAG(RAGConfig.ted(**KW)), DiffusionSchedule.create(steps=20), init,
                         batches, cfg=TrainConfig(lr=LR, ema_rate=0.9), save_dir=save_dir,
                         num_epochs=epochs, log_interval=1, save_after_epoch=-1,
                         save_every_epochs=1, seed=7, mesh=parallel.create_mesh(devices=CPU2),
                         fsdp=True, resume=resume)

    straight = loop(str(tmp_path / "full"), 2)
    straight.run_loop()
    full = straight.step_fn.gathered_state()
    loop(str(tmp_path / "split"), 1).run_loop()
    resumed_loop = loop(str(tmp_path / "split"), 2, resume=True)
    assert resumed_loop.start_step == 2
    resumed_loop.run_loop()
    resumed = resumed_loop.step_fn.gathered_state()
    assert resumed.step == 4 and resumed.opt_state.count == 4
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k
        assert torch.equal(resumed.opt_state.mu[k], full.opt_state.mu[k]), k
        assert torch.equal(resumed.ema_params[k], full.ema_params[k]), k
    dims = resumed_loop.step_fn.shards.dims
    assert dims and all(2 * resumed_loop.state.params[k].shape[d] == full.params[k].shape[d]
                        for k, d in dims.items())
    saved = torch.load(str(tmp_path / "split" / "ckpt_000000004.pt"), weights_only=True)
    assert all(saved["params"][k].shape == v.shape for k, v in full.params.items())
