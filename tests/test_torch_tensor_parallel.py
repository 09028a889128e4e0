"""Tensor-parallel compute of the port over a model axis above 1
(``parallel/tensor_parallel.py`` and the TP replicas of ``parallel/mesh.py``)
against the single-device port and the JAX package's GSPMD placements.

The port's meshes name the CPU by repeats: ``["cpu"] * 4`` is data 2 x
model 2, ``["cpu"] * 8`` data 2 x stage 2 x model 2; the JAX side runs on
the same number of the eight virtual CPU devices of ``tests/conftest.py``.
Small widths (latent 32, one or two blocks; the SAG and CLIP towers of
``test_torch_parallel``), seeded numpy inputs, randomised weights on both
sides. Tolerances:

- each product and a TP replica's forward (RAG, SAG decode, CLIP text
  tower) against the single-device module: rtol 1e-5, atol 1e-6 (the
  slices' dot products are the whole one's, cut; a row-parallel sum and a
  gathered q|k|v product round in another order); the gradients (of a
  fixed random projection of the output) by the same rtol and atol 1e-6 of
  each leaf's largest gradient, since an element that cancels carries the
  rounding of the leaf's scale, not its own (the RAG's WavEncoder weights
  have gradients near 30); the WavEncoder conv biases before an
  InstanceNorm, whose exact gradient is 0, are held below 1e-4 of the
  model's largest gradient;
- the sampler (DDIM at eta 0 from injected noise and style draws) against
  the single-device port and JAX ``RAGSampler`` on ``create_mesh(n_devices=4,
  model_parallel=2)``: rtol 1e-4, atol 1e-4, the JAX test's own gate
  (``test_multichip.py:117-119``);
- one replicated DP x TP step against the single-device step: loss rel
  1e-5, params atol 1e-6 (``test_torch_parallel``'s gates);
- one FSDP step on data 2 x model 2 against JAX's FSDP step on the same mesh
  shape: loss rtol 1e-5, params, moments and EMA atol 1e-6 (the FSDP gates),
  except the WavEncoder conv biases that feed an InstanceNorm: their exact
  gradient is 0, and what autodiff returns is reduction-order noise that
  AdamW turns into a step of up to lr, so they are held to steps x lr
  (``test_sharded_training.py:166-174`` records the same);
- the pipeline on data 2 x stage 2 x model 2 against JAX ``pipeline_forward``
  on the same mesh shape: atol 1e-5; its gradients against the sequential
  stack's: rtol 2e-3, atol 2e-4 (``test_pipeline_parallel.py``'s).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F

from livelyspeaker_tpu.diffusion import losses as jl
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.models import clip_text as jclip
from livelyspeaker_tpu.models import sag as jsag
from livelyspeaker_tpu.parallel import batch_sharding as jbatch_sharding
from livelyspeaker_tpu.parallel import create_mesh as jcreate_mesh
from livelyspeaker_tpu.parallel import create_pipeline_mesh as jcreate_pipeline_mesh
from livelyspeaker_tpu.parallel import fsdp_shard_params as jfsdp_shard_params
from livelyspeaker_tpu.parallel import pipeline_forward as jpipeline_forward
from livelyspeaker_tpu.parallel import preserve_state_shardings as jpreserve
from livelyspeaker_tpu.parallel import stack_block_params as jstack_block_params
from livelyspeaker_tpu.parallel.mesh import param_shardings as jparam_shardings
from livelyspeaker_tpu.pipeline import RAGSampler as JRAGSampler
from livelyspeaker_tpu_torch import parallel
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import RAG, SAG, CLIPTextConfig, CLIPTextEncoder, RAGConfig
from livelyspeaker_tpu_torch.parallel.tensor_parallel import TPWeight, merge_values, tp_layout
from livelyspeaker_tpu_torch.pipeline import RAGSampler
from livelyspeaker_tpu_torch.training import TrainConfig, init_train_state, make_train_step
from livelyspeaker_tpu_torch.training.loop import TrainLoop
from livelyspeaker_tpu_torch.training.trainer import AdamW
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, random_normal_params

from test_torch_fsdp import _flax_items, _padded, _torch_terms
from test_torch_parallel import CLIP, SAG_KW
from test_torch_pipeline_parallel import _inputs as _stack_inputs
from test_torch_pipeline_parallel import _port_stack
from test_torch_training import ZERO_GRAD

KW = dict(latent_dim=32, num_layers=2, n_speakers=6)
CPU4, CPU8 = ["cpu"] * 4, ["cpu"] * 8
B = 8  # the global batch: two data rows of 4
LR, WD = 1e-3, 1e-2
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return parallel.create_mesh(devices=CPU4, model_parallel=2)


def _batch(rng, b=B, latent=KW["latent_dim"]):
    from livelyspeaker_tpu_torch.models import audio_samples_for_frames

    batch = {"motion": (0.3 * rng.normal(size=(b, 9, 3, 34))).astype(np.float32),
             "audio": (0.1 * rng.normal(size=(b, audio_samples_for_frames(34))))
             .astype(np.float32),
             "vid": rng.integers(0, KW["n_speakers"], size=(b,))}
    draws = {"t": rng.integers(0, 20, size=(b,)),
             "noise": rng.normal(size=(b, 9, 3, 34)).astype(np.float32),
             "style_eps": rng.normal(size=(b, 1, latent)).astype(np.float32),
             "cond_drop": (rng.random(b) < 0.3).astype(np.float32)}
    return batch, draws


def _jax_cond(b=2):
    batch, _ = _batch(np.random.default_rng(0), b)
    return {"audio": jnp.asarray(batch["audio"]), "vid": jnp.asarray(batch["vid"]),
            "origin_x": jnp.asarray(batch["motion"])}


@functools.lru_cache(maxsize=None)
def _jax_params(kind, seed=1, **cfg_kw):
    """(Flax module, shapes, seeded-normal params) of the RAG (``KW`` and
    ``cfg_kw``), the SAG or the CLIP text tower: ``jax.eval_shape`` of the
    init, so no forward runs."""
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((2, 9, 3, 34))
    if kind == "rag":
        module = JRAG(JRAGConfig.ted(**{**KW, **cfg_kw}))
        init = lambda: module.init({"params": key, "style": key}, x, jnp.zeros((2,), jnp.int32),
                                   _jax_cond())
    elif kind == "sag":
        module = jsag.SAG(**SAG_KW)
        init = lambda: module.init({"params": key, "style": key}, x)
    else:
        module = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**CLIP))
        init = lambda: module.init(key, jnp.zeros((1, 77), jnp.int32))
    shapes = jax.eval_shape(init)["params"]
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    return module, shapes, random_normal_params(zeros, np.random.default_rng(seed))


def _port(kind, **cfg_kw):
    """The port's module of ``kind`` on the JAX params of ``_jax_params``."""
    if kind == "rag":
        module = RAG(RAGConfig.ted(**{**KW, **cfg_kw}))
    elif kind == "sag":
        module = SAG(**SAG_KW)
    else:
        module = CLIPTextEncoder(CLIPTextConfig(**CLIP))
    module.load_state_dict(jax_params_to_state_dict(_jax_params(kind, **cfg_kw)[2]))
    return module.eval()


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b.detach()), rtol=rtol,
                               atol=atol, err_msg=msg)


# --- the mesh and the rules -----------------------------------------------------

def test_mesh_shapes_and_model_groups():
    """JAX ``test_mesh_shapes``: data 4 x model 2 of eight devices, data 8
    x model 1; a row's shard lives on its group's first device."""
    mesh = parallel.create_mesh(devices=[f"cpu:{i}" for i in range(8)], model_parallel=2)
    assert mesh.shape == {parallel.DATA_AXIS: 4, parallel.MODEL_AXIS: 2}
    assert mesh.size == 4
    assert mesh.model_group(1) == (torch.device("cpu", 2), torch.device("cpu", 3))
    assert mesh.devices == tuple(torch.device("cpu", i) for i in (0, 2, 4, 6))
    assert parallel.create_mesh(devices=CPU8).shape == {parallel.DATA_AXIS: 8,
                                                        parallel.MODEL_AXIS: 1}
    with pytest.raises(ValueError, match="6 devices do not divide into model groups of "
                                         "model_parallel=4"):
        parallel.create_mesh(devices=["cpu"] * 6, model_parallel=4)
    pmesh = parallel.create_pipeline_mesh(devices=CPU8, pipeline_parallel=2, model_parallel=2)
    assert pmesh.shape == {"data": 2, "stage": 2, "model": 2}
    assert len(pmesh.stage_groups[1][0]) == 2 and pmesh.size == 2


@pytest.mark.parametrize("kind,cfg_kw", [("rag", {}), ("rag", {"speaker_dim": 27}),
                                         ("sag", {}), ("clip", {})],
                         ids=["rag", "rag-speaker-27", "sag", "clip"])
def test_param_shardings_match_jax_leaf_for_leaf(kind, cfg_kw):
    """On data 2 x model 2, the port's spec of every parameter is JAX's
    ``param_shardings`` of its Flax leaf carried through the converter. A
    speaker table of width 27 is not divisible by 2: the divisibility rule
    replicates the whole leaf on both sides. ``shard_params`` holds each
    split leaf as two slices and the rest whole."""
    _, shapes, _ = _jax_params(kind, **cfg_kw)
    jspecs = jparam_shardings(shapes, jcreate_mesh(n_devices=4, model_parallel=2))
    expect = _torch_terms({path: (leaf.ndim, _padded(s.spec, leaf.ndim)) for (path, leaf), s
                           in zip(_flax_items(shapes), jax.tree_util.tree_leaves(jspecs))})
    model = _port(kind, **cfg_kw)
    got = parallel.param_shardings(model, _mesh())
    assert got == expect
    split = {k for k, s in got.items() if parallel.MODEL_AXIS in s}
    assert len(split) >= 4
    if cfg_kw:
        assert got["speaker_embedding.weight"] == (None, None)
        assert parallel.param_spec(model, "speaker_embedding.weight") == (None, "model")
    replica = parallel.shard_params(model, _mesh())[1]
    layout = tp_layout(replica)
    assert {name for name, dim, *_ in layout.values() if dim is not None} == split
    whole = merge_values(dict(replica.named_parameters()), layout, torch.device("cpu"))
    assert all(torch.equal(whole[k], p) for k, p in model.named_parameters())


# --- the products and the replicas ----------------------------------------------

def test_column_row_and_embedding_products_match_one_device():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(3, 5, 16)), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.normal(size=(12, 16)), dtype=torch.float32, requires_grad=True)
    b = torch.tensor(rng.normal(size=(12,)), dtype=torch.float32, requires_grad=True)
    table = torch.tensor(rng.normal(size=(7, 12)), dtype=torch.float32, requires_grad=True)
    ids = torch.tensor([[0, 6, 3], [3, 3, 1]])
    devs = [torch.device("cpu")] * 2
    for dim, ref_w in ((0, w), (1, w.T.contiguous())):
        tw = TPWeight(ref_w, dim, devs)
        x_in = x if dim == 0 else x[..., :12]
        bias = b if dim == 0 else torch.zeros(16)
        ref = F.linear(x_in, ref_w, bias)
        out = tw.linear(x_in, bias)
        _close(out, ref)
        gx, *gw = torch.autograd.grad((out ** 2).sum(), [x, *tw.parameters()])
        rx, rw = torch.autograd.grad((ref ** 2).sum(), [x, ref_w])
        _close(gx, rx)
        _close(torch.cat(gw, dim), rw)
    te = TPWeight(table, 1, devs)
    _close(te.lookup(ids), F.embedding(ids, table))
    g = torch.autograd.grad(te.lookup(ids).pow(2).sum(), list(te.parameters()))
    _close(torch.cat(g, 1), torch.autograd.grad(F.embedding(ids, table).pow(2).sum(), table)[0])


def _grads(module, out, probe):
    """The gradients of sum(out * probe) (a vector-Jacobian product) by the
    model's parameter names (a replica's slices concatenated)."""
    params = dict(module.named_parameters())
    grads = torch.autograd.grad((out * probe).sum(), list(params.values()), allow_unused=True)
    parts = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return merge_values(parts, tp_layout(module), torch.device("cpu"))


@pytest.mark.parametrize("kind", ["rag", "sag", "clip"])
def test_a_tp_replica_computes_the_modules_forward_and_gradients(kind):
    """A TP replica (data row 1 of data 2 x model 2) against the whole
    module: the RAG forward with injected style draws, the SAG decode, the
    CLIP text features; the gradients of every parameter."""
    rng = np.random.default_rng(4)
    model = _port(kind)
    replica = parallel.shard_params(model, _mesh())[1]
    assert any(isinstance(m, TPWeight) for m in replica.modules())
    if kind == "rag":
        batch, draws = _batch(rng, 4)
        cond = {"audio": torch.from_numpy(batch["audio"]), "vid": torch.from_numpy(batch["vid"]),
                "origin_x": torch.from_numpy(batch["motion"]),
                "style_eps": torch.from_numpy(draws["style_eps"])}
        x, t = torch.from_numpy(draws["noise"]), torch.from_numpy(draws["t"])
        run = lambda m: m(x, t, cond)["output"]
    elif kind == "sag":
        z = torch.tensor(rng.normal(size=(4, SAG_KW["latent_dim"])), dtype=torch.float32)
        seed = torch.tensor(rng.normal(size=(4, 9, 3, 34)), dtype=torch.float32)
        run = lambda m: m.decode(z, seed)
    else:
        tokens = torch.tensor(rng.integers(0, CLIP["vocab_size"], size=(4, 77)))
        run = lambda m: m(tokens)
    ref, out = run(model), run(replica)
    _close(out, ref)
    probe = torch.tensor(rng.normal(size=ref.shape), dtype=torch.float32)
    g_ref, g_tp = _grads(model, ref, probe), _grads(replica, out, probe)
    largest = max(float(g.abs().max()) for g in g_ref.values())
    for k, g in g_ref.items():
        if k in ZERO_GRAD:  # 0 in exact arithmetic: both are rounding noise
            assert float(g_tp[k].abs().max()) <= 1e-4 * largest, k
        else:  # atol 1e-6 of the leaf's largest gradient
            _close(g_tp[k], g, atol=ATOL * float(g.abs().max()), msg=k)


# --- sampling ------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tp_sample():
    """JAX RAGSampler on data 2 x model 2 (GSPMD under the rules'
    shardings), DDIM-5 at eta 0, and the initial noise its key draws."""
    module, _, params = _jax_params("rag")
    rng = np.random.default_rng(40)
    batch, draws = _batch(rng)
    cond = {"audio": batch["audio"], "vid": batch["vid"], "origin_x": batch["motion"],
            "style_eps": draws["style_eps"]}
    key = jax.random.PRNGKey(11)
    sampler = JRAGSampler(module, jax.tree_util.tree_map(jnp.asarray, params), steps=50,
                          timestep_respacing="ddim5", method="ddim",
                          mesh=jcreate_mesh(n_devices=4, model_parallel=2))
    out = np.asarray(sampler({k: jnp.asarray(v) for k, v in cond.items()}, key, guidance=1.5))
    noise = np.array(jax.random.normal(jax.random.split(key)[1], out.shape, jnp.float32))
    return cond, noise, out


def test_sampler_on_data_by_model_matches_one_device_and_jax():
    cond, noise, ref = _jax_tp_sample()
    tcond = {k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()}
    kw = dict(steps=50, timestep_respacing="ddim5", method="ddim")
    sampler = RAGSampler(_port("rag"), mesh=_mesh(), **kw)
    assert len(sampler.replicas) == 2 and sampler.replicas[0] is not sampler.model
    tp = sampler(tcond, torch.Generator().manual_seed(0), guidance=1.5,
                 noise=torch.from_numpy(noise))
    single = RAGSampler(_port("rag"), device="cpu", **kw)(tcond, None, guidance=1.5,
                                                         noise=torch.from_numpy(noise))
    assert tp.shape == ref.shape and torch.isfinite(tp).all()
    np.testing.assert_allclose(tp.numpy(), single.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), ref, rtol=1e-4, atol=1e-4)
    # a hot swap re-slices every replica from the whole model
    new = {k: v + 0.01 for k, v in sampler.model.state_dict().items()}
    sampler.update_params(new)
    for r in sampler.replicas:
        whole = parallel.mesh.whole_state_dict(r)
        assert all(torch.equal(whole[k], v) for k, v in new.items())


# --- training --------------------------------------------------------------------------

def _state(model, tx, cfg):
    return init_train_state(dict(model.named_parameters()), tx, cfg=cfg)


def test_dp_by_tp_step_matches_the_single_device_step():
    """One replicated step on data 2 x model 2 (each row trains its TP
    replica) with injected draws against the single-device step on the
    global batch; the rows' states hold the same slices."""
    batch, draws = _batch(np.random.default_rng(30))
    cfg = TrainConfig(lr=LR, weight_decay=WD, ema_rate=0.9)
    out = []
    for mesh in (None, _mesh()):
        model = _port("rag").train()
        tx = AdamW(LR, weight_decay=WD, eps=1e-3)
        sched = DiffusionSchedule.create(steps=20)
        step = (make_train_step(model, sched, tx, cfg) if mesh is None
                else parallel.shard_train_step(model, sched, tx, cfg, mesh))
        state, m = step(_state(model, tx, cfg), batch, None, **draws)
        out.append((m, state if mesh is None else step.gathered_state(), step))
    (m1, s1, _), (m2, s2, step) = out
    np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-5)
    assert m2["t"].tolist() == draws["t"].tolist()
    for k, v in s1.params.items():
        _close(s2.params[k], v, rtol=0, msg=k)
        _close(s2.ema_params[k], s1.ema_params[k], rtol=0, msg=k)
    r0, r1 = step.states()
    assert list(r0.params) == [k for k, _ in step.replicas[0].named_parameters()]
    assert any(k.endswith(".weight.1") for k in r0.params)
    for k, v in r0.params.items():
        assert torch.equal(v, r1.params[k]) and torch.equal(r0.opt_state.mu[k],
                                                            r1.opt_state.mu[k]), k


def test_trainloop_on_data_by_model_checkpoints_whole_and_resumes_bit_exact(tmp_path):
    """TrainLoop(mesh=data 2 x model 2): 2 epochs of 2 global batches
    straight through, against 1 epoch and a resume to 2 from the one
    checkpoint, which holds the whole params under the model's names."""
    rng = np.random.default_rng(31)
    batches = [_batch(rng)[0] for _ in range(2)]
    init = {k: v.clone() for k, v in _port("rag").state_dict().items()}

    def loop(save_dir, epochs, resume=False):
        return TrainLoop(RAG(RAGConfig.ted(**KW)), DiffusionSchedule.create(steps=20), init,
                         batches, cfg=TrainConfig(lr=LR, ema_rate=0.9), save_dir=save_dir,
                         num_epochs=epochs, log_interval=1, save_after_epoch=-1,
                         save_every_epochs=1, seed=7, mesh=_mesh(), resume=resume)

    straight = loop(str(tmp_path / "full"), 2)
    straight.run_loop()
    full = straight.step_fn.gathered_state()
    loop(str(tmp_path / "split"), 1).run_loop()
    resumed_loop = loop(str(tmp_path / "split"), 2, resume=True)
    assert resumed_loop.start_step == 2
    resumed_loop.run_loop()
    resumed = resumed_loop.step_fn.gathered_state()
    assert resumed.step == 4 and any(k.endswith(".weight.1") for k in resumed_loop.state.params)
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k
        assert torch.equal(resumed.opt_state.mu[k], full.opt_state.mu[k]), k
    saved = torch.load(str(tmp_path / "split" / "ckpt_000000004.pt"), weights_only=True)
    assert {k: v.shape for k, v in saved["params"].items()} == \
        {k: v.shape for k, v in full.params.items()}


@functools.lru_cache(maxsize=None)
def _jax_fsdp_tp_step():
    """The JAX FSDP placement on data 2 x model 2 (min_size 1; the rules
    first, then the data axis), one jitted step with the injected draws
    through optax.adamw, the state pinned (``test_sharded_training.py:161``'s
    pattern)."""
    module, _, params = _jax_params("rag")
    rng = np.random.default_rng(80)
    batch, draws = _batch(rng)
    key = jax.random.PRNGKey(0)
    jsched = JSchedule.create(steps=20)
    tx = optax.adamw(LR, eps=1e-3, weight_decay=WD)
    mesh = jcreate_mesh(n_devices=4, model_parallel=2)

    def step(st, data, _):
        p, opt = st

        def loss_fn(p):
            cond = {"audio": data["audio"], "vid": data["vid"], "origin_x": data["motion"],
                    "style_eps": data["style_eps"], "cond_drop": data["cond_drop"]}
            fn = lambda x_t, tm: module.apply({"params": p}, x_t, tm, cond, train=True)
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
    return batch, draws, float(loss), jax_params_to_state_dict(jax.device_get(new))


def test_fsdp_step_on_data_by_model_matches_jax_and_holds_each_devices_slice():
    batch, draws, jloss, jnew = _jax_fsdp_tp_step()
    model = _port("rag").train()
    tx = AdamW(LR, weight_decay=WD, eps=1e-3)
    cfg = TrainConfig(lr=LR, weight_decay=WD, kld_weight=0.01, ema_rate=0.9)
    step = parallel.fsdp_train_step(model, DiffusionSchedule.create(steps=20), tx, cfg, _mesh(),
                                    min_size=1)
    state, m = step(_state(model, tx, cfg), batch, None, **draws)
    np.testing.assert_allclose(m["loss"], jloss, rtol=1e-5)
    full = step.gathered_state()
    assert list(full.params) == [k for k, _ in model.named_parameters()]
    for k, v in full.params.items():
        atol = LR if k in ZERO_GRAD else ATOL  # one step: steps x lr
        _close(v, jnew[k], rtol=0, atol=atol, msg=k)

    # each device holds its slice of every leaf sharded on either axis
    shards = step.shards
    specs = parallel.fsdp_param_shardings(model, _mesh(), min_size=1)
    both = [k for k, s in specs.items() if parallel.DATA_AXIS in s and parallel.MODEL_AXIS in s]
    assert both
    for s in step.states():
        for rname, (name, mdim, _, k) in shards.layout.items():
            shape = list(full.params[name].shape)
            if mdim is not None:
                shape[mdim] //= k
            if rname in shards.dims:
                shape[shards.dims[rname]] //= 2
            for tree in (s.params, s.opt_state.mu, s.opt_state.nu, s.ema_params):
                assert list(tree[rname].shape) == shape, rname
    for r in step.replicas:  # the gathered weights are freed after the step
        assert all(p.numel() == 0 for k, p in r.named_parameters() if k in shards.dims)


@pytest.mark.parametrize("what", ["sampler", "shard_train_step", "fsdp_train_step"])
def test_the_fused_kernels_refuse_a_model_axis_with_the_jax_words(what):
    if what == "sampler":
        message = "shard_map sampling mode is data-parallel only; got model axis of size 2"
        call = lambda: RAGSampler(_port("rag"), mesh=_mesh(), use_fused=True)
    else:
        message = ("shard_map training is data-parallel only; got model axis of size 2 (the "
                   "fused kernel is a single-chip design — a TP axis would silently replicate "
                   "work)")
        model = RAG(RAGConfig.ted(**KW, fused_train_backbone=True))
        make = getattr(parallel, what)
        call = lambda: make(model, DiffusionSchedule.create(steps=20), AdamW(LR), TrainConfig(),
                            _mesh())
    with pytest.raises(ValueError) as e:
        call()
    assert str(e.value) == message


# --- pipeline stages with tensor-parallel channel mixes -----------------------------

@functools.lru_cache(maxsize=None)
def _jax_tp_pipeline():
    x, t, params = _stack_inputs()
    from livelyspeaker_tpu.models.mlp_backbone import TimestepEmbedder as JTimestepEmbedder
    from test_torch_pipeline_parallel import D, L

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    emb = JTimestepEmbedder(D).apply({"params": jp["embed_timestep"]}, jnp.asarray(t))
    mesh = jcreate_pipeline_mesh(n_devices=8, pipeline_parallel=2, model_parallel=2)
    fn = functools.partial(jpipeline_forward, mesh=mesh, num_microbatches=2)
    return np.asarray(jax.jit(fn)(jstack_block_params(jp, L), jnp.asarray(x), emb))


def test_pipeline_with_tp_stages_matches_jax_and_the_sequential_gradients():
    backbone, x, t, emb, stacked = _port_stack()
    mesh = parallel.create_pipeline_mesh(devices=CPU8, pipeline_parallel=2, model_parallel=2)
    spec = parallel.pipeline_spec(stacked, tensor_parallel=True)
    assert spec["ch_w"] == ("stage", "model", None) and spec["ch_b"] == ("stage", "model")
    with torch.no_grad():
        out = parallel.pipeline_forward(stacked, x, emb, mesh, num_microbatches=2)
        seq = backbone(x, t)
    np.testing.assert_allclose(out.numpy(), _jax_tp_pipeline(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=0, atol=1e-5)

    params = [p for k, p in backbone.named_parameters() if k.startswith("block_")]
    emb = emb.detach()

    def piped():
        st = parallel.stack_block_params(dict(backbone.named_parameters()), len(backbone.blocks()))
        return parallel.pipeline_forward(st, x, emb, mesh, num_microbatches=2)

    def sequential():
        h = x
        for blk in backbone.blocks():
            h = blk(h, emb)
        return h

    g_pp = torch.autograd.grad((piped() ** 2).sum(), params)
    g_seq = torch.autograd.grad((sequential() ** 2).sum(), params)
    for g, r in zip(g_pp, g_seq):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-3, atol=2e-4)
