"""Parity of the port's training slice with the JAX package: the train step
(loss, gradients and the AdamW update), the optimizer schedule and clip, the
NaN guard, EMA, the loss-aware sampler, bf16 compute, TrainLoop resume, the
npz export read back by the JAX package, and the logger.

Small widths (latent 32-64, 1-2 blocks); the same seeded numpy inputs and
randomised weights go through both sides.
"""

import functools
import glob
import json

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
from livelyspeaker_tpu.models import WavEncoder as JWavEncoder
from livelyspeaker_tpu.training import checkpoints as jckpt
from livelyspeaker_tpu.training import logging as jlog
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import RAG, RAGConfig, WavEncoder, audio_samples_for_frames
from livelyspeaker_tpu_torch.training import (
    TrainConfig,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from livelyspeaker_tpu_torch.training import checkpoints as tckpt
from livelyspeaker_tpu_torch.training import logging as tlog
from livelyspeaker_tpu_torch.training.loop import TrainLoop
from livelyspeaker_tpu_torch.training.trainer import AdamW
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    random_normal_params,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B = 4
N_AUDIO = audio_samples_for_frames(34)
KW = dict(latent_dim=32, num_layers=1, n_speakers=6)
# conv biases followed by InstanceNorm: gradient 0 in exact arithmetic
ZERO_GRAD = tuple(f"audio_encoder.conv{i}.bias" for i in range(3))


def _batch(rng, cfg, b=B):
    batch = {
        "motion": (0.3 * rng.normal(size=(b, cfg.njoints, cfg.nfeats, 34))).astype(np.float32),
        "audio": (0.1 * rng.normal(size=(b, N_AUDIO))).astype(np.float32),
        "vid": rng.integers(0, cfg.n_speakers, size=(b,)),
    }
    if cfg.num_emotions:
        batch["emo"] = rng.integers(0, cfg.num_emotions, size=(b,))
    return batch


@functools.lru_cache(maxsize=None)
def _jax_params(variant="ted", seed=0):
    """Randomised JAX params of the small RAG (built once per process)."""
    jcfg = (JRAGConfig.beat if variant == "beat" else JRAGConfig.ted)(**KW)
    rng = np.random.default_rng(seed)
    b = _batch(rng, jcfg, 2)
    cond = {"audio": jnp.asarray(b["audio"]), "vid": jnp.asarray(b["vid"]),
            "origin_x": jnp.asarray(b["motion"])}
    if jcfg.num_emotions:
        cond["emo"] = jnp.asarray(b["emo"])
    params = JRAG(jcfg).init({"params": jax.random.PRNGKey(seed), "style": jax.random.PRNGKey(1)},
                             jnp.asarray(b["motion"]), jnp.zeros((2,), jnp.int32), cond)["params"]
    return random_normal_params(jax.device_get(params), rng)


def _port_model(variant="ted", **cfg_kw):
    tcfg = (RAGConfig.beat if variant == "beat" else RAGConfig.ted)(**KW, **cfg_kw)
    tm = RAG(tcfg)
    tm.load_state_dict(jax_params_to_state_dict(_jax_params(variant)))
    return tm


def _own_init_model(**cfg_kw):
    return RAG(RAGConfig.ted(**KW, **cfg_kw), generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("variant,kld_weight", [("ted", 0.01), ("beat", 0.0)])
def test_train_step_matches_jax_loss_and_adamw(variant, kld_weight):
    """One step with explicit t, noise, style and condition drop: the loss
    and its terms (rtol 1e-5), and the params after optax.adamw's update
    (atol 1e-6). Both optimizers take eps 1e-3: Adam's first step is
    g / (|g| + eps), which at the default eps of 1e-8 turns the round-off
    of a near-zero gradient into a step of up to lr; test_adamw_matches_optax
    holds the default eps."""
    params = _jax_params(variant)
    jcfg = (JRAGConfig.beat if variant == "beat" else JRAGConfig.ted)(**KW)
    rng = np.random.default_rng(10)
    batch = _batch(rng, jcfg)
    t = rng.integers(0, 20, size=(B,))
    noise = rng.normal(size=batch["motion"].shape).astype(np.float32)
    style = rng.normal(size=(B, 1, jcfg.latent_dim)).astype(np.float32)
    drop = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    lr, wd = 1e-3, 1e-2

    cond = {"audio": batch["audio"], "vid": batch["vid"], "origin_x": batch["motion"],
            "style_eps": style, "cond_drop": drop}
    if "emo" in batch:
        cond["emo"] = batch["emo"]
    cond = {k: jnp.asarray(v) for k, v in cond.items()}
    jm, jsched = JRAG(jcfg), JSchedule.create(steps=20)

    def jloss(p):
        fn = lambda x_t, tm: jm.apply({"params": p}, x_t, tm, cond, train=True)
        terms = jl.training_losses(fn, jsched, jnp.asarray(batch["motion"]), jnp.asarray(t),
                                   jax.random.PRNGKey(0), noise=jnp.asarray(noise))
        return jnp.mean(terms["loss_per_sample"]) + kld_weight * terms["kld"], terms

    (loss, terms), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tx = optax.adamw(lr, eps=1e-3, weight_decay=wd)
    new = optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])

    tm = _port_model(variant)
    cfg = TrainConfig(lr=lr, weight_decay=wd, kld_weight=kld_weight)
    ttx = AdamW(lr, weight_decay=wd, eps=1e-3)
    state = init_train_state(dict(tm.named_parameters()), ttx, cfg=cfg)
    step = make_train_step(tm, DiffusionSchedule.create(steps=20), ttx, cfg)
    state, m = step(state, batch, None, t=t, noise=noise, style_eps=style, cond_drop=drop)
    np.testing.assert_allclose(m["loss"], float(loss), rtol=1e-5)
    for k in ("rot_mse", "vel_mse", "kld"):
        np.testing.assert_allclose(m[k], float(terms[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(m["loss_per_sample"].numpy(), np.asarray(terms["loss_per_sample"]),
                               rtol=1e-5)
    assert state.step == 1 and state.opt_state.count == 1 and m["skipped_nonfinite"] == 0.0
    ref = jax_params_to_state_dict(jax.device_get(new))
    for k, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.05),
    dict(lr_anneal_steps=10),  # the lr reaches 0 after 10 updates
    dict(grad_clip=0.5),       # clipped: the grads' norm is about 1.7
    dict(grad_clip=5.0),       # not clipped
])
def test_adamw_matches_optax(kw):
    """The same gradients through the port's AdamW and the JAX package's
    optax chain (make_optimizer) for 13 updates."""
    from livelyspeaker_tpu.training.trainer import TrainConfig as JTrainConfig
    from livelyspeaker_tpu.training.trainer import make_optimizer as jmake

    rng = np.random.default_rng(11)
    p0 = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    jtx = jmake(JTrainConfig(lr=1e-2, **kw))
    ttx = make_optimizer(TrainConfig(lr=1e-2, **kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(13):
        g = {k: (0.5 * rng.normal(size=v.shape)).astype(np.float32) for k, v in p0.items()}
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
    if kw.get("lr_anneal_steps"):
        assert ttx.learning_rate(ts.count) == 0.0 and all(
            float(v.abs().max()) == 0.0 for v in tu.values())


def test_loss_decreases():
    tm = _own_init_model()
    cfg = TrainConfig(lr=1e-3)
    tx = make_optimizer(cfg)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
    step = make_train_step(tm, DiffusionSchedule.create(steps=20), tx, cfg)
    batch = _batch(np.random.default_rng(12), tm.cfg)
    losses = []
    for i in range(12):
        state, m = step(state, batch, torch.Generator().manual_seed(i))
        losses.append(m["loss"])
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_nan_batch_skips_update_and_recovers():
    """A non-finite gradient leaves params, both moments, the update count
    and the sampler history alone; the step count and the EMA still move."""
    tm = _own_init_model()
    cfg = TrainConfig(lr=1e-3, schedule_sampler="loss-second-moment", ema_rate=0.5)
    tx = make_optimizer(cfg)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg, num_timesteps=20)
    step = make_train_step(tm, DiffusionSchedule.create(steps=20), tx, cfg)
    batch = _batch(np.random.default_rng(13), tm.cfg)
    state, _ = step(state, batch, torch.Generator().manual_seed(0))
    snap = lambda d: {k: v.detach().clone() for k, v in d.items()}
    p0, mu0, nu0 = snap(state.params), snap(state.opt_state.mu), snap(state.opt_state.nu)
    e0, h0 = snap(state.ema_params), state.sampler_state.history.clone()

    bad = dict(batch, motion=batch["motion"].copy())
    bad["motion"][0, 0, 0, 0] = np.nan
    state, m = step(state, bad, torch.Generator().manual_seed(1))
    assert m["skipped_nonfinite"] == 1.0 and state.step == 2 and state.opt_state.count == 1
    for d0, d1 in ((p0, state.params), (mu0, state.opt_state.mu), (nu0, state.opt_state.nu)):
        assert all(torch.equal(d0[k], d1[k]) for k in d0)
    assert torch.equal(state.sampler_state.history, h0)
    for k in e0:  # ema = 0.5 ema + 0.5 p, on the unchanged params
        torch.testing.assert_close(state.ema_params[k], 0.5 * e0[k] + 0.5 * p0[k])

    state, m = step(state, batch, torch.Generator().manual_seed(2))
    assert m["skipped_nonfinite"] == 0.0 and np.isfinite(m["loss"])
    assert state.opt_state.count == 2
    assert any(not torch.equal(p0[k], state.params[k]) for k in p0)


@pytest.mark.parametrize("warmup", [False, True])
def test_ema(warmup):
    """Plain: after one step at rate 0.5, ema = (p0 + p1) / 2. Warm-up: the
    5th update (4 completed steps) uses decay min(0.999, 5/14)."""
    tm = _own_init_model()
    cfg = TrainConfig(lr=1e-3, ema_rate=0.999 if warmup else 0.5, ema_warmup=warmup)
    tx = make_optimizer(cfg)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
    step = make_train_step(tm, DiffusionSchedule.create(steps=20), tx, cfg)
    batch = _batch(np.random.default_rng(14), tm.cfg)
    n = 5 if warmup else 1
    d = 5.0 / 14.0 if warmup else 0.5
    for i in range(n):
        prev_ema = {k: v.clone() for k, v in state.ema_params.items()}
        state, _ = step(state, batch, torch.Generator().manual_seed(i))
    for k, e in state.ema_params.items():
        torch.testing.assert_close(e, d * prev_ema[k] + (1 - d) * state.params[k],
                                   rtol=1e-5, atol=1e-6)


def test_loss_aware_sampler_wired_into_train_step():
    tm = _own_init_model()
    cfg = TrainConfig(lr=1e-3, schedule_sampler="loss-second-moment")
    tx = make_optimizer(cfg)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg, num_timesteps=20)
    T, hpt = state.sampler_state.history.shape
    hist = np.where(np.arange(T)[:, None] < 10, 50.0, 1.0) * np.ones((T, hpt))
    state.sampler_state.history = torch.tensor(hist, dtype=torch.float32)
    state.sampler_state.counts = torch.full((T,), hpt, dtype=torch.int32)
    step = make_train_step(tm, DiffusionSchedule.create(steps=20), tx, cfg)
    batch = _batch(np.random.default_rng(15), tm.cfg, 64)
    state, m = step(state, batch, torch.Generator().manual_seed(3))
    assert (m["t"].numpy() < 10).mean() > 0.6
    assert not np.allclose(state.sampler_state.history.numpy(), hist)
    assert np.isfinite(m["loss"])
    with pytest.raises(NotImplementedError):
        make_train_step(tm, DiffusionSchedule.create(steps=20), tx, TrainConfig(schedule_sampler="x"))


def test_bf16_step_keeps_f32_masters_and_fused_backbone_refuses_it():
    tm = _own_init_model()
    cfg = TrainConfig(lr=1e-3, compute_dtype="bfloat16")
    tx = make_optimizer(cfg)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
    step = make_train_step(tm, DiffusionSchedule.create(steps=20), tx, cfg)
    batch = _batch(np.random.default_rng(16), tm.cfg)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    state, m = step(state, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0.0
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert any(not torch.equal(p0[k], state.params[k]) for k in p0)

    # the fused backbone is no longer refused under bf16: as in the JAX
    # package it runs its stack in f32 on the bf16 values (its parity with
    # the JAX kernel is in test_torch_measure.py); the masters stay f32
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2

    fused = _own_init_model(fused_train_backbone=True)
    step = make_train_step(fused, DiffusionSchedule.create(steps=20), tx, cfg)
    state = init_train_state(dict(fused.named_parameters()), tx, cfg=cfg)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    calls = (k2.fused_transmlp_train_forward_reference.calls,
             k2.fused_transmlp_train_backward_reference.calls)
    state, m = step(state, batch, torch.Generator().manual_seed(0))
    assert (k2.fused_transmlp_train_forward_reference.calls,
            k2.fused_transmlp_train_backward_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert np.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0.0
    assert all(p.dtype == torch.float32 for p in fused.parameters())
    assert any(not torch.equal(p0[k], state.params[k]) for k in p0)


def test_fused_backbone_train_step_matches_eager():
    """The same step through the fused training stack and the eager
    blocks: loss and updated params."""
    batch = _batch(np.random.default_rng(17), RAGConfig.ted(**KW))
    out = []
    for fused in (False, True):
        tm = _port_model(fused_train_backbone=fused)
        cfg = TrainConfig(lr=1e-3)
        tx = make_optimizer(cfg)
        state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
        step = make_train_step(tm, DiffusionSchedule.create(steps=20), tx, cfg)
        state, m = step(state, batch, torch.Generator().manual_seed(4))
        out.append((m["loss"], tm.state_dict()))
    (le, pe), (lf, pf) = out
    np.testing.assert_allclose(lf, le, rtol=1e-5)
    for k in pe:
        if k not in ZERO_GRAD:
            np.testing.assert_allclose(pf[k].numpy(), pe[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_train_forward_draws_drop_and_style_from_the_generator():
    """train=True draws the condition drop (u < cond_mask_prob) and then the
    style normals from the generator; the same draws passed explicitly give
    the same output."""
    tm = _port_model(cond_mask_prob=0.5)
    rng = np.random.default_rng(18)
    b = _batch(rng, tm.cfg)
    x = torch.from_numpy(b["motion"])
    t = torch.tensor([1, 5, 9, 13])
    cond = {"audio": torch.from_numpy(b["audio"]), "vid": torch.from_numpy(b["vid"]), "origin_x": x}
    out = tm(x, t, cond, train=True, generator=torch.Generator().manual_seed(5))["output"]
    g = torch.Generator().manual_seed(5)
    drop = (torch.rand((B,), generator=g) < 0.5).float()
    eps = torch.randn((B, 1, tm.cfg.latent_dim), generator=g)
    ref = tm(x, t, dict(cond, cond_drop=drop, style_eps=eps))["output"]
    torch.testing.assert_close(out, ref)


def _loop(model, batches, save_dir, epochs, **kw):
    return TrainLoop(model, DiffusionSchedule.create(steps=20), kw.pop("params", None), batches,
                     cfg=kw.pop("cfg", TrainConfig(lr=1e-3)), save_dir=save_dir,
                     num_epochs=epochs, log_interval=kw.pop("log_interval", 1000),
                     save_after_epoch=-1, save_every_epochs=1, seed=7, device="cpu", **kw)


def test_resume_is_bit_exact(tmp_path):
    """4 epochs of 2 batches straight through, against 2 epochs and a resume
    to 4: the same params and moments, bit for bit, on the CPU."""
    tm = _own_init_model()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    rng = np.random.default_rng(19)
    batches = [_batch(rng, tm.cfg) for _ in range(2)]
    full = _loop(tm, batches, str(tmp_path / "full"), 4, params=init).run_loop()
    full_params = {k: v.clone() for k, v in full.params.items()}
    _loop(tm, batches, str(tmp_path / "split"), 2, params=init).run_loop()
    resumed_loop = _loop(tm, batches, str(tmp_path / "split"), 4, params=init, resume=True)
    assert resumed_loop.start_step == 4
    resumed = resumed_loop.run_loop()
    assert resumed.step == full.step == 8 and resumed.opt_state.count == 8
    for k, v in full_params.items():
        assert torch.equal(resumed.params[k], v), k
    assert all(torch.equal(resumed.opt_state.mu[k], full.opt_state.mu[k]) for k in full_params)


def test_anneal_stops_the_loop(tmp_path):
    tm = _own_init_model()
    batches = [_batch(np.random.default_rng(20), tm.cfg)] * 5
    state = _loop(tm, batches, None, 3, cfg=TrainConfig(lr=1e-3, lr_anneal_steps=3)).run_loop()
    assert state.step == 3


def test_trainloop_exports_npz_that_the_jax_package_reads(tmp_path):
    """TrainLoop writes model*.npz and model_ema*.npz in the JAX tree's flat
    layout and logs the loss quartiles; the JAX RAG on the exported params
    gives the port's output."""
    tm = _port_model()
    rng = np.random.default_rng(21)
    batches = [_batch(rng, tm.cfg)] * 2
    run = tmp_path / "run"
    _loop(tm, batches, str(run), 1, cfg=TrainConfig(lr=1e-3, ema_rate=0.99),
          log_interval=1, args_to_save={"lr": 1e-3}).run_loop()
    assert glob.glob(str(run / "model_ema*.npz"))
    with open(run / "progress.jsonl") as f:
        keys = set().union(*[json.loads(line).keys() for line in f if line.strip()])
    assert any(k.startswith("loss_q") for k in keys), keys
    assert tckpt.load_args(str(run)) == jckpt.load_args(str(run)) == {"lr": 0.001}

    (npz,) = glob.glob(str(run / "model0*.npz"))
    tree = jckpt.load_params_npz(npz)
    ref_tree = _jax_params("ted")
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref_tree)
    assert all(a.shape == b.shape for a, b in
               zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref_tree)))
    b = _batch(rng, tm.cfg)
    t = np.array([0, 3, 7, 19])
    style = rng.normal(size=(B, 1, tm.cfg.latent_dim)).astype(np.float32)
    drop = np.zeros((B,), np.float32)
    cond = {"audio": b["audio"], "vid": b["vid"], "origin_x": b["motion"], "style_eps": style,
            "cond_drop": drop}
    ref = JRAG(JRAGConfig.ted(**KW)).apply(
        {"params": tree}, jnp.asarray(b["motion"]), jnp.asarray(t),
        {k: jnp.asarray(v) for k, v in cond.items()})["output"]
    with torch.no_grad():
        out = tm(torch.from_numpy(b["motion"]), torch.from_numpy(t),
                 {k: torch.from_numpy(v) for k, v in cond.items()})["output"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    tm = _own_init_model()
    cfg = TrainConfig(ema_rate=0.9)
    tx = make_optimizer(cfg)
    state = init_train_state(dict(tm.named_parameters()), tx, cfg=cfg)
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.restore(state) == (None, 0)
    for s in (1, 2, 3):
        state.step = s
        mgr.save(s, state)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    restored, step = mgr.restore(state, step=2)
    assert step == 2 and restored.step == 2 and set(restored.ema_params) == set(state.params)


def test_kv_logger_matches_jax(tmp_path):
    rng = np.random.default_rng(22)
    t = rng.integers(0, 100, size=(16,))
    losses = rng.random(16)
    outs = []
    for mod, d in ((jlog, tmp_path / "j"), (tlog, tmp_path / "t")):
        lg = mod.KVLogger(str(d), formats=("json", "csv"))
        lg.logkv_mean("loss", 1.0)
        lg.logkv_mean("loss", 2.0)
        lg.logkv("step", 3)
        mod.log_loss_quartiles(lg, t, {"loss": losses}, 100)
        first = lg.dumpkvs()
        lg.logkv("extra", 1.5)
        second = lg.dumpkvs()
        lg.close()
        outs.append((first, second, (d / "progress.csv").read_text(),
                     (d / "progress.jsonl").read_text()))
    assert outs[0] == outs[1]
    assert isinstance(tlog.NoPlatform(str(tmp_path)), tlog.TrainPlatform)


def test_wav_encoder_bf16_matches_jax():
    """dtype=bf16: bf16 conv activations, f32 InstanceNorm statistics, f32
    features; against the JAX encoder at bf16 (tolerance 2e-2 of max|ref|,
    bf16 keeps 8 bits), and the params and their gradients stay f32."""
    params = {"audio_encoder": _jax_params("ted")["audio_encoder"]}
    sd = {k.split(".", 1)[1]: v for k, v in jax_params_to_state_dict(params).items()}
    enc = WavEncoder(dtype=torch.bfloat16)
    enc.load_state_dict(sd)
    wav = (0.1 * np.random.default_rng(23).normal(size=(2, N_AUDIO))).astype(np.float32)
    ref = np.asarray(JWavEncoder(dtype=jnp.bfloat16).apply(
        {"params": params["audio_encoder"]}, jnp.asarray(wav)))
    out = enc(torch.from_numpy(wav))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    out.sum().backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in enc.parameters())
    assert RAG(RAGConfig.ted(**KW, audio_bf16=True)).audio_encoder.dtype == torch.bfloat16
