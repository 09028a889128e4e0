"""Parity of the port's sampler options with the JAX package: PLMS at orders
1-4, every mean type with clip_denoised and denoised_fn, inpainting in time,
classifier guidance (cond_fn), const_noise, trajectories and dumps, the
DDIM encoder, and the chain's dtype.

Both packages run the same analytic x0 denoiser on the same numpy inputs.
Only deterministic chains are held end to end (``noise=`` given, DDIM at
eta 0, PLMS, DPM-Solver++, the clean inpainting blend); the random routes
are held step by step with the noise injected. Tolerance: rel 1e-5 of
max|x|, as tests/test_torch_diffusion.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.diffusion import sampling as js
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu_torch.diffusion import sampling as ts
from livelyspeaker_tpu_torch.diffusion.schedule import DiffusionSchedule
from livelyspeaker_tpu_torch.models import RAG, RAGConfig, audio_samples_for_frames
from livelyspeaker_tpu_torch.models.cfg import make_cfg_denoiser
from livelyspeaker_tpu_torch.models.fast_rag import make_fused_cfg_denoiser
from livelyspeaker_tpu_torch.pipeline import RAGSampler

TOL = 1e-5
SHAPE = (2, 3, 2, 8)
_rng = np.random.default_rng(0)
W = (0.5 + _rng.random(SHAPE[1:])).astype(np.float32)
V = _rng.normal(size=SHAPE[1:]).astype(np.float32)
TARGET = _rng.normal(size=SHAPE).astype(np.float32)
NOISE = _rng.normal(size=SHAPE).astype(np.float32)
MOTION = _rng.normal(size=SHAPE).astype(np.float32)
MASK = np.zeros(SHAPE, bool)
MASK[..., :3] = True  # the first three frames held


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _scheds(respacing="ddim10", schedule="cosine"):
    return (JSchedule.create(steps=1000, schedule=schedule, timestep_respacing=respacing),
            DiffusionSchedule.create(steps=1000, schedule=schedule,
                                     timestep_respacing=respacing))


def _jden(x, t, rng):
    return jnp.tanh(0.7 * x * W + (t[:, None, None, None] / 1000.0) * V)


def _tden(calls=None):
    w, v = torch.from_numpy(W), torch.from_numpy(V)

    def den(x, t, generator=None):
        if calls is not None:
            calls.append(int(t[0]))
        return torch.tanh(0.7 * x * w + (t[:, None, None, None] / 1000.0) * v)

    return den


def _jcond_fn(x, t):  # grad of -0.15 |x - target|^2
    return -0.3 * (x - TARGET)


def _tcond_fn(x, t):  # the same gradient, through autograd
    return torch.autograd.grad((-0.15 * (x - torch.from_numpy(TARGET)) ** 2).sum(), x)[0]


def _jchain(jsched, **kw):
    return js.sample_loop(_jden, jsched, SHAPE, jax.random.PRNGKey(0),
                          noise=jnp.asarray(NOISE), **kw)


def _tchain(tsched, den=None, **kw):
    return ts.sample_loop(den or _tden(), tsched, SHAPE, torch.Generator().manual_seed(0),
                          noise=torch.from_numpy(NOISE), **kw)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("skip", [0, 3])
def test_plms_chain_matches_jax(order, skip):
    """PLMS end to end; at order > 1 the first step calls the denoiser twice,
    the second time at the next step's timestep."""
    jsched, tsched = _scheds()
    init = MOTION if skip else None
    ref = _jchain(jsched, method="plms", order=order, skip_timesteps=skip,
                  init_image=None if init is None else jnp.asarray(init))
    calls = []
    out = _tchain(tsched, _tden(calls), method="plms", order=order, skip_timesteps=skip,
                  init_image=None if init is None else torch.from_numpy(init))
    assert rel(out.numpy(), ref) <= TOL
    n_steps = tsched.num_timesteps - skip
    assert len(calls) == n_steps + (order > 1)
    if order > 1:
        tm = tsched.timestep_map.tolist()
        assert calls[:2] == [tm[n_steps - 1], tm[n_steps - 2]]


@pytest.mark.parametrize("mean_type", list(ts.MeanType), ids=lambda m: m.value)
@pytest.mark.parametrize("clip_denoised", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("denoised", [False, True], ids=["", "denoised_fn"])
def test_p_mean_variance_mean_types_match_jax(mean_type, clip_denoised, denoised):
    jsched, tsched = _scheds("ddim20")
    rng = np.random.default_rng(1)
    x = rng.normal(size=SHAPE).astype(np.float32)
    pred = (2.0 * rng.normal(size=SHAPE)).astype(np.float32)
    t = np.array([3, 17])
    ref = js.p_mean_variance(jsched, jnp.asarray(pred), jnp.asarray(x), jnp.asarray(t),
                             mean_type=js.MeanType(mean_type.value), clip_denoised=clip_denoised,
                             denoised_fn=(lambda a: 0.8 * a + 0.1) if denoised else None)
    out = ts.p_mean_variance(tsched, torch.from_numpy(pred), torch.from_numpy(x),
                             torch.from_numpy(t), mean_type=mean_type,
                             clip_denoised=clip_denoised,
                             denoised_fn=(lambda a: 0.8 * a + 0.1) if denoised else None)
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        assert rel(out[k].numpy(), ref[k]) <= TOL, k


@pytest.mark.parametrize("mean_type", list(ts.MeanType), ids=lambda m: m.value)
def test_ddim_chain_mean_types_match_jax(mean_type):
    jsched, tsched = _scheds()
    ref = _jchain(jsched, method="ddim", mean_type=js.MeanType(mean_type.value),
                  clip_denoised=True, denoised_fn=lambda a: 0.9 * a)
    out = _tchain(tsched, method="ddim", mean_type=mean_type, clip_denoised=True,
                  denoised_fn=lambda a: 0.9 * a)
    assert rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("noised", [True, False], ids=["noised", "clean"])
@pytest.mark.parametrize("t0", [0, 6])
def test_apply_inpainting_matches_jax(noised, t0):
    """The blend of one step, the q-sample noise drawn by JAX and injected
    into the port; the noised blend is gated on t[0] > 0."""
    jsched, tsched = _scheds()
    pred = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    t = np.array([t0, 4])
    key = jax.random.PRNGKey(5)
    ref = js._apply_inpainting(jsched, jnp.asarray(pred), jnp.asarray(t),
                               js.Inpainting(jnp.asarray(MASK), jnp.asarray(MOTION), noised), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, SHAPE, jnp.float32)))
    out = ts._apply_inpainting(tsched, torch.from_numpy(pred), torch.from_numpy(t),
                               ts.Inpainting(torch.from_numpy(MASK), torch.from_numpy(MOTION),
                                             noised), noise if noised else None)
    assert rel(out.numpy(), ref) <= TOL
    np.testing.assert_array_equal(out.numpy()[~MASK], pred[~MASK])


@pytest.mark.parametrize("method", ["ddim", "plms", "dpmpp"])
def test_clean_inpainting_chain_matches_jax(method):
    """The BEAT blend (noised=False) end to end; the held frames of the
    final sample are the constraint exactly."""
    jsched, tsched = _scheds()
    ref = _jchain(jsched, method=method,
                  inpainting=js.Inpainting(jnp.asarray(MASK), jnp.asarray(MOTION), False))
    out = _tchain(tsched, method=method, inpainting=ts.Inpainting(
        torch.from_numpy(MASK), torch.from_numpy(MOTION), False)).numpy()
    assert rel(out, ref) <= TOL
    np.testing.assert_array_equal(out[MASK], MOTION[MASK])


def test_condition_mean_matches_jax():
    """The mean shift of one DDPM step, under torch.no_grad() as in the
    loop: the port's cond_fn differentiates with autograd."""
    jsched, tsched = _scheds()
    rng = np.random.default_rng(3)
    x, pred = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([5, 9])
    jout = js.p_mean_variance(jsched, jnp.asarray(pred), jnp.asarray(x), jnp.asarray(t))
    ref = js.condition_mean(jsched, _jcond_fn, jout, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        tout = ts.p_mean_variance(tsched, torch.from_numpy(pred), torch.from_numpy(x),
                                  torch.from_numpy(t))
        out = ts.condition_mean(tsched, _tcond_fn, tout, torch.from_numpy(x),
                                torch.from_numpy(t))
    assert not out.requires_grad
    assert rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("method", ["ddim", "plms", "dpmpp"])
def test_condition_score_chain_matches_jax(method):
    jsched, tsched = _scheds()
    ref = _jchain(jsched, method=method, cond_fn=_jcond_fn)
    out = _tchain(tsched, method=method, cond_fn=_tcond_fn)
    assert rel(out.numpy(), ref) <= TOL
    assert rel(out.numpy(), _jchain(jsched, method=method)) > 10 * TOL  # the guidance acts


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_const_noise_gives_every_row_the_first_rows_noise(method):
    """With a denoiser that treats rows alike, const_noise (the initial and
    every step's noise from row 0) makes every row of the chain the same,
    in both packages; without it the rows differ."""
    jsched, tsched = _scheds("10")
    kw = dict(method=method, eta=0.5)
    jout = np.asarray(js.sample_loop(_jden, jsched, SHAPE, jax.random.PRNGKey(1),
                                     const_noise=True, **kw))
    out = ts.sample_loop(_tden(), tsched, SHAPE, torch.Generator().manual_seed(1),
                         const_noise=True, **kw).numpy()
    for a in (jout, out):
        np.testing.assert_array_equal(a, np.broadcast_to(a[:1], a.shape))
    free = ts.sample_loop(_tden(), tsched, SHAPE, torch.Generator().manual_seed(1), **kw)
    assert not torch.equal(free[0], free[1])


def test_ddpm_step_with_const_noise_matches_jax():
    """One DDPM step of const_noise: the step noise's first row, broadcast."""
    jsched, tsched = _scheds("10")
    rng = np.random.default_rng(4)
    x, pred = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([7, 7])
    noise = np.broadcast_to(NOISE[:1], SHAPE)
    jout = js.p_mean_variance(jsched, jnp.asarray(pred), jnp.asarray(x), jnp.asarray(t))
    ref = js._ddpm_update(jsched, jout, jnp.asarray(x), jnp.asarray(t),
                          jnp.broadcast_to(jnp.asarray(NOISE)[:1], SHAPE))
    tout = ts.p_mean_variance(tsched, torch.from_numpy(pred), torch.from_numpy(x),
                              torch.from_numpy(t))
    out = ts._ddpm_update(tsched, tout, torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(np.ascontiguousarray(noise)))
    assert rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("method", ["ddpm", "ddim", "plms", "dpmpp"])
@pytest.mark.parametrize("field", ["pred_xstart", "sample"])
def test_trajectory_and_dump_match_jax(method, field):
    """return_trajectory and sample_loop_with_dump. DDPM is deterministic
    only over its last step (t = 0 adds no noise), so its chain is that one
    step from a q-sampled init_image."""
    jsched, tsched = _scheds()
    kw = {}
    if method == "ddpm":
        kw = dict(skip_timesteps=tsched.num_timesteps - 1)
    n_steps = tsched.num_timesteps - kw.get("skip_timesteps", 0)
    # the JAX dump of every step is its whole trajectory
    jfinal, jtraj = js.sample_loop_with_dump(
        _jden, jsched, SHAPE, jax.random.PRNGKey(0), dump_steps=range(n_steps),
        dump_field=field, method=method, noise=jnp.asarray(NOISE),
        init_image=jnp.asarray(MOTION), **kw)
    final, traj = _tchain(tsched, method=method, return_trajectory=field,
                          init_image=torch.from_numpy(MOTION), **kw)
    assert traj.shape == (n_steps,) + SHAPE
    assert rel(final.numpy(), jfinal) <= TOL
    assert rel(traj.numpy(), jtraj) <= TOL
    if field == "sample":
        torch.testing.assert_close(traj[-1], final, rtol=0, atol=0)
    steps = sorted({0, n_steps // 2, n_steps - 1})
    td = ts.sample_loop_with_dump(_tden(), tsched, SHAPE, torch.Generator().manual_seed(0),
                                  dump_steps=steps, dump_field=field, method=method,
                                  noise=torch.from_numpy(NOISE),
                                  init_image=torch.from_numpy(MOTION), **kw)
    torch.testing.assert_close(td[0], final, rtol=0, atol=0)
    assert td[1].shape == (len(steps),) + SHAPE
    assert rel(td[1].numpy(), np.asarray(jtraj)[steps]) <= TOL


def test_ddpm_trajectory_over_a_random_chain():
    """A multi-step DDPM chain: the trajectory has a row a step, its last
    sample is the final one, and the dump gathers its rows."""
    _, tsched = _scheds("10")
    final, traj = ts.sample_loop(_tden(), tsched, SHAPE, torch.Generator().manual_seed(2),
                                 method="ddpm", return_trajectory="sample")
    assert traj.shape == (10,) + SHAPE
    torch.testing.assert_close(traj[-1], final, rtol=0, atol=0)
    _, dumped = ts.sample_loop_with_dump(_tden(), tsched, SHAPE,
                                         torch.Generator().manual_seed(2), dump_steps=[1, 4],
                                         dump_field="sample", method="ddpm")
    torch.testing.assert_close(dumped, traj[[1, 4]], rtol=0, atol=0)


@pytest.mark.parametrize("mean_type,clip", [(ts.MeanType.START_X, False),
                                            (ts.MeanType.EPSILON, True)],
                         ids=["start_x", "epsilon_clip"])
def test_reverse_loop_and_step_match_jax(mean_type, clip):
    jsched, tsched = _scheds()
    jm = js.MeanType(mean_type.value)
    ref = js.reverse_loop(_jden, jsched, jnp.asarray(MOTION), jax.random.PRNGKey(0),
                          mean_type=jm, clip_denoised=clip)
    out = ts.reverse_loop(_tden(), tsched, torch.from_numpy(MOTION), mean_type=mean_type,
                          clip_denoised=clip)
    assert rel(out.numpy(), ref) <= TOL
    t = np.array([0, 6])
    pred = np.tanh(MOTION)
    jstep = js.ddim_reverse_step(jsched, jnp.asarray(pred), jnp.asarray(MOTION), jnp.asarray(t),
                                 mean_type=jm, clip_denoised=clip)
    tstep = ts.ddim_reverse_step(tsched, torch.from_numpy(pred), torch.from_numpy(MOTION),
                                 torch.from_numpy(t), mean_type=mean_type, clip_denoised=clip)
    assert rel(tstep.numpy(), jstep) <= TOL


@pytest.mark.parametrize("method", ["ddim", "plms", "dpmpp"])
def test_chain_runs_in_the_dtype_asked_for(method):
    """An f64 chain stays f64 and agrees with the JAX package's f32 chain."""
    jsched, tsched = _scheds()
    ref = _jchain(jsched, method=method)
    out = _tchain(tsched, method=method, dtype=torch.float64)
    assert out.dtype == torch.float64
    assert rel(out.numpy(), ref) <= TOL


def _tiny_rag():
    cfg = RAGConfig(latent_dim=32, num_layers=1, n_speakers=4)
    model = RAG(cfg, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(5)
    cond = {"audio": torch.from_numpy((0.1 * rng.normal(
                size=(2, audio_samples_for_frames(cfg.nframes)))).astype(np.float32)),
            "vid": torch.tensor([1, 3]),
            "origin_x": torch.from_numpy(
                rng.normal(size=(2, cfg.njoints, cfg.nfeats, cfg.nframes)).astype(np.float32))}
    return model, cond


def test_fused_denoiser_refuses_a_non_f32_chain():
    model, cond = _tiny_rag()
    den = make_fused_cfg_denoiser(model, cond, 1.5)
    sched = DiffusionSchedule.create(steps=20, timestep_respacing="ddim2")
    with pytest.raises(TypeError, match="f32"):
        ts.sample_loop(den, sched, (2, 9, 3, 34), torch.Generator().manual_seed(0),
                       method="ddim", dtype=torch.bfloat16)


def test_unsupported_method_and_order_raise():
    _, tsched = _scheds()
    with pytest.raises(ValueError, match="unsupported sampler"):
        _tchain(tsched, method="euler")
    with pytest.raises(ValueError, match="order"):
        _tchain(tsched, method="plms", order=5)
    with pytest.raises(ValueError, match="return_trajectory"):
        _tchain(tsched, method="ddim", return_trajectory="eps")


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("noised", [True, False], ids=["noised", "clean"])
def test_rag_sampler_passes_inpainting_through(use_fused, noised):
    """RAGSampler(inpainting=) is sample_loop with the same Inpainting over
    its CFG denoiser, from the same generator: the same bits; at the last
    step (t = 0) the held frames are the constraint."""
    model, cond = _tiny_rag()
    rng = np.random.default_rng(6)
    shape = (2, 9, 3, 34)
    mask = torch.zeros(shape, dtype=torch.bool)
    mask[..., :4] = True
    inpaint = ts.Inpainting(mask, torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
                            noised)
    sampler = RAGSampler(model, steps=50, timestep_respacing="ddim5", method="dpmpp",
                         use_fused=use_fused, device="cpu")
    out = sampler(cond, torch.Generator().manual_seed(3), inpainting=inpaint)
    make = make_fused_cfg_denoiser if use_fused else make_cfg_denoiser
    ref = ts.sample_loop(make(model, cond, 1.5), sampler.sched, shape,
                         torch.Generator().manual_seed(3), method="dpmpp", inpainting=inpaint)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert torch.equal(out[mask], inpaint.motion[mask])
    free = sampler(cond, torch.Generator().manual_seed(3))
    assert not torch.allclose(free, out)
