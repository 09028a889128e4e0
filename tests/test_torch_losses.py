"""Parity of the port's diffusion losses and timestep samplers with JAX.

The same seeded numpy inputs go through each JAX function and its PyTorch
counterpart; the model is a fixed affine map of (x_t, t) on both sides, so
only the loss arithmetic is compared. Tolerances are f32 round-off.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.diffusion import losses as jl
from livelyspeaker_tpu.diffusion import resample as jr
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu_torch.diffusion import losses as tl
from livelyspeaker_tpu_torch.diffusion import resample as tr
from livelyspeaker_tpu_torch.diffusion.schedule import DiffusionSchedule

SHAPE = (3, 9, 3, 34)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These cases compute on the calling thread alone. At 3*9*3*34 = 2,754
    elements ATen splits an exp over two intra-op threads (1,377 elements
    each), and the first such split exp of a process can come back from
    the worker thread's half at about 1e-4 relative instead of f32's 1e-7
    when the host is loaded (normal_kl then misses its tolerance by up to
    60 times, from element 1,377 on). Whether an earlier test file on the
    same worker process has already run one decides whether this test is
    the first: one thread keeps every element on the calling thread's
    path, whatever ran before."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=err_msg)


@pytest.mark.parametrize("name", [
    "huber", "huber_per_sample", "sum_flat", "mean_flat", "masked_l2", "normal_kl",
    "discretized_gaussian_log_likelihood", "kld_from_mu_logvar",
])
def test_elementwise_losses_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    # values near and past the +-0.999 clip of the discretised likelihood
    x = np.clip(rng.normal(size=SHAPE), -1.0, 1.0).astype(np.float32)
    mask = (rng.random((3, 1, 1, 34)) < 0.7).astype(np.float32)
    args = {
        "huber": (a, 0.3 * b), "huber_per_sample": (a, 0.3 * b),
        "sum_flat": (a,), "mean_flat": (a,), "masked_l2": (a, b, mask),
        "normal_kl": (a, 0.5 * b, b, 0.3 * a), "kld_from_mu_logvar": (a, 0.5 * b),
    }.get(name)
    if name == "discretized_gaussian_log_likelihood":
        ref = jl.discretized_gaussian_log_likelihood(
            jnp.asarray(x), means=jnp.asarray(0.9 * x), log_scales=jnp.asarray(-2 + 0.1 * b))
        out = tl.discretized_gaussian_log_likelihood(
            torch.from_numpy(x), means=torch.from_numpy(0.9 * x),
            log_scales=torch.from_numpy(-2 + 0.1 * b))
    else:
        ref = getattr(jl, name)(*map(jnp.asarray, args))
        out = getattr(tl, name)(*map(torch.from_numpy, args))
    _close(out, ref)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(1)
    e = {"a": rng.normal(size=(4, 5)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in e.items()}
    ref = jl.ema_update({k: jnp.asarray(v) for k, v in e.items()},
                        {k: jnp.asarray(v) for k, v in p.items()}, 0.9)
    out = tl.ema_update({k: torch.from_numpy(v) for k, v in e.items()},
                        {k: torch.from_numpy(v) for k, v in p.items()}, 0.9)
    for k in e:
        _close(out[k], ref[k])


def _affine_model(with_kld):
    """The same deterministic 'model' in both frameworks: out = 0.7 x_t +
    1e-3 t, and a style token whose KLD depends on t."""
    def jfn(x_t, t_model):
        out = {"output": 0.7 * x_t + 1e-3 * t_model[:, None, None, None].astype(jnp.float32)}
        if with_kld:
            out["z_mu"] = 1e-3 * t_model[:, None].astype(jnp.float32) * jnp.ones((1, 4))
            out["z_logvar"] = -0.1 * jnp.ones((t_model.shape[0], 4))
        return out

    def tfn(x_t, t_model):
        out = {"output": 0.7 * x_t + 1e-3 * t_model[:, None, None, None].float()}
        if with_kld:
            out["z_mu"] = 1e-3 * t_model[:, None].float() * torch.ones((1, 4))
            out["z_logvar"] = -0.1 * torch.ones((t_model.shape[0], 4))
        return out

    return jfn, tfn


@pytest.mark.parametrize("loss_type,respacing,lambda_vel,mask_kind", [
    ("huber", None, 1.0, None),
    ("huber", "ddim20", 1.0, None),  # the timestep_map remap
    ("huber", None, 0.0, None),
    ("mse", None, 1.0, None),
    ("mse", "ddim20", 1.0, "2d"),
    ("mse", None, 0.5, "4d"),
])
def test_training_losses_match_jax(loss_type, respacing, lambda_vel, mask_kind):
    rng = np.random.default_rng(2)
    x0 = (0.3 * rng.normal(size=SHAPE)).astype(np.float32)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    jsched = JSchedule.create(steps=100, timestep_respacing=respacing)
    tsched = DiffusionSchedule.create(steps=100, timestep_respacing=respacing)
    t = rng.integers(0, jsched.num_timesteps, size=(3,))
    mask = None
    if mask_kind == "2d":
        mask = (rng.random((3, 34)) < 0.8).astype(np.float32)
    elif mask_kind == "4d":
        mask = (rng.random((3, 1, 1, 34)) < 0.8).astype(np.float32)
    jfn, tfn = _affine_model(with_kld=True)
    kw = dict(loss_type=loss_type, lambda_vel=lambda_vel)
    ref = jl.training_losses(jfn, jsched, jnp.asarray(x0), jnp.asarray(t), jax.random.PRNGKey(0),
                             mask=None if mask is None else jnp.asarray(mask),
                             noise=jnp.asarray(noise), **kw)
    out = tl.training_losses(tfn, tsched, torch.from_numpy(x0), torch.from_numpy(t),
                             mask=None if mask is None else torch.from_numpy(mask),
                             noise=torch.from_numpy(noise), **kw)
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k], err_msg=k)


def test_vb_terms_and_calc_bpd_loop_match_jax():
    """The bits/dim chain over 20 steps; the port is handed the noise of
    the JAX key stream (split(rng, 3) per step, the first key's normals).
    The denoiser is close to right: the decoder NLL at t = 0 is the log of a
    difference of two near-equal CDFs, which f32 round-off swings by 1e-3
    when the prediction is far off."""
    rng = np.random.default_rng(3)
    x0 = np.clip(0.5 * rng.normal(size=SHAPE), -1, 1).astype(np.float32)
    jsched = JSchedule.create(steps=20)
    tsched = DiffusionSchedule.create(steps=20)
    key = jax.random.PRNGKey(4)
    jx0, tx0 = jnp.asarray(x0), torch.from_numpy(x0)
    jden = lambda x_t, t, k: jx0 + 0.05 * (x_t - jx0)
    tden = lambda x_t, t, g: tx0 + 0.05 * (x_t - tx0)
    ref = jl.calc_bpd_loop(jden, jsched, jnp.asarray(x0), key)
    noises, loop_key = [], key
    for _ in range(20):
        loop_key, k1, _ = jax.random.split(loop_key, 3)
        noises.append(np.asarray(jax.random.normal(k1, SHAPE, jnp.float32)))
    out = tl.calc_bpd_loop(tden, tsched, torch.from_numpy(x0), noise=torch.from_numpy(np.stack(noises)))
    for k in ("total_bpd", "prior_bpd", "vb", "mse"):
        _close(out[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # one term on its own, at t = 0 (decoder NLL) and t > 0 (KL)
    t = np.array([0, 5, 19])
    x_t = (0.9 * x0).astype(np.float32)
    pred = (0.999 * x0).astype(np.float32)
    jv = jl.vb_terms_bpd(jsched, jnp.asarray(pred), jnp.asarray(x0), jnp.asarray(x_t), jnp.asarray(t))
    tv = tl.vb_terms_bpd(tsched, torch.from_numpy(pred), torch.from_numpy(x0),
                         torch.from_numpy(x_t), torch.from_numpy(t))
    _close(tv["output"], jv["output"], rtol=1e-5, atol=1e-6)


def test_uniform_sample_t():
    g = torch.Generator().manual_seed(0)
    t, w = tr.uniform_sample_t(g, 4096, 20)
    assert t.shape == (4096,) and t.dtype == torch.long
    assert int(t.min()) == 0 and int(t.max()) == 19
    assert torch.equal(w, torch.ones(4096))


@pytest.mark.parametrize("warm", [False, True])
def test_loss_second_moment_weights_match_jax(warm):
    rng = np.random.default_rng(5)
    hist = rng.random((12, 10)).astype(np.float32)
    counts = np.full((12,), 10 if warm else 9, np.int32)
    js = jr.LossSecondMomentState.create(12).replace(history=jnp.asarray(hist),
                                                     counts=jnp.asarray(counts))
    ts = tr.LossSecondMomentState(history=torch.from_numpy(hist), counts=torch.from_numpy(counts))
    _close(ts.weights(), js.weights(), rtol=1e-6)


def test_loss_aware_update_matches_jax_with_repeated_timesteps():
    """Several batches with repeated timesteps, through rows that fill up
    within a batch and rows that were already full (the scan's semantics:
    'full' fixed from the counts before the batch)."""
    rng = np.random.default_rng(6)
    js = jr.LossSecondMomentState.create(6, history_per_term=3)
    ts = tr.LossSecondMomentState.create(6, history_per_term=3)
    batches = [np.array([0, 0, 0, 0, 1, 2, 2]), np.array([0, 1, 1, 1, 1, 3]),
               np.array([5, 5, 0, 2, 2, 2, 2, 4])]
    for t in batches:
        losses = rng.random(len(t)).astype(np.float32)
        js = jr.loss_aware_update(js, jnp.asarray(t), jnp.asarray(losses))
        ts = tr.loss_aware_update(ts, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))


def test_loss_aware_sample_t_follows_the_weights():
    """Draws differ between the frameworks' generators; the law and the
    importance weights 1 / (T p(t)) are the same."""
    hist = np.where(np.arange(10)[:, None] < 5, 10.0, 1.0) * np.ones((10, 2))
    state = tr.LossSecondMomentState(history=torch.tensor(hist, dtype=torch.float32),
                                     counts=torch.full((10,), 2, dtype=torch.int32))
    jstate = jr.LossSecondMomentState.create(10, 2).replace(
        history=jnp.asarray(hist, jnp.float32), counts=jnp.full((10,), 2, jnp.int32))
    t, w = tr.loss_aware_sample_t(state, torch.Generator().manual_seed(0), 4096)
    jw = np.asarray(jstate.weights())
    p = jw / jw.sum()
    np.testing.assert_allclose(w.numpy(), 1.0 / (10 * p[t.numpy()]), rtol=1e-6)
    freq = np.bincount(t.numpy(), minlength=10) / 4096
    np.testing.assert_allclose(freq, p, atol=0.03)
