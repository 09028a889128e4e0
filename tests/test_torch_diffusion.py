"""Parity of the port's diffusion schedule and posterior steps with JAX."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.diffusion import sampling as jsampling
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu_torch.diffusion import sampling as tsampling
from livelyspeaker_tpu_torch.diffusion.schedule import DiffusionSchedule, space_timesteps

TABLES = [
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "log_betas",
]


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("respacing", [None, "ddim100", "ddim20", "10"])
def test_schedule_tables_match_jax(schedule, respacing):
    j = JSchedule.create(steps=1000, schedule=schedule, timestep_respacing=respacing)
    t = DiffusionSchedule.create(steps=1000, schedule=schedule, timestep_respacing=respacing)
    assert t.num_timesteps == j.num_timesteps
    assert t.original_num_steps == j.original_num_steps
    np.testing.assert_array_equal(t.timestep_map.numpy(), np.asarray(j.timestep_map))
    for name in TABLES:
        a = getattr(t, name)
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-6, err_msg=name)
    idx = torch.tensor([0, t.num_timesteps - 1])
    np.testing.assert_array_equal(t.map_timesteps(idx).numpy(),
                                  np.asarray(j.map_timesteps(jnp.asarray(idx.numpy()))))


def test_space_timesteps_rejects_impossible_ddim():
    with pytest.raises(ValueError):
        space_timesteps(1000, "ddim999")


@pytest.mark.parametrize("var_type", ["fixed_small", "fixed_large"])
def test_ddpm_step_matches_jax(var_type):
    """One ancestral step from the same prediction and injected noise."""
    rng = np.random.default_rng(0)
    j = JSchedule.create(steps=1000, schedule="cosine", timestep_respacing="ddim100")
    t = DiffusionSchedule.create(steps=1000, schedule="cosine", timestep_respacing="ddim100")
    shape = (3, 9, 3, 34)
    x, pred, noise = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ts = np.array([0, 40, 99])
    jout = jsampling.p_mean_variance(j, jnp.asarray(pred), jnp.asarray(x), jnp.asarray(ts),
                                     var_type=jsampling.VarType(var_type))
    ref = np.asarray(jsampling._ddpm_update(j, jout, jnp.asarray(x), jnp.asarray(ts),
                                            jnp.asarray(noise)))
    tt = torch.from_numpy(ts)
    tout = tsampling.p_mean_variance(t, torch.from_numpy(pred), torch.from_numpy(x), tt,
                                     var_type=tsampling.VarType(var_type))
    out = tsampling._ddpm_update(t, tout, torch.from_numpy(x), tt, torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_step_and_q_functions_match_jax(eta):
    rng = np.random.default_rng(1)
    j = JSchedule.create(steps=1000, schedule="linear", timestep_respacing="ddim20")
    t = DiffusionSchedule.create(steps=1000, schedule="linear", timestep_respacing="ddim20")
    shape = (2, 9, 3, 34)
    x, pred, noise = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ts = np.array([3, 19])
    J = lambda a: jnp.asarray(a)
    T = torch.from_numpy
    jout = jsampling.p_mean_variance(j, J(pred), J(x), J(ts))
    tout = tsampling.p_mean_variance(t, T(pred), T(x), T(ts))
    pairs = [
        (jsampling._ddim_update(j, jout, J(x), J(ts), J(noise), eta),
         tsampling._ddim_update(t, tout, T(x), T(ts), T(noise), eta)),
        (jsampling.q_sample(j, J(x), J(ts), J(noise)),
         tsampling.q_sample(t, T(x), T(ts), T(noise))),
        (jsampling.predict_xstart_from_eps(j, J(x), J(ts), J(noise)),
         tsampling.predict_xstart_from_eps(t, T(x), T(ts), T(noise))),
        (jsampling.predict_xstart_from_xprev(j, J(x), J(ts), J(noise)),
         tsampling.predict_xstart_from_xprev(t, T(x), T(ts), T(noise))),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
