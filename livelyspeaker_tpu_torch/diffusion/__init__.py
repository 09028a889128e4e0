"""Diffusion schedules and the reverse sampling loop."""

from .sampling import (
    VarType,
    extract,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    predict_xstart_from_xprev,
    q_posterior_mean_variance,
    q_sample,
    sample_loop,
)
from .schedule import (
    DiffusionSchedule,
    betas_for_alpha_bar,
    get_named_beta_schedule,
    space_timesteps,
)
