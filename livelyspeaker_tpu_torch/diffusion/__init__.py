"""Diffusion schedules, the reverse sampling loop, training losses and
timestep samplers."""

from .losses import (
    calc_bpd_loop,
    discretized_gaussian_log_likelihood,
    ema_update,
    huber,
    huber_per_sample,
    kld_from_mu_logvar,
    masked_l2,
    mean_flat,
    normal_kl,
    sum_flat,
    training_losses,
    vb_terms_bpd,
)
from .resample import (
    LossSecondMomentState,
    loss_aware_sample_t,
    loss_aware_update,
    uniform_sample_t,
)
from .sampling import (
    VarType,
    extract,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    predict_xstart_from_xprev,
    q_mean_variance,
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
