"""The port's progressive distillation (``experiments/distillation``)
against the JAX package's.

- ``distill_targets`` on the same x_t, t and teacher function within 1e-5
  of max|target|, and its oracle identity: with a teacher that returns the
  true x0 the target is that x0 (the JAX test's :29);
- one ``make_distill_step`` on the same teacher and student weights (JAX
  shapes from ``jax.eval_shape``, seeded normals), the same batch and the
  JAX step's own draws of t and noise: the loss within rel 1e-5, the
  params after AdamW within 1e-6. Both optimizers take eps 1e-3, as the
  one-step AdamW parity of ``test_torch_training.py`` does: Adam's first
  step is g / (|g| + eps), which at 1e-8 turns the round-off of a
  near-zero gradient into a step of up to lr. The style token is one fixed
  draw on both sides (the JAX side's ``reparameterize`` patched to it);
- the step learns (:78) and a student samples on the halved grid (:99).
"""

# torch.optim's first step imports torch._dynamo, and with it cProfile and the
# standard library's ``profile``; some tests put the JAX ``scripts/`` directory,
# which holds a ``profile.py``, on sys.path for a while. Importing cProfile at
# collection keeps ``profile`` the standard library's in every worker.
import cProfile  # noqa: F401
import copy
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from experiments.distillation import distill as jdistill
from livelyspeaker_tpu.diffusion import DiffusionSchedule as JSchedule
from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.models import rag as jrag
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.diffusion.sampling import q_sample, sample_loop
from livelyspeaker_tpu_torch.experiments.distillation import distill_targets, make_distill_step
from livelyspeaker_tpu_torch.models import RAG, RAGConfig, audio_samples_for_frames
from livelyspeaker_tpu_torch.models.cfg import make_cfg_denoiser
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, random_normal_params

TOL = 1e-5
B = 4
KW = dict(latent_dim=32, num_layers=1, n_speakers=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's CPU thread pool costs more than it gives
    here, and its spinning threads slow the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=1, b=B):
    rng = np.random.default_rng(seed)
    nf = 34
    return {"motion": (0.3 * rng.normal(size=(b, 9, 3, nf))).astype(np.float32),
            "audio": rng.normal(size=(b, audio_samples_for_frames(nf))).astype(np.float32),
            "vid": rng.integers(0, KW["n_speakers"], size=(b,))}


def _jax_params(seed):
    """Seeded normals over the JAX RAG's tree (shapes from eval_shape: no
    init runs)."""
    b = _batch()
    key = jax.random.PRNGKey(0)
    cond = {"audio": jnp.asarray(b["audio"]), "vid": jnp.asarray(b["vid"]),
            "origin_x": jnp.asarray(b["motion"])}
    shapes = jax.eval_shape(lambda: JRAG(JRAGConfig(**KW)).init(
        {"params": key, "style": key}, jnp.asarray(b["motion"]), jnp.zeros((B,), jnp.int32),
        cond))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return random_normal_params(zeros, np.random.default_rng(seed))


def _port_model(params):
    model = RAG(RAGConfig(**KW))
    model.load_state_dict(jax_params_to_state_dict(params))
    return model


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_distill_targets_match_jax():
    """The same x_t, t and teacher function (a smooth map of x and t) on
    both sides; the schedule respaced, so t counts its steps."""
    args = dict(steps=64, schedule="cosine", timestep_respacing="32")
    jsched, sched = JSchedule.create(**args), DiffusionSchedule.create(**args)
    rng = np.random.default_rng(3)
    x_t = rng.normal(size=(5, 2, 3, 7)).astype(np.float32)
    t = np.array([2, 9, 17, 25, 31])
    teacher = lambda x, tt, lib: 0.7 * x + 0.02 * lib.reshape(tt, (-1, 1, 1, 1)) - 0.1
    jt, jw = jdistill.distill_targets(jsched, lambda x, tt: teacher(x, tt, jnp), jnp.asarray(x_t),
                                      jnp.asarray(t))
    tt, tw = distill_targets(sched, lambda x, tt: teacher(x, tt.to(torch.float32), torch),
                             torch.from_numpy(x_t), torch.from_numpy(t))
    assert _rel(tt.numpy(), jt) <= TOL
    assert _rel(tw.numpy(), jw) <= TOL


def test_distill_target_identity_with_perfect_teacher():
    """With a teacher that returns the true x0, the one-step target is that
    x0 (two perfect DDIM steps land where one does, Salimans and Ho eq. 7)."""
    sched = DiffusionSchedule.create(steps=64, schedule="cosine")
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.normal(size=(4, 2, 3, 5)).astype(np.float32))
    t = torch.tensor([2, 17, 40, 63])
    noise = torch.from_numpy(rng.normal(size=tuple(x0.shape)).astype(np.float32))
    target, w = distill_targets(sched, lambda x, tt: x0, q_sample(sched, x0, t, noise), t)
    np.testing.assert_allclose(target.numpy(), x0.numpy(), atol=1e-3)
    assert bool((w >= 1.0).all())


def test_distill_step_matches_jax(monkeypatch):
    """One step from different teacher and student weights on a grid of 16
    over 32 steps: the loss (rel 1e-5), the metrics and the student's
    params after AdamW (1e-6)."""
    teacher_p, student_p = _jax_params(1), _jax_params(2)
    batch = _batch(4)
    eps = np.random.default_rng(5).normal(size=(B, 1, KW["latent_dim"])).astype(np.float32)
    monkeypatch.setattr(jrag, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar))
    args = dict(steps=32, schedule="cosine", timestep_respacing="16")
    jsched = JSchedule.create(**args)
    lr, wd = 1e-3, 1e-4
    tx = optax.adamw(lr, eps=1e-3, weight_decay=wd)
    jstep = jax.jit(jdistill.make_distill_step(JRAG(JRAGConfig(**KW)), jsched, tx, teacher_p))
    rng = jax.random.PRNGKey(7)
    _, new_p, jm = jstep(tx.init(student_p), student_p,
                         {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    # the JAX step's own draws (distill.py:147-149, :125)
    rng_t, rng_loss = jax.random.split(rng)
    t = np.array(jax.random.randint(rng_t, (B,), 2, jsched.num_timesteps))
    noise = np.array(jax.random.normal(jax.random.split(rng_loss, 3)[0],
                                         batch["motion"].shape, jnp.float32))

    teacher, student = _port_model(teacher_p), _port_model(student_p)
    opt = torch.optim.AdamW(student.parameters(), lr=lr, eps=1e-3, weight_decay=wd)
    step = make_distill_step(student, DiffusionSchedule.create(**args), opt, teacher)
    m = step({k: torch.from_numpy(v) for k, v in batch.items()}, t=torch.from_numpy(t),
             noise=torch.from_numpy(noise), style_eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(m["t_mean"]), float(jm["t_mean"]), rtol=TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ref = jax_params_to_state_dict(jax.device_get(new_p))
    for k, p in student.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    # the teacher is frozen: no gradient, no update
    for k, p in teacher.state_dict().items():
        assert torch.equal(p, jax_params_to_state_dict(teacher_p)[k]), k
    assert all(p.grad is None for p in teacher.parameters())


@pytest.fixture(scope="module")
def tiny_pair():
    model = RAG(RAGConfig(**KW), generator=torch.Generator().manual_seed(0))
    return model, {k: torch.from_numpy(v) for k, v in _batch(1, 8).items()}


def test_distill_step_learns(tiny_pair):
    """24 steps on the first 4 clips (the JAX test: 40 on 8)."""
    teacher, batch = tiny_pair
    batch = {k: v[:4] for k, v in batch.items()}
    sched = DiffusionSchedule.create(steps=32, schedule="cosine")
    # the student starts as the teacher (the paper's protocol)
    student = copy.deepcopy(teacher)
    opt = torch.optim.AdamW(student.parameters(), lr=1e-3, weight_decay=1e-4)
    step = make_distill_step(student, sched, opt, teacher)
    gen = torch.Generator().manual_seed(2)
    losses = [float(step(batch, gen)["loss"]) for _ in range(24)]
    assert np.isfinite(losses).all()
    # the student moves toward the teacher's two-step map
    assert np.mean(losses[-6:]) < np.mean(losses[:6]) * 0.8, losses[:3] + losses[-3:]


def test_distilled_student_samples_at_half_steps(tiny_pair):
    model, batch = tiny_pair
    sched_half = DiffusionSchedule.create(steps=32, schedule="cosine", timestep_respacing="16")
    cond = {"audio": batch["audio"], "vid": batch["vid"], "origin_x": batch["motion"]}
    with torch.no_grad():
        out = sample_loop(make_cfg_denoiser(model.eval(), cond, 1.0), sched_half,
                          (8, 9, 3, 34), torch.Generator().manual_seed(3), method="ddim")
    assert out.shape == (8, 9, 3, 34) and bool(torch.isfinite(out).all())
