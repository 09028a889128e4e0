"""Parity of the port's RAG slice with the JAX package, at small widths.

The JAX model's parameters are replaced with seeded normals of unit-fan-in
scale, carried over by the weight bridge, and the same seeded inputs go
through both sides: WavEncoder, the RAG forward, the fused CFG denoiser and
whole sampling chains. The Pallas kernel runs in interpret mode.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from livelyspeaker_tpu.diffusion import sample_loop as jsample_loop
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.models import WavEncoder as JWavEncoder
from livelyspeaker_tpu.models import make_guidance_schedule as jguidance
from livelyspeaker_tpu.models.fast_rag import make_fused_cfg_denoiser as jfused_cfg
from livelyspeaker_tpu_torch.diffusion import sample_loop
from livelyspeaker_tpu_torch.diffusion.schedule import DiffusionSchedule
from livelyspeaker_tpu_torch.models import (
    RAG,
    RAGConfig,
    WavEncoder,
    audio_samples_for_frames,
    make_cfg_denoiser,
    make_guidance_schedule,
)
from livelyspeaker_tpu_torch.models.fast_rag import (
    fused_rag_forward,
    make_fused_cfg_denoiser,
)
from livelyspeaker_tpu_torch.utils.checkpoints import load_params_npz
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    random_normal_params,
)

N_AUDIO = audio_samples_for_frames(34)  # 36,266 samples -> 34 frames


def _cfg(variant, **kw):
    kw = dict(latent_dim=64, num_layers=2, n_speakers=6, **kw)
    return (JRAGConfig.beat(**kw), RAGConfig.beat(**kw)) if variant == "beat" else (
        JRAGConfig.ted(**kw), RAGConfig.ted(**kw))


def _cond(rng, jcfg, b, style_eps=True):
    cond = {
        "audio": (0.1 * rng.normal(size=(b, N_AUDIO))).astype(np.float32),
        "vid": rng.integers(0, jcfg.n_speakers, size=(b,)),
        "origin_x": rng.normal(size=(b, jcfg.njoints, jcfg.nfeats, 34)).astype(np.float32),
    }
    if style_eps:
        cond["style_eps"] = rng.normal(size=(b, 1, jcfg.latent_dim)).astype(np.float32)
    if jcfg.num_emotions:
        cond["emo"] = rng.integers(0, jcfg.num_emotions, size=(b,))
    return cond


@functools.lru_cache(maxsize=None)
def _models(variant, seed=0):
    """A Flax RAG and its port on the same randomised weights (built once
    per process; no test changes them)."""
    jcfg, tcfg = _cfg(variant)
    jm = JRAG(jcfg)
    rng = np.random.default_rng(100 + seed)
    cond = {k: jnp.asarray(v) for k, v in _cond(rng, jcfg, 2).items()}
    x = jnp.zeros((2, jcfg.njoints, jcfg.nfeats, 34))
    params = jm.init({"params": jax.random.PRNGKey(seed), "style": jax.random.PRNGKey(1)},
                     x, jnp.zeros((2,), jnp.int32), cond)["params"]
    params = random_normal_params(jax.device_get(params), rng)
    tm = RAG(tcfg).eval()
    tm.load_state_dict(jax_params_to_state_dict(params))
    return jm, params, tm


J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
T = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("pcm", ["f32", "int16"])
def test_wav_encoder_matches_flax(pcm):
    rng = np.random.default_rng(0)
    wav = rng.normal(size=(2, N_AUDIO))
    wav = (wav * 3000).astype(np.int16) if pcm == "int16" else (0.1 * wav).astype(np.float32)
    jm = JWavEncoder()
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, N_AUDIO)))["params"]
    params = random_normal_params(jax.device_get(params), rng)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(wav)))
    tm = WavEncoder()
    tm.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (2, 34, 256)
    # rtol 1e-4, with an absolute floor for the entries that cross zero
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", ["ted", "beat"])
def test_rag_forward_matches_flax(variant):
    """Eager forward with style_eps and an explicit cond_drop, and the fused
    forward, against the Flax forward."""
    jm, params, tm = _models(variant)
    rng = np.random.default_rng(1)
    b = 2
    cond = _cond(rng, jm.cfg, b)
    cond["cond_drop"] = np.array([0.0, 1.0], np.float32)
    x = rng.normal(size=(b, jm.cfg.njoints, jm.cfg.nfeats, 34)).astype(np.float32)
    t = np.array([0, 999])
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), J(cond))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), T(cond))
        fused = fused_rag_forward(tm, torch.from_numpy(x), torch.from_numpy(t), T(cond),
                                  tm.encode_audio(torch.from_numpy(cond["audio"])))
    for k in ("output", "z_mu", "z_logvar"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=3e-4, err_msg=k)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref["output"]), atol=3e-4)


def test_encode_audio_checks_frame_count():
    _, _, tm = _models("ted")
    with pytest.raises(ValueError, match="frames"):
        tm.encode_audio(torch.zeros(1, 16000))


@pytest.mark.parametrize("name", [None, "const", "linear", "cosine", "step:300"])
def test_guidance_schedule_matches_jax(name):
    t = np.array([0, 100, 300, 640, 999])
    jf, tf = jguidance(name, 950), make_guidance_schedule(name, 950)
    if name in (None, "const"):
        assert jf is None and tf is None
        return
    np.testing.assert_allclose(tf(torch.from_numpy(t)).numpy(),
                               np.asarray(jf(jnp.asarray(t))), atol=1e-7)


@pytest.mark.parametrize("guidance", ["scalar", "per_sample", "cosine"])
def test_fused_cfg_denoiser_matches_jax(guidance):
    jm, params, tm = _models("ted", seed=1)
    rng = np.random.default_rng(2)
    b = 2
    cond = _cond(rng, jm.cfg, b)
    x = rng.normal(size=(b, 9, 3, 34)).astype(np.float32)
    t = np.array([40, 950])
    scale = 1.7 if guidance == "scalar" else np.array([1.3, 2.1], np.float32)
    sched = "cosine" if guidance == "cosine" else None
    jden = jfused_cfg(jm, params, J(cond), jnp.asarray(scale), batch_tile=4,
                      guidance_schedule=jguidance(sched, 999))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jden(jnp.asarray(x), jnp.asarray(t), jax.random.PRNGKey(5)))
    tscale = scale if guidance == "scalar" else torch.from_numpy(scale)
    tden = make_fused_cfg_denoiser(tm, T(cond), tscale,
                                   guidance_schedule=make_guidance_schedule(sched, 999))
    out = tden(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4)
    with torch.no_grad():  # the eager CFG denoiser agrees with the fused one
        eager = make_cfg_denoiser(tm, T(cond), tscale,
                                  guidance_schedule=make_guidance_schedule(sched, 999))
        np.testing.assert_allclose(eager(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
                                   out, atol=5e-4)


def test_fused_cfg_draws_independent_style_per_half():
    """Without style_eps, each step draws style noise for all 2B rows."""
    _, _, tm = _models("ted")
    rng = np.random.default_rng(3)
    cond = _cond(rng, tm.cfg, 2, style_eps=False)
    den = make_fused_cfg_denoiser(tm, T(cond), 1.0)
    x = torch.from_numpy(rng.normal(size=(2, 9, 3, 34)).astype(np.float32))
    t = torch.tensor([10, 10])
    a = den(x, t, torch.Generator().manual_seed(0))
    b = den(x, t, torch.Generator().manual_seed(0))
    c = den(x, t, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("method,respacing", [("dpmpp", "ddim20"), ("ddim", "ddim10")])
def test_sampling_chain_matches_jax(method, respacing):
    """The whole slice: fused CFG denoiser driven by the sampler, from the
    same initial noise, with style_eps; rel <= 1e-4 of max|x|."""
    jm, params, tm = _models("ted", seed=2)
    rng = np.random.default_rng(4)
    b = 2
    cond = _cond(rng, jm.cfg, b)
    noise = rng.normal(size=(b, 9, 3, 34)).astype(np.float32)
    guidance = np.array([1.5, 2.0], np.float32)
    jsched = JSchedule.create(steps=1000, timestep_respacing=respacing)
    jden = jfused_cfg(jm, params, J(cond), jnp.asarray(guidance), batch_tile=4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jsample_loop(jden, jsched, noise.shape, jax.random.PRNGKey(0),
                                      method=method, noise=jnp.asarray(noise)))
    tsched = DiffusionSchedule.create(steps=1000, timestep_respacing=respacing)
    tden = make_fused_cfg_denoiser(tm, T(cond), torch.from_numpy(guidance))
    out = sample_loop(tden, tsched, noise.shape, method=method,
                      noise=torch.from_numpy(noise)).numpy()
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


def test_skip_timesteps_chain_matches_jax():
    """A warm start: init_image q_sample-noised to step T-skip, DDIM."""
    jm, params, tm = _models("ted", seed=3)
    rng = np.random.default_rng(5)
    cond = _cond(rng, jm.cfg, 2)
    noise, init = (rng.normal(size=(2, 9, 3, 34)).astype(np.float32) for _ in range(2))
    jsched = JSchedule.create(steps=1000, timestep_respacing="ddim10")
    jden = jfused_cfg(jm, params, J(cond), 1.5, batch_tile=4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jsample_loop(jden, jsched, noise.shape, jax.random.PRNGKey(0),
                                      method="ddim", noise=jnp.asarray(noise),
                                      skip_timesteps=6, init_image=jnp.asarray(init)))
    tsched = DiffusionSchedule.create(steps=1000, timestep_respacing="ddim10")
    out = sample_loop(make_fused_cfg_denoiser(tm, T(cond), 1.5), tsched, noise.shape,
                      method="ddim", noise=torch.from_numpy(noise), skip_timesteps=6,
                      init_image=torch.from_numpy(init)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-4


def test_npz_checkpoint_crosses_the_bridge(tmp_path):
    """A params file written by the JAX package loads into the port."""
    from livelyspeaker_tpu.training.checkpoints import save_params_npz

    jm, params, _ = _models("beat")
    path = str(tmp_path / "model000001.npz")
    save_params_npz(path, params)
    tm = RAG(_cfg("beat")[1])
    tm.load_state_dict(jax_params_to_state_dict(load_params_npz(path)))
    rng = np.random.default_rng(6)
    cond = _cond(rng, jm.cfg, 2)
    x = rng.normal(size=(2, 47, 6, 34)).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray([7, 500]), J(cond))["output"]
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.tensor([7, 500]), T(cond))["output"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-4)


def test_fresh_init_matches_flax_statistics():
    """The port's own seeded init mirrors the Flax initialisers: 1e-6
    embeddings, a near-zero channel mix, zero biases and lecun-scale
    kernels."""
    tm = RAG(RAGConfig.beat(latent_dim=64, num_layers=2, n_speakers=6),
             generator=torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    assert torch.all(sd["speaker_embedding.weight"] == 1e-6)
    assert torch.all(sd["emotion_embedding.weight"] == 1e-6)
    cm = sd["backbone.block_0.channel_mix.weight"]
    assert 0 < cm.abs().max() < 1e-8 * np.sqrt(6 / 128) * 1.0001
    assert torch.all(sd["input_mapping.bias"] == 0)
    w = sd["input_mapping.weight"]  # fan_in 2*282+1+256
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.05
    assert w.abs().max() <= 2.0 / np.sqrt(w.shape[1]) / 0.87962566103423978 + 1e-6
    conv = sd["audio_encoder.conv1.weight"]  # [out, in, k], fan_in = in * k
    assert abs(conv.std().item() * np.sqrt(32 * 15) - 1.0) < 0.05
