"""Parity of the port's two-stage composition with the JAX package, at
small widths: the semantic sketch (CLIP text encode, then the SAG decode)
and the whole composition, the sketch refined through the fused CFG
denoiser over the last 20 steps of DDIM-100 (skip 80, guidance 1.5), at TED
and BEAT. The Pallas kernel runs in interpret mode; the port's runs its
plain version on the CPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from livelyspeaker_tpu.data.clip_tokenizer import HashTokenizer as JHashTokenizer
from livelyspeaker_tpu.diffusion import sample_loop as jsample_loop
from livelyspeaker_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.models import clip_text as jclip
from livelyspeaker_tpu.models import sag as jsag
from livelyspeaker_tpu.models.fast_rag import make_fused_cfg_denoiser as jfused_cfg
from livelyspeaker_tpu.pipeline import LivelySpeakerPipeline as JPipeline
from livelyspeaker_tpu_torch.data import HashTokenizer
from livelyspeaker_tpu_torch.diffusion import sample_loop
from livelyspeaker_tpu_torch.diffusion.schedule import DiffusionSchedule
from livelyspeaker_tpu_torch.models import (
    RAG,
    SAG,
    CLIPTextConfig,
    CLIPTextEncoder,
    RAGConfig,
    audio_samples_for_frames,
)
from livelyspeaker_tpu_torch.models.fast_rag import make_fused_cfg_denoiser
from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline, RAGSampler
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, random_normal_params

from test_torch_sag import _bridge, _no_tf32, rel  # noqa: F401 (_no_tf32: autouse fixture)

D, T, B = 64, 34, 2
SKETCH_TOL = 1e-5
SLICE_TOL = 1e-4  # the sampling gate of test_torch_rag.test_sampling_chain_matches_jax
CLIP = dict(vocab_size=49408, context_length=77, width=64, layers=2, heads=4, embed_dim=D)
SENTENCES = ["so we went down to the river", 'She said: "I never expected that, honestly!"']


@functools.lru_cache(maxsize=None)
def _models(variant):
    """RAG, SAG and CLIP text tower of both packages on the same randomised
    weights, with the RAG's conditioning (style_eps included). Built once
    per process; no test changes them."""
    kw = dict(latent_dim=D, num_layers=2, n_speakers=6)
    jcfg, tcfg = ((JRAGConfig.beat(**kw), RAGConfig.beat(**kw)) if variant == "beat"
                  else (JRAGConfig.ted(**kw), RAGConfig.ted(**kw)))
    rng = np.random.default_rng(20 if variant == "ted" else 21)
    cond = {
        "audio": (0.1 * rng.normal(size=(B, audio_samples_for_frames(T)))).astype(np.float32),
        "vid": rng.integers(0, jcfg.n_speakers, size=(B,)),
        "origin_x": rng.normal(size=(B, jcfg.njoints, jcfg.nfeats, T)).astype(np.float32),
        "style_eps": rng.normal(size=(B, 1, D)).astype(np.float32),
    }
    if jcfg.num_emotions:
        cond["emo"] = rng.integers(0, jcfg.num_emotions, size=(B,))
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    x = jnp.zeros((B, jcfg.njoints, jcfg.nfeats, T))
    jrag = JRAG(jcfg)
    rag_params = jrag.init({"params": jax.random.PRNGKey(0), "style": jax.random.PRNGKey(1)},
                           x, jnp.zeros((B,), jnp.int32), jcond)["params"]
    rag_params = random_normal_params(jax.device_get(rag_params), rng)
    trag = RAG(tcfg)
    trag.load_state_dict(jax_params_to_state_dict(rag_params))
    sag_kw = dict(njoints=jcfg.njoints, nfeats=jcfg.nfeats, latent_dim=D, ff_size=128,
                  num_layers=2, num_heads=4)
    jsag_m, tsag = jsag.SAG(**sag_kw), SAG(**sag_kw)
    sag_params = _bridge(jsag_m, tsag, x, seed=1)
    jclip_m = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**CLIP))
    tclip = CLIPTextEncoder(CLIPTextConfig(**CLIP))
    clip_params = _bridge(jclip_m, tclip, jnp.zeros((1, 77), jnp.int32), seed=2)
    on_jax = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    jpipe = JPipeline(jrag, on_jax(rag_params), jsag_m, on_jax(sag_params), jclip_m,
                      on_jax(clip_params), JHashTokenizer())
    return jpipe, (trag, tsag, tclip), cond


def _pipeline(variant, **kw):
    _, (trag, tsag, tclip), _ = _models(variant)
    return LivelySpeakerPipeline(trag, tsag, tclip, HashTokenizer(), device="cpu", **kw)


T_ = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("variant", ["ted", "beat"])
def test_semantic_sketch_matches_jax(variant):
    jpipe, _, cond = _models(variant)
    ref = np.asarray(jpipe.semantic_sketch(SENTENCES, jnp.asarray(cond["origin_x"])))
    out = _pipeline(variant).semantic_sketch(SENTENCES, torch.from_numpy(cond["origin_x"]))
    assert rel(out.numpy(), ref) <= SKETCH_TOL


@pytest.mark.parametrize("variant", ["ted", "beat"])
def test_composition_matches_jax(variant):
    """Each side's sketch, q-sampled to step 19 of DDIM-100 from the same
    noise and refined by its fused CFG denoiser for 20 steps."""
    jpipe, (trag, _, _), cond = _models(variant)
    noise = np.random.default_rng(22).normal(size=cond["origin_x"].shape).astype(np.float32)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    jsketch = jpipe.semantic_sketch(SENTENCES, jcond["origin_x"])
    jsched = JSchedule.create(steps=1000, timestep_respacing="ddim100")
    jden = jfused_cfg(jpipe.rag_sampler.model, jpipe.rag_sampler.params, jcond, 1.5, batch_tile=4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jsample_loop(jden, jsched, noise.shape, jax.random.PRNGKey(0),
                                      method="ddim", noise=jnp.asarray(noise),
                                      skip_timesteps=80, init_image=jsketch))
    pipe = _pipeline(variant, use_fused=True)
    sketch = pipe.semantic_sketch(SENTENCES, torch.from_numpy(cond["origin_x"]))
    tsched = DiffusionSchedule.create(steps=1000, timestep_respacing="ddim100")
    out = sample_loop(make_fused_cfg_denoiser(trag, T_(cond), 1.5), tsched, noise.shape,
                      method="ddim", noise=torch.from_numpy(noise), skip_timesteps=80,
                      init_image=sketch).numpy()
    assert np.isfinite(out).all()
    assert rel(out, ref) <= SLICE_TOL


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "eager"])
def test_pipeline_is_sketch_then_refinement(use_fused):
    """__call__ is its own semantic_sketch followed by a RAGSampler of the
    same settings with skip_timesteps=80 and init_image=sketch, from the
    same seeded generator: the same bits. No style_eps, so the generator
    draws the noise and every step's style."""
    _, (trag, _, _), cond = _models("ted")
    cond = T_({k: v for k, v in cond.items() if k != "style_eps"})
    pipe = _pipeline("ted", use_fused=use_fused)
    out = pipe(SENTENCES, cond, torch.Generator().manual_seed(3), guidance=1.5)
    sketch = pipe.semantic_sketch(SENTENCES, cond["origin_x"])
    sampler = RAGSampler(trag, use_fused=use_fused, device="cpu")
    ref = sampler(cond, torch.Generator().manual_seed(3), guidance=1.5, skip_timesteps=80,
                  init_image=sketch)
    assert out.shape == (B, 9, 3, T) and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    other = pipe(["a completely different sentence"] * B, cond,
                 torch.Generator().manual_seed(3), guidance=1.5)
    assert not torch.allclose(out, other)  # the text reaches the clip
