"""Parity of the port's long-form generation with the JAX package: the
window grid, and ``generate_long_form{,_stream}`` driven through one
deterministic stub sampler in both packages, so that the padding, the seed
frames, the cropping and the emotion token are compared exactly; then the
port's chain against its own RAGSampler called window by window."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu import pipeline as jpipeline
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu_torch import pipeline as tpipeline
from livelyspeaker_tpu_torch.models import RAG, RAGConfig
from livelyspeaker_tpu_torch.pipeline import RAGSampler

SR, FPS = 16000, 15


@pytest.mark.parametrize("n_samples", [0, 1000, 36266, 36267, 40000, 80 * SR // FPS,
                                       10 * SR, 10 * SR + 1, 10 ** 6])
def test_window_grid_matches_jax(n_samples):
    for nf, pre in ((34, 4), (36, 4), (20, 8)):
        ref = jpipeline.long_form_window_grid(n_samples, nf, pre, fps=FPS, sr=SR)
        assert tpipeline.long_form_window_grid(n_samples, nf, pre, fps=FPS, sr=SR) == ref


def _stub_clip(audio, vid, origin_x, emo, guidance, extra=0.0):
    """A fixed function of the conditioning [1, J, F, nf] that shows the
    audio window (its padding too), the seed frames, the speaker, the
    emotion and the guidance."""
    _, nj, nfe, nf = origin_x.shape
    a = audio[0]
    frame = a[(np.arange(nf) * a.shape[0]) // nf] + a.mean()
    scale = np.arange(1, nj * nfe + 1, dtype=np.float32).reshape(nj, nfe, 1)
    out = (0.5 * origin_x[0] + frame[None, None] * scale + 0.01 * vid[0] + 0.1 * emo[0]
           + guidance + extra + origin_x[0, :, :, :4].mean())
    return out[None].astype(np.float32)


class _JStub:
    def __init__(self, cfg):
        self.model = types.SimpleNamespace(cfg=cfg)

    def __call__(self, cond, rng, *, guidance, extra=0.0):
        emo = np.asarray(cond["emo"]) if "emo" in cond else np.zeros(1)
        return jnp.asarray(_stub_clip(np.asarray(cond["audio"]), np.asarray(cond["vid"]),
                                      np.asarray(cond["origin_x"]), emo, guidance, extra))


class _TStub:
    device = torch.device("cpu")

    def __init__(self, cfg):
        self.model = types.SimpleNamespace(cfg=cfg)

    def __call__(self, cond, generator, *, guidance, extra=0.0):
        emo = cond["emo"].numpy() if "emo" in cond else np.zeros(1)
        return torch.from_numpy(_stub_clip(cond["audio"].numpy(), cond["vid"].numpy(),
                                           cond["origin_x"].numpy(), emo, guidance, extra))


class _PipeStub:
    """A composition stub: the sampler stub plus a term of the sentence."""

    def __init__(self, sampler):
        self.sampler = sampler

    def __call__(self, sentences, cond, rng, *, guidance):
        (sentence,) = sentences
        return self.sampler(cond, rng, guidance=guidance, extra=0.001 * len(sentence))


@pytest.mark.parametrize("variant", ["ted", "beat", "ted_sentences"])
@pytest.mark.parametrize("seconds", [1.0, 80 / FPS, 10.0], ids=["1s", "80frames", "10s"])
def test_generate_long_form_matches_jax(variant, seconds):
    kw = dict(latent_dim=32, num_layers=1, n_speakers=4)
    jcfg, tcfg = ((JRAGConfig.beat(**kw), RAGConfig.beat(**kw)) if variant == "beat"
                  else (JRAGConfig.ted(**kw), RAGConfig.ted(**kw)))
    audio = np.random.default_rng(7).normal(size=int(seconds * SR)).astype(np.float32)
    jsampler, tsampler = _JStub(jcfg), _TStub(tcfg)
    common = dict(guidance=1.25, emotion=3)
    jkw, tkw = dict(common), dict(common)
    if variant == "ted_sentences":
        sentences = ["one", "a longer sentence", "mid"]
        jkw.update(pipeline=_PipeStub(jsampler), sentences=sentences)
        tkw.update(pipeline=_PipeStub(tsampler), sentences=sentences)
    ref = list(jpipeline.generate_long_form_stream(jsampler, audio, 2, jax.random.PRNGKey(0),
                                                   **jkw))
    out = list(tpipeline.generate_long_form_stream(tsampler, audio, 2, None, **tkw))
    assert [w for w, _ in out] == [w for w, _ in ref] == list(range(len(ref)))
    for (_, a), (_, b) in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    whole = tpipeline.generate_long_form(tsampler, audio, 2, None, **tkw)
    np.testing.assert_array_equal(whole, np.concatenate([c for _, c in ref], axis=-1))
    assert whole.shape == (tcfg.njoints, tcfg.nfeats, max(int(len(audio) * FPS / SR), 34))


def test_long_form_chain_is_the_sampler_window_by_window():
    """The port's chain through a RAGSampler: each window is one sampler
    call from the same generator in turn, on the window's audio (the tail
    zero-padded) and the previous window's last frames as its seed."""
    cfg = RAGConfig(latent_dim=32, num_layers=1, n_speakers=4)
    model = RAG(cfg, generator=torch.Generator().manual_seed(0))
    sampler = RAGSampler(model, steps=50, timestep_respacing="ddim3", method="ddim",
                         use_fused=True, device="cpu")
    audio = (0.1 * np.random.default_rng(8).normal(size=int(5.5 * SR))).astype(np.float32)
    chunks = list(tpipeline.generate_long_form_stream(
        sampler, audio, 1, torch.Generator().manual_seed(4), guidance=2.0))
    n_windows, excess, hop, total, offsets = tpipeline.long_form_window_grid(
        len(audio), cfg.nframes, cfg.n_pre_seq)
    assert len(chunks) == n_windows == 3 and excess > 0
    gen = torch.Generator().manual_seed(4)
    win = int(round(cfg.nframes / FPS * SR))
    seed = torch.zeros(1, cfg.njoints, cfg.nfeats, cfg.nframes)
    for w, chunk in chunks:
        wav = torch.zeros(1, win)
        piece = torch.from_numpy(audio[offsets[w]: offsets[w] + win])
        wav[0, : len(piece)] = piece
        clip = sampler({"audio": wav, "vid": torch.tensor([1]), "origin_x": seed.clone()},
                       gen, guidance=2.0)[0]
        want = clip if w == 0 else clip[:, :, cfg.n_pre_seq:]
        if w == n_windows - 1:
            want = want[:, :, :-excess]
        np.testing.assert_array_equal(chunk, want.numpy())
        seed.zero_()
        seed[0, :, :, : cfg.n_pre_seq] = clip[:, :, -cfg.n_pre_seq:]
    assert sum(c.shape[-1] for _, c in chunks) == total == int(len(audio) * FPS / SR)
    np.testing.assert_array_equal(
        tpipeline.generate_long_form(sampler, audio, 1, torch.Generator().manual_seed(4),
                                     guidance=2.0),
        np.concatenate([c for _, c in chunks], axis=-1))
