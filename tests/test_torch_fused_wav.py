"""Parity of the port's fused WavEncoder stack (K3's plain versions, its
autograd Function and the drop-in module) with the JAX package and with
torch autograd of the port's eager WavEncoder.

The Pallas kernel runs in interpret mode on the CPU at its own test's size
(B=3, a 2-frame clip, batch tile 2); the CUDA kernels are held against the
plain versions on a card in ``test_torch_cuda.py``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from livelyspeaker_tpu.models.audio_encoder import WavEncoder as JWavEncoder
from livelyspeaker_tpu.ops.pallas import fused_wav as jfused
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import RAG, RAGConfig, WavEncoder, audio_samples_for_frames
from livelyspeaker_tpu_torch.models.initializers import random_normal_
from livelyspeaker_tpu_torch.ops import fused_wav as k3
from livelyspeaker_tpu_torch.training import TrainConfig
from livelyspeaker_tpu_torch.training.trainer import make_loss_fn
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B = 3
L = audio_samples_for_frames(2)  # 2,133 samples: T1..T4 = 1063, 175, 27, 3
CONVS = tuple(f"conv{i}" for i in range(4))
# conv biases followed by InstanceNorm: gradient 0 in exact arithmetic
ZERO_GRAD = ("conv0.bias", "conv1.bias", "conv2.bias")


@functools.lru_cache(maxsize=None)
def _setup():
    """Seeded waveform and JAX params (kernels x3, as the JAX test scales
    them, and seeded biases so the bias paths carry weight), the port's
    encoder on the same params, and a seeded output cotangent."""
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.2, (B, L)).astype(np.float32)
    params = JWavEncoder().init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    params = {c: {"kernel": 3.0 * np.asarray(params[c]["kernel"]),
                  "bias": (0.1 * rng.normal(size=params[c]["bias"].shape)).astype(np.float32)}
              for c in CONVS}
    enc = WavEncoder()
    enc.load_state_dict(jax_params_to_state_dict(params))
    cot = rng.normal(size=(B, jfused.WavDims(L).T4, 256)).astype(np.float32)
    return wav, params, enc, cot


@functools.lru_cache(maxsize=None)
def _jax_results():
    """The Pallas kernel's output and jax.grad of sum(out * cot) with
    respect to the waveform and the Flax params, in interpret mode."""
    wav, params, _, cot = _setup()
    jp = jax.tree.map(jnp.asarray, params)

    def loss(w, p):
        out = jfused.fused_wav_encoder(w, jfused.pack_wav_params(p), 0.3, 2)
        return jnp.sum(out * jnp.asarray(cot)), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), (d_wav, d_p) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(wav), jp)
    grads = jax_params_to_state_dict(jax.device_get(d_p))  # torch layout, keyed conv{i}.*
    grads["wav"] = torch.from_numpy(np.asarray(d_wav))
    return np.asarray(out), grads


@functools.lru_cache(maxsize=None)
def _port_results():
    """The drop-in's output and gradients (plain versions on the CPU)."""
    wav, _, enc, cot = _setup()
    fused = k3.FusedWavEncoder(enc)
    fused.zero_grad(set_to_none=True)
    w = torch.from_numpy(wav).requires_grad_(True)
    out = fused(w)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {k: p.grad.clone() for k, p in fused.named_parameters()}
    grads["wav"] = w.grad.clone()
    fused.zero_grad(set_to_none=True)
    return out.detach().numpy(), grads


@pytest.mark.parametrize("length", [0, 1, L, audio_samples_for_frames(34), 36_267 + 5, -280, -300])
def test_geometry_matches_jax_wavdims(length):
    """T1..T4 as the JAX package's WavDims gives them, and its raise when no
    frame is left (only below a length of -280 or so: conv0's 1600-sample
    padding leaves one frame even for an empty waveform)."""
    try:
        ref = jfused.WavDims(length)
    except ValueError:
        with pytest.raises(ValueError, match="too short"):
            k3.WavDims(length)
        return
    d = k3.WavDims(length)
    assert (d.T1, d.T2, d.T3, d.T4) == (ref.T1, ref.T2, ref.T3, ref.T4)
    if length == 36_267:
        assert (d.T1, d.T2, d.T3, d.T4) == (7891, 1313, 217, 34)


def test_forward_matches_jax_and_eager():
    """The drop-in's output against the Pallas kernel (atol 2e-4, the JAX
    test's) and against the port's eager WavEncoder (rel 1e-5)."""
    wav, _, enc, _ = _setup()
    out, _ = _port_results()
    ref, _ = _jax_results()
    assert out.shape == ref.shape == (B, 3, 256)
    np.testing.assert_allclose(out, ref, atol=2e-4)
    with torch.no_grad():
        eager = enc(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(out, eager, rtol=0, atol=1e-5 * np.abs(eager).max())


@pytest.mark.parametrize("name", ["wav"] + [f"{c}.{p}" for c in CONVS for p in ("weight", "bias")])
def test_gradients_match_jax(name):
    """d_wav (atol 5e-4) and every conv gradient (atol 2e-4 after scaling
    by max(max|ref|, 1), as tests/test_fused_wav.py holds them) against
    jax.grad through the Pallas kernel."""
    _, port = _port_results()
    _, ref = _jax_results()
    a, r = port[name].numpy(), ref[name].numpy()
    assert a.shape == r.shape
    if name == "wav":
        np.testing.assert_allclose(a, r, atol=5e-4)
    else:
        scale = max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(a / scale, r / scale, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("length,need_wav_grad,against", [
    (L, True, "eager"),
    (L, False, "eager"),
    (L, True, "plain"),
    (5000, True, "plain"),  # input times that no window of the next conv reaches
    (5000, False, "plain"),
    (audio_samples_for_frames(34), True, "plain"),
])
def test_plain_backward_matches_autograd(length, need_wav_grad, against):
    """The written-out backward against torch autograd, on the same weights:
    every gradient within 1e-4 of its max|autograd| (the pre-IN biases, 0 in
    exact arithmetic, within 1e-4 of the largest gradient); the plain
    forward against the eager WavEncoder within 1e-5.

    The gradient jumps at the LeakyReLU's kink, so two versions that round
    a pre-activation differently can take different branches where it lies
    within round-off of 0, and their weight gradients then differ by far
    more than round-off. So autograd runs through the eager WavEncoder
    (whose convs round as oneDNN does) at the JAX test's length, and
    through the plain forward, which rounds as the backward recomputes, at
    every length."""
    g = torch.Generator().manual_seed(1)
    enc = random_normal_(WavEncoder(), g)
    wav = 0.1 * torch.randn(2, length, generator=g)
    x = wav.clone().requires_grad_(need_wav_grad)
    packed = k3.pack_wav_params(enc)
    out = enc(x) if against == "eager" else k3.fused_wav_forward_reference(x, packed)[0]
    cot = torch.randn(out.shape, generator=g)
    names = [n for n, _ in enc.named_parameters()]
    inputs = list(enc.parameters()) + ([x] if need_wav_grad else [])
    ref = dict(zip(names + ["wav"], torch.autograd.grad((out * cot).sum(), inputs)))

    packed = k3.pack_wav_params(enc, differentiable=False)
    plain_out, res = k3.fused_wav_forward_reference(wav, packed)
    with torch.no_grad():
        eager = enc(wav)
    torch.testing.assert_close(plain_out, eager, rtol=0, atol=1e-5 * eager.abs().max().item())
    d_wav, grads = k3.fused_wav_backward_reference(res, cot, packed, 0.3, need_wav_grad)
    assert (d_wav is None) != need_wav_grad
    if need_wav_grad:
        grads["wav"] = d_wav
    top = max(v.abs().max().item() for v in ref.values())
    for name, r in ref.items():
        # conv{i}.weight -> w{i}, conv{i}.bias -> b{i}
        a = grads[name if name == "wav" else name[6] + name[4]]
        assert a.shape == r.shape, name
        tol = 1e-4 * (top if name in ZERO_GRAD else r.abs().max().item())
        assert (a - r).abs().max().item() <= tol, name


def test_function_routes_cpu_tensors_to_the_plain_versions():
    """On the CPU the Function runs the plain forward and backward once
    each, launches no kernel, and skips d_wav when the waveform needs no
    gradient; without autograd only the forward runs."""
    wav, _, enc, _ = _setup()
    packed = k3.pack_wav_params(enc)
    calls = (k3.fused_wav_forward_reference.calls, k3.fused_wav_backward_reference.calls)
    launches = dict(k3.LAUNCHES)
    out = k3.fused_wav_encoder(torch.from_numpy(wav), packed)
    out.sum().backward()
    assert all(p.grad is not None for p in enc.parameters())
    enc.zero_grad(set_to_none=True)
    with torch.no_grad():
        out2 = k3.fused_wav_encoder(torch.from_numpy(wav), packed)
    torch.testing.assert_close(out2, out.detach(), rtol=0, atol=0)
    assert k3.fused_wav_forward_reference.calls == calls[0] + 2
    assert k3.fused_wav_backward_reference.calls == calls[1] + 1
    assert k3.LAUNCHES == launches
    with pytest.raises(TypeError, match="f32"):
        k3.fused_wav_encoder(torch.from_numpy(wav).to(torch.bfloat16), packed)


def test_drop_in_keeps_keys_and_parameters():
    """The swap keeps the state_dict keys and the Parameter objects; int16
    PCM is decoded as the eager encoder does; a bf16 encoder is refused."""
    model = RAG(RAGConfig.ted(latent_dim=32, num_layers=1, n_speakers=6),
                generator=torch.Generator().manual_seed(0))
    keys = list(model.state_dict())
    before = {n: p for n, p in model.named_parameters()}
    eager = model.audio_encoder
    model.audio_encoder = k3.FusedWavEncoder(eager)
    assert list(model.state_dict()) == keys
    after = dict(model.named_parameters())
    assert list(after) == list(before) and all(after[n] is before[n] for n in before)
    pcm = torch.from_numpy(np.random.default_rng(2).integers(-3000, 3000, size=(2, L)).astype(np.int16))
    with torch.no_grad():
        torch.testing.assert_close(model.audio_encoder(pcm), eager(pcm), rtol=0, atol=1e-5)
    with pytest.raises(TypeError, match="f32"):
        k3.FusedWavEncoder(WavEncoder(dtype=torch.bfloat16))


@pytest.mark.parametrize("variant,kld", [("ted", 0.01), ("beat", 0.0)])
def test_rag_loss_and_gradients_with_the_drop_in(variant, kld):
    """One small RAG loss (the widths of test_torch_training.py) with the
    drop-in swapped in, against the same loss on the eager encoder, with
    the same t, noise, style and condition drop: loss rel 1e-5, every
    gradient within 1e-4 of its max (the pre-IN conv biases within 1e-4 of
    the largest gradient)."""
    make = RAGConfig.beat if variant == "beat" else RAGConfig.ted
    cfg = make(latent_dim=32, num_layers=1, n_speakers=6)
    g = torch.Generator().manual_seed(3)
    eager = random_normal_(RAG(cfg, generator=g), g)
    fused = RAG(cfg)
    fused.load_state_dict(eager.state_dict())
    fused.audio_encoder = k3.FusedWavEncoder(fused.audio_encoder)
    rng = np.random.default_rng(4)
    b = 4
    batch = {
        "motion": torch.from_numpy((0.3 * rng.normal(size=(b, cfg.njoints, cfg.nfeats, 34))).astype(np.float32)),
        "audio": torch.from_numpy((0.1 * rng.normal(size=(b, audio_samples_for_frames(34)))).astype(np.float32)),
        "vid": torch.from_numpy(rng.integers(0, cfg.n_speakers, size=(b,))),
    }
    if cfg.num_emotions:
        batch["emo"] = torch.from_numpy(rng.integers(0, cfg.num_emotions, size=(b,)))
    t = torch.from_numpy(rng.integers(0, 20, size=(b,)))
    noise = torch.from_numpy(rng.normal(size=batch["motion"].shape).astype(np.float32))
    style = torch.from_numpy(rng.normal(size=(b, 1, cfg.latent_dim)).astype(np.float32))
    drop = torch.tensor([0.0, 1.0, 0.0, 0.0])
    sched = DiffusionSchedule.create(steps=20)
    out = []
    for m in (fused, eager):
        params = dict(m.named_parameters())
        loss, _ = make_loss_fn(m, sched, TrainConfig(kld_weight=kld))(
            batch, t, torch.ones(b), None, noise, style, drop)
        out.append((loss.item(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))))
    (lf, gf), (le, ge) = out
    assert abs(lf - le) <= 1e-5 * abs(le)
    top = max(v.abs().max().item() for v in ge.values())
    for k, r in ge.items():
        tol = 1e-4 * (top if k.split(".", 1)[1] in ZERO_GRAD else r.abs().max().item())
        assert (gf[k] - r).abs().max().item() <= tol, k
