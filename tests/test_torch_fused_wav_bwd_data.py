"""K3's data-gradient kernel, held on the CPU: its tile geometry and a
written-out emulation of its arithmetic (``wav_bwd_data_kernel`` in
``csrc/fused_wav.cu``). With tau = 6q + r and tap k = r + 6j, conv i's
data gradient is, for each residue r of the stride, a product of the
cotangent window shifted by j rows and the weights of tap r + 6j; the
blocks (j = 2, r >= 3) are skipped. The emulation splits the window and the
weights into two TF32 halves rounded to nearest (ties away from zero), sums
lo.hi + hi.lo + hi.hi of each 8-channel stage in a fresh f32 sum added into
the running one, multiplies by lrelu'(xhat) and sums gy and gy * xhat over
each tile's input times. It is held against an f64 transposed conv and,
through the rest of the plain backward, against the JAX package's Pallas
VJP in interpret mode. The kernel itself runs on a card
(``test_torch_cuda.py``).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from livelyspeaker_tpu.models.audio_encoder import WavEncoder as JWavEncoder
from livelyspeaker_tpu.ops.pallas import fused_wav as jfused
from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
from livelyspeaker_tpu_torch.ops import fused_wav as k3
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict

TED_L = audio_samples_for_frames(34)  # T1..T4 = 7891, 1313, 217, 34
LEAK = 0.3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 rounds finite values: to
    nearest, ties away from zero, the low 13 bits cleared."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def emulate_data_grad(g: torch.Tensor, w: torch.Tensor, xh: torch.Tensor, from_wav: bool):
    """(gy [B, T_in, C_in], sums [B, ntq, 2, C_in]) for the cotangent g
    [B, T_out, C_out], the weights w [C_out, C_in, 15] and xhat [B, C_in,
    T_in], f32, as the kernel computes them."""
    b, t_out, c_out = g.shape
    c_in, t_in = xh.shape[1], xh.shape[2]
    rows = k3.bwd_data_rows(t_in, from_wav)
    ntq = -(-(-(-t_in // 6)) // rows)
    qp = ntq * rows  # q rows of all the tiles
    win = torch.zeros(b, qp + 2, c_out)  # window row u holds g's row u - 2, zeros outside
    win[:, 2:2 + t_out] = g
    ahi = tf32(win)
    alo = tf32(win - ahi)
    whi = tf32(w)
    wlo = tf32(w - whi)
    acc = torch.zeros(b, qp, 6, c_in)
    for o0 in range(0, c_out, 8):  # a stage: 8 output channels, a fresh sum
        o = slice(o0, o0 + 8)
        p = torch.zeros(b, qp, 6, c_in)
        for j in range(3):
            a_h, a_l = ahi[:, 2 - j:2 - j + qp, o], alo[:, 2 - j:2 - j + qp, o]
            for r in range(6):
                k = r + 6 * j
                if k >= 15:  # the zero blocks: no product
                    continue
                b_h, b_l = whi[o, :, k], wlo[o, :, k]
                p[:, :, r] += (a_l @ b_h + a_h @ b_l) + a_h @ b_h
        acc = acc + p
    xt = xh.transpose(1, 2)
    gy = acc.reshape(b, 6 * qp, c_in)[:, :t_in] * torch.where(xt > 0, 1.0, LEAK)
    span = 6 * rows
    sums = torch.stack([torch.stack([gy[:, s:s + span].sum(1), (gy * xt)[:, s:s + span].sum(1)],
                                    dim=1) for s in range(0, t_in, span)], dim=1)
    return gy, sums


def _rel(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def _operands(b, t_out, c_in, c_out, extra, seed):
    """g ~ N(0, 1) [B, T_out, C_out], w ~ N(0, 1/(15 C_in)) and xhat ~ N(0, 1)
    [B, C_in, T_in] over T_in = 6 (T_out - 1) + 15 + extra input times."""
    rng = np.random.default_rng(seed)
    t_in = 6 * (t_out - 1) + 15 + extra
    g = torch.from_numpy(rng.standard_normal((b, t_out, c_out), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((c_out, c_in, 15)) / np.sqrt(15 * c_in))
                         .astype(np.float32))
    xh = torch.from_numpy(rng.standard_normal((b, c_in, t_in), dtype=np.float32))
    return g, w, xh


@pytest.mark.parametrize("b,t_out,c_in,c_out,extra,from_wav", [
    (2, 34, 128, 256, 1, False),    # conv3 of TED: one tile of 48 q rows
    (1, 217, 64, 128, 4, False),    # conv2 of TED: 4 tiles of 64
    (1, 1313, 32, 64, 4, True),     # conv1 of TED: 21 tiles of 64
    (3, 3, 128, 256, 3, False),     # conv3 of a 2-frame clip
    (2, 49, 128, 256, 4, False),    # conv3 of 5,000 samples
    (5, 1, 64, 128, 5, False),      # one output time a sequence
])
def test_emulation_matches_f64(b, t_out, c_in, c_out, extra, from_wav):
    """gy within 2e-6 of max|gy| of the f64 transposed conv, each tile's
    sums within 2e-6 of their max; the input times no window reaches
    (``extra``) get gy = 0."""
    g, w, xh = _operands(b, t_out, c_in, c_out, extra, seed=b + t_out)
    gy, sums = emulate_data_grad(g, w, xh, from_wav)
    rgy, _ = k3._plain_data_grad(g.double(), w.double(), xh.double(), xh.shape[2], LEAK)
    assert _rel(gy, rgy) <= 2e-6
    assert (gy[:, 6 * (t_out - 1) + 15:] == 0).all()
    span = 6 * k3.bwd_data_rows(xh.shape[2], from_wav)
    terms = torch.stack([rgy, rgy * xh.double().transpose(1, 2)], dim=1)  # [B, 2, T_in, C_in]
    want = torch.stack([terms[:, :, s:s + span].sum(2) for s in range(0, xh.shape[2], span)],
                       dim=1)
    assert sums.shape == want.shape == (b, k3._bwd_data_tiles(xh.shape[2], from_wav), 2, c_in)
    assert _rel(sums, want) <= 2e-6


B, L = 3, audio_samples_for_frames(2)  # T1..T4 = 1064, 175, 27, 3


@functools.lru_cache(maxsize=None)
def _pallas_case():
    """jax.grad of sum(out * cot) with respect to the waveform and the
    parameters through the Pallas kernel in interpret mode (B=3, a 2-frame
    clip, batch tile 2, kernels x3 and seeded biases as
    tests/test_torch_fused_wav.py sets them up), and the port's encoder on
    the same parameters with the waveform and cotangent."""
    rng = np.random.default_rng(1)
    wav = rng.normal(0, 0.2, (B, L)).astype(np.float32)
    params = JWavEncoder().init(jax.random.PRNGKey(1), jnp.asarray(wav))["params"]
    params = {c: {"kernel": 3.0 * np.asarray(params[c]["kernel"]),
                  "bias": (0.1 * rng.normal(size=params[c]["bias"].shape)).astype(np.float32)}
              for c in (f"conv{i}" for i in range(4))}
    cot = rng.normal(size=(B, jfused.WavDims(L).T4, 256)).astype(np.float32)

    def loss(w, p):
        out = jfused.fused_wav_encoder(w, jfused.pack_wav_params(p), LEAK, 2)
        return jnp.sum(out * jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        d_wav, d_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(wav),
                                                    jax.tree.map(jnp.asarray, params))
    want = jax_params_to_state_dict(jax.device_get(d_p))
    want["wav"] = torch.from_numpy(np.asarray(d_wav))
    enc = WavEncoder()
    enc.load_state_dict(jax_params_to_state_dict(params))
    return want, enc, torch.from_numpy(wav), torch.from_numpy(cot)


@functools.lru_cache(maxsize=None)
def _emulated_backward():
    """The plain backward with each conv's data gradient and tile sums from
    the emulation: the InstanceNorm backward takes its means from the tiles'
    sums, in tile order. Gradients keyed as the state dict, and the
    waveform's."""
    _, enc, wav, cot = _pallas_case()
    packed = k3.pack_wav_params(enc, differentiable=False)
    _, res = k3.fused_wav_forward_reference(wav, packed)
    xh = k3.lrelu_inputs(res, packed)
    sts = (res.st0, res.st1, res.st2)
    grads, g_m = {}, cot  # g_m [B, T_out, C_out]
    for i in (3, 2, 1):
        dw, db = k3._conv_weight_grad(F.leaky_relu(xh[i - 1], LEAK), g_m.transpose(1, 2), 6)
        grads[f"conv{i}.weight"], grads[f"conv{i}.bias"] = dw, db
        gy, sums = emulate_data_grad(g_m, packed[f"w{i}"], xh[i - 1], i == 1)
        total = sums[:, 0].clone()
        for s in sums[:, 1:].unbind(1):
            total = total + s
        mean = total / gy.shape[1]  # [B, 2, C_in]
        xt = xh[i - 1].transpose(1, 2)
        g_m = sts[i - 1][:, 1, None] * (gy - mean[:, None, 0] - xt * mean[:, None, 1])
    wavp = F.pad(wav, (1600, 1600))[:, None]
    grads["conv0.weight"], grads["conv0.bias"] = k3._conv_weight_grad(wavp, g_m.transpose(1, 2), 5)
    grads["wav"] = F.conv_transpose1d(g_m.transpose(1, 2), packed["w0"], stride=5, padding=1600,
                                      output_padding=(L + 3185) % 5)[:, 0]
    return grads


@pytest.mark.parametrize("name", ["wav"] + [f"conv{i}.{p}" for i in range(3)
                                            for p in ("weight", "bias")])
def test_emulation_matches_pallas_vjp(name):
    """Every gradient downstream of a data gradient (d_wav, conv0..conv2)
    through the emulated data gradients, against jax.grad through the
    Pallas kernel: d_wav atol 5e-4, the rest atol 2e-4 after scaling by
    max(max|ref|, 1), as tests/test_torch_fused_wav.py holds the plain
    backward."""
    want, *_ = _pallas_case()
    got, ref = _emulated_backward()[name].numpy(), want[name].numpy()
    assert got.shape == ref.shape
    if name == "wav":
        np.testing.assert_allclose(got, ref, atol=5e-4)
    else:
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(got / scale, ref / scale, atol=2e-4)


@pytest.mark.parametrize("i", [1, 2, 3])
def test_data_grad_cpu_is_the_plain_version(i):
    """On the CPU data_grad is the plain data gradient, one tile of all the
    times, and the emulation agrees with it on the same operands."""
    _, enc, wav, cot = _pallas_case()
    packed = k3.pack_wav_params(enc, differentiable=False)
    _, res = k3.fused_wav_forward_reference(wav, packed)
    d = k3.WavDims(L)
    t = (d.T1, d.T2, d.T3, d.T4)
    g = torch.from_numpy(np.random.default_rng(i).standard_normal(
        (B, t[i], k3.CHANNELS[i + 1]), dtype=np.float32))
    gy, sums = k3.data_grad(i, res, g, packed)
    xh = k3.lrelu_inputs(res, packed)[i - 1]
    assert gy.shape == (B, t[i - 1], k3.CHANNELS[i]) and sums.shape == (B, 1, 2, k3.CHANNELS[i])
    egy, esums = emulate_data_grad(g, packed[f"w{i}"], xh, i == 1)
    assert _rel(egy, gy.double()) <= 2e-6
    assert _rel(esums.sum(1), sums[:, 0].double()) <= 2e-6
    torch.testing.assert_close(sums[:, 0, 0], gy.sum(1), rtol=1e-5, atol=1e-5)  # f32 sums


def _tiles(t_in, c_in, b, from_wav):
    """The kernel's tiles, as it numbers them: tile n is q rows
    rows (n % ntq) .. of sequence n / (ntq C_in / 32), channels
    32 (n / ntq % (C_in / 32)) ..; (ntq, [(b, q0, c0)])."""
    rows, cw = k3.bwd_data_rows(t_in, from_wav), k3.BWD_DATA_CHANNELS
    ntq, groups = k3._bwd_data_tiles(t_in, from_wav), c_in // cw
    return ntq, [(n // (ntq * groups), n % ntq * rows, n // ntq % groups * cw)
                 for n in range(ntq * groups * b)]


@pytest.mark.parametrize("length", [TED_L, L, 5000])
@pytest.mark.parametrize("i", [1, 2, 3])
@pytest.mark.parametrize("grid", [1, 7, 264])
def test_tiles_write_every_time_once(length, i, grid):
    """Over the CTAs of a persistent grid (CTA x takes tiles x, x + grid,
    ...), every (b, tau, c) of gy is written exactly once, the input times
    no window reaches included, and every tile's sums slot once."""
    d = k3.WavDims(length)
    t = (d.T1, d.T2, d.T3, d.T4)
    t_in, t_out, c_in, b = t[i - 1], t[i], k3.CHANNELS[i], 2
    rows = k3.bwd_data_rows(t_in, i == 1)
    ntq, tiles = _tiles(t_in, c_in, b, i == 1)
    seen = np.zeros((b, t_in, c_in), np.int64)
    slots = np.zeros((b, ntq, c_in), np.int64)
    for x in range(min(grid, len(tiles))):
        for bb, q0, c0 in tiles[x::grid]:
            taus = [6 * q + r for q in range(q0, q0 + rows) for r in range(6)]
            taus = [tau for tau in taus if tau < t_in]
            seen[bb, taus, c0:c0 + k3.BWD_DATA_CHANNELS] += 1
            slots[bb, q0 // rows, c0:c0 + k3.BWD_DATA_CHANNELS] += 1
    assert (seen == 1).all() and (slots == 1).all()
    assert ntq * rows * 6 >= t_in > (ntq - 1) * rows * 6
    if length == 5000 and i == 1:
        assert t_in > 6 * (t_out - 1) + 15  # times no window reaches exist here


@pytest.mark.parametrize("length,want", [
    (TED_L, ((64, 21), (64, 4), (48, 1))),
    (L, ((64, 3), (48, 1), (48, 1))),
    (5000, ((64, 5), (48, 1), (48, 1))),
])
def test_tile_rows_and_counts(length, want):
    """64 q rows a tile, 48 for a stored input of at most 48 (conv3 of TED:
    37); conv1's input always takes 64."""
    d = k3.WavDims(length)
    t = (d.T1, d.T2, d.T3)
    got = tuple((k3.bwd_data_rows(t[i], i == 0), k3._bwd_data_tiles(t[i], i == 0))
                for i in range(3))
    assert got == want


def test_backward_launches_split_the_weights_of_each_conv():
    """A backward splits each conv's weights once before its data
    gradient: three launches of each."""
    assert k3.BACKWARD_LAUNCHES["wsplit"] == k3.BACKWARD_LAUNCHES["bwd_data"] == 3
    assert sum(k3.BACKWARD_LAUNCHES.values()) == 16


@pytest.mark.parametrize("variant", ["no conv0 recompute", "no products", "no weight copies",
                                     "neither"])
def test_phase_script_anchors_match_the_kernel(variant):
    """k3_bwd_data.py patches the kernel's source by text: each variant's
    anchors are found once and change the source."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import k3_bwd_data

    src = k3_bwd_data.patched_source(k3_bwd_data.VARIANTS[variant])
    assert src != (k3_bwd_data.CSRC_DIR / "fused_wav.cu").read_text()
