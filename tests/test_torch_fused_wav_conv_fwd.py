"""K3's forward conv kernel, held on the CPU: its tile geometry, its weight
layout and a written-out emulation of its arithmetic (``wav_conv_fwd_kernel``
in ``csrc/fused_wav.cu``). With input time tau = 6q + r and tap k = r + 6j,
conv i is, for each residue r of the stride, a product of the phase-split
input window a_r shifted by j rows and the weights of tap r + 6j; the taps
(j = 2, r >= 3) do not exist. The emulation splits the input and the weights
into two TF32 halves rounded to nearest (ties away from zero), sums
lo.hi + hi.lo + hi.hi of each stage (16 input channels of one residue) in a
fresh f32 sum added into the running one, and adds the bias. It is held
against an f64 conv and, through the rest of the plain forward, against the
JAX package's Pallas forward in interpret mode. The kernel itself runs on a
card (``test_torch_cuda.py``).
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


def emulate_conv_fwd(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, t_out: int):
    """out [B, T_out, C_out] of the conv with stride 6 over the input a
    [B, C_in, T_in] (already lrelu(IN(pre))), f32, as the kernel computes
    it: stages of 16 input channels and one residue r, each summed over its
    taps in a fresh sum, in the kernel's stage order (channel group, then
    residue)."""
    c_out, c_in, _ = w.shape
    ahi = k3._tf32(a)
    alo = k3._tf32(a - ahi)
    whi = k3._tf32(w)
    wlo = k3._tf32(w - whi)
    acc = torch.zeros(a.shape[0], t_out, c_out)
    for c0 in range(0, c_in, k3.FWD_STAGE_CHANNELS):
        c = slice(c0, c0 + k3.FWD_STAGE_CHANNELS)
        for r in range(6):
            p = torch.zeros_like(acc)
            for j in range(3 if r < 3 else 2):  # taps r + 6j < 15
                k = r + 6 * j
                taus = slice(k, k + 6 * (t_out - 1) + 1, 6)  # a_r[t + j] = a[6t + k]
                a_h, a_l = ahi[:, c, taus].transpose(1, 2), alo[:, c, taus].transpose(1, 2)
                b_h, b_l = whi[:, c, k].t(), wlo[:, c, k].t()
                p = p + ((a_l @ b_h + a_h @ b_l) + a_h @ b_h)
            acc = acc + p
    return acc + bias


def _rel(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("b,t_out,c_in,c_out,extra", [
    (2, 34, 128, 256, 1),    # conv3 of TED
    (1, 217, 64, 128, 4),    # conv2 of TED
    (1, 1313, 32, 64, 4),    # conv1 of TED
    (3, 3, 128, 256, 3),     # conv3 of a 2-frame clip
    (2, 49, 128, 256, 4),    # conv2 of 5,000 samples: input times no window reaches
    (5, 1, 64, 128, 5),      # one output time a sequence
])
def test_emulation_matches_f64(b, t_out, c_in, c_out, extra):
    """Within 2e-6 of max|out| of the f64 conv; the input times no window
    reaches (``extra``) do not matter."""
    rng = np.random.default_rng(b + t_out)
    t_in = 6 * (t_out - 1) + 15 + extra
    a = torch.from_numpy(rng.standard_normal((b, c_in, t_in), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((c_out, c_in, 15)) / np.sqrt(15 * c_in))
                         .astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c_out, dtype=np.float32))
    out = emulate_conv_fwd(a, w, bias, t_out)
    ref = F.conv1d(a.double(), w.double(), bias.double(), stride=6).transpose(1, 2)
    assert out.shape == ref.shape == (b, t_out, c_out)
    assert _rel(out, ref) <= 2e-6
    a[:, :, 6 * (t_out - 1) + 15:] = 1e30  # never read
    assert torch.equal(emulate_conv_fwd(a, w, bias, t_out), out)


B, L = 3, audio_samples_for_frames(2)  # T1..T4 = 1064, 175, 27, 3


@functools.lru_cache(maxsize=None)
def _pallas_forward():
    """The JAX forward through the Pallas kernel in interpret mode (B=3, a
    2-frame clip, batch tile 2, kernels x3 and seeded biases as
    tests/test_torch_fused_wav.py sets them up), and the port's encoder on
    the same parameters with the waveform."""
    rng = np.random.default_rng(3)
    wav = rng.normal(0, 0.2, (B, L)).astype(np.float32)
    params = JWavEncoder().init(jax.random.PRNGKey(3), jnp.asarray(wav))["params"]
    params = {c: {"kernel": 3.0 * np.asarray(params[c]["kernel"]),
                  "bias": (0.1 * rng.normal(size=params[c]["bias"].shape)).astype(np.float32)}
              for c in (f"conv{i}" for i in range(4))}
    with pltpu.force_tpu_interpret_mode():
        out = jfused.fused_wav_encoder(jnp.asarray(wav),
                                       jfused.pack_wav_params(jax.tree.map(jnp.asarray, params)),
                                       LEAK, 2)
    enc = WavEncoder()
    enc.load_state_dict(jax_params_to_state_dict(params))
    return np.asarray(out), enc, torch.from_numpy(wav)


@functools.lru_cache(maxsize=None)
def _emulated_forward():
    """The plain forward with each of conv1..3 from the emulation: (out,
    [m1, m2] as the kernels keep them, [B, T, C])."""
    _, enc, wav = _pallas_forward()
    packed = k3.pack_wav_params(enc, differentiable=False)
    m = k3._conv0(wav, packed)  # [B, 32, T1]
    pre = []
    for i in (1, 2, 3):
        a = F.leaky_relu(k3._xhat(m, k3._norm_stats(m)), LEAK)
        y = emulate_conv_fwd(a, packed[f"w{i}"], packed[f"b{i}"], (a.shape[2] - 15) // 6 + 1)
        pre.append(y)
        m = y.transpose(1, 2)
    return pre[2], pre[:2]


def test_emulated_forward_matches_pallas():
    """The forward through the emulated convs against the Pallas kernel in
    interpret mode: atol 2e-4, as tests/test_torch_fused_wav.py holds the
    drop-in (the JAX kernel's convs run at TPU default precision)."""
    want, *_ = _pallas_forward()
    got, _ = _emulated_forward()
    assert got.shape == want.shape == (B, 3, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_emulated_forward_matches_plain_residuals():
    """m1, m2 and the output through the emulated convs within 2e-6 of
    their max of the plain forward's."""
    _, enc, wav = _pallas_forward()
    out, res = k3.fused_wav_forward_reference(wav, k3.pack_wav_params(enc, differentiable=False))
    got, (m1, m2) = _emulated_forward()
    for a, ref in ((m1, res.m1), (m2, res.m2), (got, out)):
        assert a.shape == ref.shape
        assert _rel(a, ref.double()) <= 2e-6


def _tile(tile, b, t_out):
    """(first flattened row, row count) of forward conv tile ``tile``, as
    the kernel takes them."""
    rows, tps = k3.FWD_TILE_ROWS, k3.conv_fwd_tiles(b, t_out)[1]
    if tps:
        seq, k = divmod(tile, tps)
        return seq * t_out + k * rows, min(rows, t_out - k * rows)
    return tile * rows, min(rows, b * t_out - tile * rows)


def _segments(r0, nrows, t_out):
    """The runs of a tile's rows in one sequence, as the kernel walks them
    (csrc: fwd_segs): (b, t, n, j, u) for sequence b's times t .. t + n - 1,
    tile rows j .., window rows u .. u + n + 1."""
    out, r, u = [], r0, 0
    while r < r0 + nrows:
        b, t = divmod(r, t_out)
        n = min(t_out - t, r0 + nrows - r)
        out.append((b, t, n, r - r0, u))
        u += n + 2
        r += n
    return out


def _dims(length):
    d = k3.WavDims(length)
    return (d.T1, d.T2, d.T3, d.T4)


@pytest.mark.parametrize("length", [TED_L, L, 5000])
@pytest.mark.parametrize("i", [1, 2, 3])
@pytest.mark.parametrize("b", [1, 3, 64])
def test_tiles_write_every_output_once(length, i, b):
    """Over the grid of tiles x output-channel tiles (CTA x takes tile
    x / (C_out / 64), channels 64 (x % (C_out / 64)) ..), every (b, t, o) of
    the output is written exactly once; a tile spans at most 4 sequences,
    its window rows fit the stage's 64 + 2 * 4, and every window row a
    product reads lies in its own segment and before the input times no
    window reaches."""
    t = _dims(length)
    t_in, t_out, c_out = t[i - 1], t[i], k3.CHANNELS[i + 1]
    ntn = c_out // k3.FWD_TILE_N
    tiles, tps = k3.conv_fwd_tiles(b, t_out)
    seen = np.zeros((b * t_out, c_out), np.int64)
    for x in range(tiles * ntn):
        tile, nt = divmod(x, ntn)
        r0, nrows = _tile(tile, b, t_out)
        assert 1 <= nrows <= k3.FWD_TILE_ROWS
        segs = _segments(r0, nrows, t_out)
        assert len(segs) <= k3.FWD_SEGMENTS
        assert sum(n + 2 for _, _, n, _, _ in segs) <= k3.FWD_TILE_ROWS + 2 * k3.FWD_SEGMENTS
        for sb, st, n, j0, u in segs:
            assert sb * t_out + st == r0 + j0 and st + n <= t_out
            for m in range(j0, j0 + n):  # tile row m reads window rows u + m - j0 + 0..2
                tt = st + m - j0
                assert 6 * (tt + 2) + 2 <= 6 * (t_out - 1) + 14 < t_in  # the last tap read
                assert u + (m - j0) + 2 <= u + n + 1
        seen[r0:r0 + nrows, nt * k3.FWD_TILE_N:(nt + 1) * k3.FWD_TILE_N] += 1
    assert (seen == 1).all()
    if tps:
        assert t_out < 21 and tiles == b * tps


@pytest.mark.parametrize("t_out,want", [(34, (272, 0)), (1313, (10504, 0)), (217, (1736, 0)),
                                        (20, (512, 1)), (3, (512, 1)), (64, (512, 0))])
def test_tile_counts_at_batch_512(t_out, want):
    """Tiles of 64 flattened rows from 21 rows a sequence up (TED's conv3,
    34 rows, fills every tile), tiles inside a sequence below."""
    assert k3.conv_fwd_tiles(512, t_out) == want


@pytest.mark.parametrize("i", [1, 2, 3])
def test_weight_split_round_trips(i):
    """The forward weight split's layout [C_in / 16, C_out / 64, 15 slots,
    2, 64, 4, (hi c, hi c + 1, lo c, lo c + 1)], c = 16 g + 8 h + 2 tq,
    gives back the TF32 halves of w [C_out, C_in, 15], tap by tap in
    FWD_TAP_ORDER, and hi + lo is w to within TF32's rounding of lo."""
    c_in, c_out = k3.CHANNELS[i], k3.CHANNELS[i + 1]
    rng = np.random.default_rng(i)
    w = torch.from_numpy(rng.standard_normal((c_out, c_in, 15), dtype=np.float32))
    wsp = k3.forward_weight_split(w)
    assert wsp.shape == (c_out * c_in * 30,)
    v = wsp.view(c_in // 16, c_out // 64, 15, 2, 64, 4, 2, 2)  # [g, nt, slot, h, o, tq, half, e]
    # -> [half, nt, o, g, h, tq, e, slot], c = 16 g + 8 h + 2 tq + e
    halves = v.permute(6, 1, 4, 0, 3, 5, 7, 2).reshape(2, c_out, c_in, 15)
    order = torch.tensor(k3.FWD_TAP_ORDER)
    hi = torch.empty_like(w)
    lo = torch.empty_like(w)
    hi[:, :, order], lo[:, :, order] = halves[0], halves[1]
    assert torch.equal(hi, k3._tf32(w)) and torch.equal(lo, k3._tf32(w - k3._tf32(w)))
    assert ((hi + lo - w).abs() <= 2.0 ** -20 * w.abs()).all()
    assert sorted(k3.FWD_TAP_ORDER) == list(range(15))


@pytest.mark.parametrize("i", [1, 2, 3])
def test_conv_forward_cpu_is_the_plain_version(i):
    """On the CPU conv_forward is the plain conv over the residuals' input
    (no launch), it gives the plain forward's m1, m2 and output, and the
    emulation agrees with it."""
    _, enc, wav = _pallas_forward()
    packed = k3.pack_wav_params(enc, differentiable=False)
    out, res = k3.fused_wav_forward_reference(wav, packed)
    launches = dict(k3.LAUNCHES)
    y = k3.conv_forward(i, res, packed)
    assert k3.LAUNCHES == launches
    torch.testing.assert_close(y, (res.m1, res.m2, out)[i - 1], rtol=0, atol=0)
    a = F.leaky_relu(k3.lrelu_inputs(res, packed)[i - 1], LEAK)
    assert _rel(emulate_conv_fwd(a, packed[f"w{i}"], packed[f"b{i}"], y.shape[1]),
                y.double()) <= 2e-6


def test_forward_cpu_routes_to_the_plain_version():
    """A CPU waveform runs the plain forward: one call of it, no launch."""
    _, enc, wav = _pallas_forward()
    packed = k3.pack_wav_params(enc, differentiable=False)
    calls, launches = k3.fused_wav_forward_reference.calls, dict(k3.LAUNCHES)
    k3.fused_wav_forward(wav, packed)
    assert k3.fused_wav_forward_reference.calls == calls + 1
    assert k3.LAUNCHES == launches


def test_forward_launches_split_the_weights_of_each_conv():
    """A forward splits each conv's weights once before its conv: nine
    launches, three of each."""
    assert k3.FORWARD_LAUNCHES == {"stats0": 1, "wsplit_fwd": 3, "conv_fwd": 3, "stats": 2}
    assert list(k3.LAUNCHES)[:4] == ["stats0", "wsplit_fwd", "conv_fwd", "stats"]


def _k3_conv_fwd():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import k3_conv_fwd

    return k3_conv_fwd


@pytest.mark.parametrize("variant", ["no conv0 recompute", "no products", "no weight copies",
                                     "no transform", "no window copies", "none of them",
                                     "nothing", "products alone"])
def test_measurement_script_anchors_match_the_kernel(variant):
    """k3_conv_fwd.py patches the kernel's source by text: each variant's
    anchors are found once and change the source."""
    m = _k3_conv_fwd()
    src = (m.CSRC_DIR / "fused_wav.cu").read_text()
    patches = (m.NO_RECOMPUTE,) if variant == "no conv0 recompute" else m.PHASES[variant]
    assert m.patched_source(src, patches) != src
