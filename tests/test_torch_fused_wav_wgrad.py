"""K3's weight-gradient kernel, held on the CPU: its geometry function and
a written-out emulation of its arithmetic (``wav_wgrad_kernel`` in
``csrc/fused_wav.cu``): the rows cut into the geometry's chunks, each chunk
into stages of up to 32 rows that span up to four sequences, the activation
and the cotangent split into two TF32 halves rounded to nearest (ties away
from zero), the three products lo.hi + hi.lo + hi.hi of every stage in a
fresh f32 sum added into the chunk's running one, and the chunks' partials
added in chunk order. The emulation is held against the JAX package's
Pallas VJP (interpret mode) and against an f64 product; one pass of TF32 is
shown to miss the gradient tolerance at conv3's full shape. The kernel
itself runs on a card (``test_torch_cuda.py``).
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

GRAD_TOL = 1e-4  # the K3 gradient tolerance (chip_smoke.py)
TED_L = audio_samples_for_frames(34)  # TED's and BEAT's clip: T1..T4 = 7891, 1313, 217, 34


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 rounds finite values: to
    nearest, ties away from zero, the low 13 bits cleared."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def stages(lo: int, hi: int, t_out: int):
    """The kernel's stages of the rows [lo, hi) (csrc: stage_segs): each up
    to 32 rows and up to four sequence segments; a list of
    (first row, end, [(b, t, n), ...])."""
    out, r0 = [], lo
    while r0 < hi:
        lim, r, segs = min(r0 + k3.WGRAD_STAGE, hi), r0, []
        while r < lim and len(segs) < k3.WGRAD_SEGMENTS:
            b, t = divmod(r, t_out)
            n = min(t_out - t, lim - r)
            segs.append((b, t, n))
            r += n
        out.append((r0, r, segs))
        r0 = r
    return out


def im2col(a: torch.Tensor, t_out: int, rows: slice) -> torch.Tensor:
    """[n, C_in * 15] of the rows (b, t): a[b, :, 6t + k], m = c * 15 + k."""
    win = a.unfold(2, 15, 6)[:, :, :t_out]  # [B, C, T_out, 15]
    return win.permute(0, 2, 1, 3).reshape(-1, a.shape[1] * 15)[rows]


def emulate_wgrad(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW [C_out, C_in, 15] for a [B, C_in, T_in] and g [B, T_out, C_out],
    f32, as the kernel sums it."""
    b, t_out, c_out = g.shape
    c_in = a.shape[1]
    geo = k3.wgrad_geometry(b, t_out, c_in, c_out)
    bounds = geo.bounds(b * t_out)
    gr = g.reshape(-1, c_out)
    total = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):  # chunk order
        acc = torch.zeros(c_in * 15, c_out)
        for r0, end, _ in stages(lo, hi, t_out):
            rows = slice(r0, end)
            x, y = im2col(a, t_out, rows), gr[rows]
            xhi, yhi = tf32(x), tf32(y)
            xlo, ylo = tf32(x - xhi), tf32(y - yhi)
            acc = acc + ((xlo.t() @ yhi + xhi.t() @ ylo) + xhi.t() @ yhi)
        total = acc if total is None else total + acc
    return total.t().reshape(c_out, c_in, 15)


def _rel(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def _operands(b, t_out, c_in, c_out, seed):
    """a = lrelu(N(0, 1)) [B, C_in, T_in] and g ~ N(0, 1) [B, T_out, C_out],
    and the f64 weight gradient."""
    rng = np.random.default_rng(seed)
    t_in = 6 * (t_out - 1) + 15 + seed % 4  # some input times no window reaches
    a = F.leaky_relu(torch.from_numpy(rng.standard_normal((b, c_in, t_in), dtype=np.float32)), 0.3)
    g = torch.from_numpy(rng.standard_normal((b, t_out, c_out), dtype=np.float32))
    ref = k3._conv_weight_grad(a.double(), g.transpose(1, 2).double(), 6)[0]
    return a, g, ref


@pytest.mark.parametrize("b,t_out,c_in,c_out", [
    (8, 34, 128, 256),   # conv3 at B=8: stages across sequence ends
    (3, 3, 128, 256),    # T_out=3: stages end at the fourth sequence
    (2, 175, 64, 128),   # conv2 of a 2-frame clip
    (1, 1313, 32, 64),   # conv1 of one TED clip: 42 stages, 11 chunks
    (7, 1, 64, 64),      # one time a sequence
])
def test_emulation_matches_f64(b, t_out, c_in, c_out):
    """Within 2e-6 of max|f64 product| at conv shapes of TED and of short
    clips."""
    a, g, ref = _operands(b, t_out, c_in, c_out, seed=b + t_out)
    assert _rel(emulate_wgrad(a, g), ref) <= 2e-6


@functools.lru_cache(maxsize=None)
def _conv3_full():
    """conv3 at TED B=512 (R = 17,408 rows, [1920, 256] output): the
    emulation, one pass of TF32 and the f64 product."""
    a, g, ref = _operands(512, 34, 128, 256, seed=3)
    one_pass = k3._conv_weight_grad(tf32(a).double(), tf32(g).transpose(1, 2).double(), 6)[0]
    return emulate_wgrad(a, g), one_pass, ref


def test_one_pass_tf32_misses_the_gradient_tolerance():
    """Why three products: at conv3's full shape one pass of TF32 (each
    operand rounded once) leaves an error of about 3e-4 of the largest
    entry, above GRAD_TOL; 3xTF32 stays two orders of magnitude inside it."""
    three, one_pass, ref = _conv3_full()
    assert _rel(one_pass, ref) > GRAD_TOL
    assert _rel(three, ref) <= GRAD_TOL / 100


B, L = 3, audio_samples_for_frames(2)  # T1..T4 = 1063, 175, 27, 3


@functools.lru_cache(maxsize=None)
def _pallas_case():
    """jax.grad of sum(out * cot) through the Pallas kernel in interpret
    mode (B=3, a 2-frame clip, batch tile 2, kernels x3 and seeded biases
    as tests/test_torch_fused_wav.py sets them up), and the port's operands
    of the weight-gradient kernel on the same parameters: each conv's input
    activation and output cotangent, from the plain forward and backward."""
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.2, (B, L)).astype(np.float32)
    params = JWavEncoder().init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    params = {c: {"kernel": 3.0 * np.asarray(params[c]["kernel"]),
                  "bias": (0.1 * rng.normal(size=params[c]["bias"].shape)).astype(np.float32)}
              for c in (f"conv{i}" for i in range(4))}
    cot = rng.normal(size=(B, jfused.WavDims(L).T4, 256)).astype(np.float32)

    def loss(p):
        out = jfused.fused_wav_encoder(jnp.asarray(wav), jfused.pack_wav_params(p), 0.3, 2)
        return jnp.sum(out * jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        d_p = jax.grad(loss)(jax.tree.map(jnp.asarray, params))
    want = jax_params_to_state_dict(jax.device_get(d_p))
    enc = WavEncoder()
    enc.load_state_dict(jax_params_to_state_dict(params))
    wav = torch.from_numpy(wav)
    return want, enc, wav, _conv_operands(enc, wav, torch.from_numpy(cot))


def _conv_operands(enc, wav, cot):
    """{i: (a_i [B, C_in, T_in], g_i [B, T_i, C_out])} for convs 1..3, as the
    plain backward computes them."""
    packed = k3.pack_wav_params(enc, differentiable=False)
    _, res = k3.fused_wav_forward_reference(wav, packed)
    d = k3.WavDims(wav.shape[1])
    lengths = (d.T1, d.T2, d.T3, d.T4)
    xh, sts = k3.lrelu_inputs(res, packed), (res.st0, res.st1, res.st2)
    ops, g_m = {}, cot.transpose(1, 2)
    for i in (3, 2, 1):
        ops[i] = (F.leaky_relu(xh[i - 1], 0.3), g_m.transpose(1, 2).contiguous())
        extra = lengths[i - 1] - ((lengths[i] - 1) * 6 + 15)
        g_a = F.conv_transpose1d(g_m, packed[f"w{i}"], stride=6, output_padding=extra)
        g_m = k3._norm_lrelu_backward(g_a, xh[i - 1], sts[i - 1], 0.3)
    return ops


@pytest.mark.parametrize("i", [1, 2, 3])
def test_emulation_matches_pallas_vjp(i):
    """dW_i as the kernel sums it, on the port's operands, against jax.grad
    through the Pallas kernel: atol 2e-4 after scaling by max(max|ref|, 1),
    as tests/test_torch_fused_wav.py holds the plain backward."""
    want, _, _, ops = _pallas_case()
    got = emulate_wgrad(*ops[i]).numpy()
    ref = want[f"conv{i}.weight"].numpy()
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-4)


@pytest.mark.parametrize("i", [1, 2, 3])
def test_operands_give_the_plain_backward(i):
    """The operands above are the plain backward's: wgrad_partials' CPU
    version, summed, is its dW_i and db_i."""
    _, enc, wav, ops = _pallas_case()
    packed = k3.pack_wav_params(enc, differentiable=False)
    _, res = k3.fused_wav_forward_reference(wav, packed)
    a, g = ops[i]
    dw, db = k3.reduce_partials(k3.wgrad_partials(i, res, g, packed), i)
    rw, rb = k3._conv_weight_grad(a, g.transpose(1, 2), 6)
    torch.testing.assert_close(dw, rw, rtol=0, atol=0)
    torch.testing.assert_close(db, rb, rtol=0, atol=0)


GEOMETRY_B = [1, 8, 64, 512]


@pytest.mark.parametrize("b", GEOMETRY_B)
@pytest.mark.parametrize("i", [1, 2, 3])
def test_wgrad_geometry_covers_every_row_once(b, i):
    """At TED's and BEAT's clip length the chunks cover the B*T rows from 0
    to R without gap or overlap, every chunk whole 32-row stages but the
    last; the stages cover each chunk the same way, each at most 32 rows of
    at most four sequences, whose windows fit the kernel's 228 times; the
    grid is at most one wave of the card, and all chunks have rows."""
    d = k3.WavDims(TED_L)
    t_out = (d.T1, d.T2, d.T3, d.T4)[i]
    c_in, c_out = k3.CHANNELS[i], k3.CHANNELS[i + 1]
    geo = k3.wgrad_geometry(b, t_out, c_in, c_out)
    rows = b * t_out
    bounds = geo.bounds(rows)
    assert bounds[0] == 0 and bounds[-1] == rows
    assert all(lo < hi for lo, hi in zip(bounds[:-1], bounds[1:]))
    assert all(x % 32 == 0 for x in bounds[:-1])
    assert geo.tiles == c_in // 16 * (c_out // 64)
    assert geo.tiles * geo.nsplit <= k3.WGRAD_WAVE
    seen = np.zeros(rows, np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        st = stages(lo, hi, t_out)
        assert st[0][0] == lo and st[-1][1] == hi
        for r0, end, segs in st:
            assert 0 < end - r0 <= 32 and len(segs) <= 4
            assert sum(n for _, _, n in segs) == end - r0
            assert sum(6 * n + 9 for _, _, n in segs) <= 6 * 32 + 9 * 4
            seen[r0:end] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,t_out,c_in,c_out,nsplit", [
    (512, 1313, 32, 64, 66), (512, 217, 64, 128, 16), (512, 34, 128, 256, 4),
    (8, 34, 128, 256, 3), (1, 34, 128, 256, 1), (8, 1313, 32, 64, 66), (1, 3, 128, 256, 1),
])
def test_wgrad_geometry_choices(b, t_out, c_in, c_out, nsplit):
    """TED at B=512: 2, 8 and 32 tiles take 66, 16 and 4 chunks (132, 128
    and 128 CTAs); few rows give fewer chunks of at least 4 stages."""
    assert k3.wgrad_geometry(b, t_out, c_in, c_out).nsplit == nsplit


@pytest.mark.parametrize("b,t_out,c_in,c_out,match", [
    (0, 34, 128, 256, "B=0"), (8, 0, 128, 256, "T=0"), (8, 34, 16, 64, "C_in=16"),
    (8, 34, 256, 64, "C_in=256"), (8, 34, 128, 100, "C_out=100"), (8, 34, 32, 32, "C_out=32"),
    (65535, 40000, 32, 64, "rows"),
])
def test_wgrad_geometry_refuses_what_the_kernel_refuses(b, t_out, c_in, c_out, match):
    with pytest.raises(ValueError, match=match):
        k3.wgrad_geometry(b, t_out, c_in, c_out)


def test_wgrad_partials_cpu_is_one_plain_chunk():
    """On the CPU wgrad_partials is the plain version: one row, dW in
    torch's layout then db, and reduce_partials adds rows in order."""
    _, enc, wav, ops = _pallas_case()
    packed = k3.pack_wav_params(enc, differentiable=False)
    _, res = k3.fused_wav_forward_reference(wav, packed)
    part = k3.wgrad_partials(3, res, ops[3][1], packed)
    assert part.shape == (1, 256 * 128 * 15 + 256)
    two = torch.cat([part, 2 * part])
    dw, db = k3.reduce_partials(two, 3)
    torch.testing.assert_close(dw, 3 * part[0, :-256].view(256, 128, 15), rtol=0, atol=0)
    torch.testing.assert_close(db, 3 * part[0, -256:], rtol=0, atol=0)


def test_phase_script_anchors_match_the_kernel():
    """k3_wgrad_phases.py patches the kernel's source by text: every anchor
    is found once, and the patched source switches both splits and the
    products."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import k3_wgrad_phases

    src = k3_wgrad_phases.patched_source()
    assert src.count("SPLIT r_next = transform(") == 2
    assert src.count("PRODUCTS products(") == 1
