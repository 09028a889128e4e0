"""K3's two conv0 kernels, held on the CPU: the conv0 statistics kernel
(``wav_stats0_kernel``) through ``conv0_stats``' plain version against the
JAX package's ``_instance_norm`` over conv0 and through a written-out
emulation of its arithmetic (``wav_stats_emulation.emulate_stats0``)
against f64; the conv0 backward kernel (``wav_wgrad0_kernel``) through
``conv0_backward``'s plain version against ``jax.vjp``; and both kernels'
splits of a sequence's times. The kernels themselves run on a card
(``test_torch_cuda.py``).
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livelyspeaker_tpu.models.audio_encoder import _instance_norm
from livelyspeaker_tpu_torch.ops import fused_wav as k3
from wav_stats_emulation import emulate_stats0, unshifted_stats

KERNEL_TOL = 1e-5  # chip_smoke.py's forward tolerance, relative
GRAD_TOL = 1e-4  # chip_smoke.py's gradient tolerance, relative
TED_L = 36_267  # TED's and BEAT's waveform: 34 frames at 15 fps, 16 kHz


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30)).item()


@functools.lru_cache(maxsize=None)
def _case(b, length, offset=1.0, seed=0):
    """A numpy-seeded waveform [B, L], conv0's Flax kernel [15, 1, 32] and
    bias, the bias ``offset`` times about conv0's spread, of either sign."""
    rng = np.random.default_rng(seed + b + length)
    wav = (0.1 * rng.normal(size=(b, length))).astype(np.float32)
    kernel = (0.1 * rng.normal(size=(15, 1, 32))).astype(np.float32)
    spread = 0.1 * 0.1 * np.sqrt(15)  # std of a tap sum of wav and kernel
    bias = (offset * spread * rng.choice([-1.0, 1.0], size=32)).astype(np.float32)
    return wav, kernel, bias


def _packed(kernel, bias):
    """conv0's parameters in torch's layout."""
    return {"w0": torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 1, 0))),
            "b0": torch.from_numpy(bias)}


def _jax_conv0(wav, kernel, bias):
    """conv0 as the JAX package's ``nn.Conv`` computes it: NWC, the Flax
    kernel [15, 1, 32], stride 5, padded 1600 a side; [B, T1, 32]."""
    y = jax.lax.conv_general_dilated(wav[..., None], kernel, (5,), [(1600, 1600)],
                                     dimension_numbers=("NWC", "WIO", "NWC"),
                                     precision=jax.lax.Precision.HIGHEST)
    return y + bias


@pytest.mark.parametrize("b,length", [(2, TED_L), (3, 2133), (1, 5000)])
def test_conv0_stats_cpu_matches_jax_instance_norm(b, length):
    """conv0 normalised by ``conv0_stats``' statistics (its plain version,
    on CPU tensors) against the JAX package's ``_instance_norm`` over the
    JAX conv0 of the same numpy-seeded waveform and weights, within
    KERNEL_TOL of its largest value."""
    wav, kernel, bias = _case(b, length)
    want = jax.jit(lambda w: _instance_norm(_jax_conv0(w, kernel, bias)))(jnp.asarray(wav))
    packed = _packed(kernel, bias)
    x = torch.from_numpy(wav)
    st0 = k3.conv0_stats(x, packed)
    assert st0.shape == (b, 2, 32) and st0.dtype == torch.float32
    got = k3._xhat(k3._conv0(x, packed), st0).transpose(1, 2)
    assert _rel(got, want) <= KERNEL_TOL


def _residuals(wav, st0):
    return k3.WavResiduals(wav, None, None, st0, None, None)


@pytest.mark.parametrize("need_wav_grad", [True, False])
@pytest.mark.parametrize("b,length", [(2, TED_L), (3, 2133)])
def test_conv0_backward_cpu_matches_jax_vjp(b, length, need_wav_grad):
    """``conv0_backward`` on CPU tensors (gy1 and its sums over time, one
    tile) against ``jax.vjp`` of (wav, kernel, bias) -> _instance_norm(
    conv0(wav)) with cotangent gy1: d_wav and dW0 within GRAD_TOL relative;
    db0, 0 in exact arithmetic (the norm removes a constant), within
    GRAD_TOL of the largest dW0. Without d_wav it returns None."""
    wav, kernel, bias = _case(b, length, seed=1)
    rng = np.random.default_rng(b)
    t1 = k3.WavDims(length).T1
    gy1 = rng.normal(size=(b, t1, 32)).astype(np.float32)
    f = lambda w, k, c: _instance_norm(_jax_conv0(w, k, c))
    _, vjp = jax.vjp(f, jnp.asarray(wav), jnp.asarray(kernel), jnp.asarray(bias))
    jd_wav, jd_kernel, jd_bias = (np.asarray(v) for v in vjp(jnp.asarray(gy1)))
    packed = _packed(kernel, bias)
    x = torch.from_numpy(wav)
    st0 = k3.conv0_stats(x, packed)
    xh = k3._xhat(k3._conv0(x, packed), st0).transpose(1, 2)  # [B, T1, 32]
    g = torch.from_numpy(gy1)
    sums = torch.stack([g.sum(1), (g * xh).sum(1)], dim=1)[:, None]  # [B, 1, 2, 32]
    d_wav, dw0, db0 = k3.conv0_backward(_residuals(x, st0), g, sums, packed, need_wav_grad)
    want_dw = np.ascontiguousarray(jd_kernel.transpose(2, 1, 0))
    assert dw0.shape == (32, 1, 15) and db0.shape == (32,)
    assert _rel(dw0, want_dw) <= GRAD_TOL
    assert (db0.double() - torch.from_numpy(jd_bias).double()).abs().max().item() \
        <= GRAD_TOL * np.abs(want_dw).max()
    if need_wav_grad:
        assert d_wav.shape == (b, length)
        assert _rel(d_wav, jd_wav) <= GRAD_TOL
    else:
        assert d_wav is None


def _stats_errors(st, m):
    """(mean error relative to the largest mean, relative 1/std error) of
    st [B, 2, 32] against the two-pass statistics in f64 of the same f32
    conv0 m [B, 32, T1]."""
    ref = k3._norm_stats(m.double())
    st = st.double()
    return (_rel(st[:, 0], ref[:, 0]),
            ((st[:, 1] - ref[:, 1]) / ref[:, 1]).abs().max().item())


# (B, L, offset): TED's waveform (clusters of 8), a 2-frame clip, a
# waveform of one sample (three live times), and b0 1e3 times conv0's spread
EMULATION_CASES = [(2, TED_L, 1.0), (3, 2133, 1.0), (1, 1, 1.0), (1, TED_L, 1e3),
                   (4, 4000, 1e3)]


@pytest.mark.parametrize("b,length,offset", EMULATION_CASES)
def test_stats0_emulation_matches_f64(b, length, offset):
    """The conv0 statistics kernel's arithmetic, emulated in f32 (its time
    split, the shift by row 0 = b0, Chan's combine in its order, the
    padding's times last), within KERNEL_TOL of the two-pass statistics in
    f64 of the same conv0, also where b0 is 1e3 times conv0's spread; and
    the plain version's st0 within KERNEL_TOL of it."""
    wav, kernel, bias = _case(b, length, offset, seed=2)
    packed = _packed(kernel, bias)
    x = torch.from_numpy(wav)
    st = emulate_stats0(x, packed)
    assert st.shape == (b, 2, 32) and st.dtype == torch.float32
    mean_err, inv_err = _stats_errors(st, k3._conv0(x, packed))
    assert mean_err <= KERNEL_TOL and inv_err <= KERNEL_TOL, (mean_err, inv_err)
    plain = k3.conv0_stats(x, packed)
    assert _rel(st[:, 0], plain[:, 0]) <= KERNEL_TOL and _rel(st[:, 1], plain[:, 1]) <= KERNEL_TOL


def test_unshifted_sums_miss_the_offset_case():
    """Why the kernel shifts its sums by b0: f32 sums of conv0 and its
    square without a shift lose 1/std where b0 is 1e3 times the spread."""
    wav, kernel, bias = _case(1, TED_L, 1e3, seed=2)
    packed = _packed(kernel, bias)
    m = k3._conv0(torch.from_numpy(wav), packed)
    assert _stats_errors(unshifted_stats(m.transpose(1, 2).contiguous()), m)[1] > 100 * KERNEL_TOL
    assert _stats_errors(emulate_stats0(torch.from_numpy(wav), packed), m)[1] <= KERNEL_TOL


@pytest.mark.parametrize("b,length", [(1, TED_L), (8, TED_L), (16, TED_L), (512, TED_L),
                                      (3, 2133), (2, 1), (5, 5000), (33, 100_000)])
def test_stats0_geometry_covers_every_live_time_once(b, length):
    """Each live time [lo, hi) of a sequence falls in exactly one batch of
    one warp of one CTA; the times before lo and from hi on see only
    padding; the cluster is as large as b of them need to fill 132 SMs (at
    most 8, at most one a CTA step of 256 times), less at most half by
    whole steps a CTA, and no CTA is empty."""
    lo, hi = k3.conv0_live(length)
    t1 = k3.WavDims(length).T1
    assert 0 < lo < hi <= t1
    assert 5 * (lo - 1) + 14 < 1600 and 5 * lo + 14 >= 1600  # lo - 1 sees padding only
    assert 5 * hi - 1600 >= length or hi == t1
    geo = k3.stats0_geometry(b, length)
    live = hi - lo
    want = min(8, -(-132 // b), -(-live // 256))
    assert geo.per % 256 == 0
    assert -(-want // 2) <= geo.cluster <= want
    seen = np.zeros(live, dtype=int)
    for rank in range(geo.cluster):
        end = min(live, (rank + 1) * geo.per)
        assert rank * geo.per < end
        for warp in range(8):
            for t0 in range(rank * geo.per + 32 * warp, end, 256):
                seen[t0:min(end, t0 + 32)] += 1
    assert (seen == 1).all()


def test_stats0_geometry_fills_the_card_at_b8():
    """At TED's waveform and B = 8, 64 CTAs (clusters of 8), not 8."""
    assert k3.stats0_geometry(8, TED_L).cluster == 8
    assert k3.stats0_geometry(512, TED_L).cluster == 1


@pytest.mark.parametrize("b,length", [(1, TED_L), (8, TED_L), (512, TED_L), (3, 2133),
                                      (2, 1), (5, 5000), (3000, 2133)])
def test_wgrad0_geometry_covers_every_time_and_sample_once(b, length):
    """The warps of a sequence own its T1 times once, each a whole number of
    groups of 4 times; the grid has b * splits warps in CTAs of 8, about
    two CTAs an SM; each waveform sample is written by the one warp that
    owns time (p + 1600) // 5, and every time whose window reaches it is in
    that warp's range or in the 4-time halo before it."""
    t1 = k3.WavDims(length).T1
    geo = k3.wgrad0_geometry(b, length)
    assert geo.per % 4 == 0
    assert geo.ctas == -(-b * geo.splits // 8)
    assert b * geo.splits <= max(2112, b) and geo.splits <= -(-t1 // 32)
    ranges = geo.ranges(t1)
    owner = np.full(t1, -1)
    for j, (t_begin, t_end) in enumerate(ranges):
        assert t_begin < t_end
        assert (owner[t_begin:t_end] == -1).all()
        owner[t_begin:t_end] = j
    assert (owner >= 0).all()
    writes = np.zeros(length, dtype=int)
    for j, (t_begin, t_end) in enumerate(ranges):
        done = set(range(max(0, t_begin - 4) if t_begin > 0 else 0, t_end))
        for t in range(t_begin, t_end):
            for p in range(5 * t - 1600, 5 * t - 1595):
                if 0 <= p < length:
                    writes[p] += 1
                    reach = {u for u in range(t - 2, t + 1)
                             if 0 <= u < t1 and 5 * u <= p + 1600 <= 5 * u + 14}
                    assert reach <= done, (j, p)
    assert (writes == 1).all()


def test_wgrad0_geometry_refuses_what_the_kernel_refuses():
    for b, length in ((0, 100), (65536, 100), (2, 0)):
        with pytest.raises(ValueError, match="wgrad0_geometry"):
            k3.wgrad0_geometry(b, length)
    with pytest.raises(ValueError, match="stats0_geometry"):
        k3.stats0_geometry(0, 100)


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors ``conv0_stats`` is the two-pass plain version over the
    plain conv0 and ``conv0_backward`` the plain InstanceNorm backward on
    the given sums, then the plain conv0 gradients, summed over one partial
    row; no kernel is launched."""
    wav, kernel, bias = _case(2, 2133, seed=3)
    packed = _packed(kernel, bias)
    x = torch.from_numpy(wav)
    launches = dict(k3.LAUNCHES)
    st0 = k3.conv0_stats(x, packed)
    assert torch.equal(st0, k3._norm_stats(k3._conv0(x, packed)))
    t1 = k3.WavDims(x.shape[1]).T1
    g = torch.randn(2, t1, 32, generator=torch.Generator().manual_seed(5))
    sums = torch.randn(2, 3, 2, 32, generator=torch.Generator().manual_seed(6))
    d_wav, part = k3.conv0_partials(_residuals(x, st0), g, sums, packed)
    assert part.shape == (1, 512)
    tot = sums.sum(1) / t1
    g_m0 = k3._in_backward(g.transpose(1, 2), k3._xhat(k3._conv0(x, packed), st0), st0,
                           tot[:, 0], tot[:, 1])
    want_wav, want_dw, want_db = k3._conv0_grads(x, g_m0, packed, True)
    assert torch.equal(d_wav, want_wav)
    assert torch.equal(part[0], torch.cat([want_dw.reshape(-1), want_db]))
    _, dw0, db0 = k3.conv0_backward(_residuals(x, st0), g, sums, packed, False)
    assert torch.equal(dw0, want_dw) and torch.equal(db0, want_db)
    assert k3.LAUNCHES == launches


def _k3_conv0():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import k3_conv0

    return k3_conv0


@pytest.mark.parametrize("variant", ["no conv0 recompute", "no dW0 sums", "no gy1 reads",
                                     "none of them"])
def test_measurement_script_anchors_match_the_kernels(variant):
    """k3_conv0.py --phases patches the kernels' source by text: each
    variant's anchors are found once and change the source."""
    m = _k3_conv0()
    src = (m.CSRC_DIR / "fused_wav.cu").read_text()
    assert m.patched_source(src, m.PHASES[variant]) != src
