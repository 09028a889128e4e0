"""K2's weight-gradient path, held on the CPU: the weight-gradient kernel's
geometry function, and a written-out emulation of the kernel's arithmetic
(``wgrad_kernel`` in ``csrc/fused_transmlp_train.cu``): the rows split over
a cluster's CTAs at the geometry's boundaries, each operand split into two
TF32 halves rounded to nearest (ties away from zero), the three products
lo.hi + hi.lo + hi.hi of every 32-row step in a fresh f32 sum added into
the running one, and the CTAs' partials added in CTA order. The emulation
is held against the JAX package's Pallas VJP (interpret mode) and against
an f64 product at TED's full size; one pass of TF32 is shown to miss the
gradient tolerance. The kernels themselves run on a card
(``test_torch_cuda.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from livelyspeaker_tpu.models.mlp_backbone import TransMLP as JTransMLP
from livelyspeaker_tpu.ops.pallas import fused_mlp as jfused
from livelyspeaker_tpu.ops.pallas import fused_mlp_train as jtrain
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    random_normal_params,
)

GRAD_TOL = 1e-4  # the training kernels' gradient tolerance (chip_smoke.py)
PR5_RESIDENT = {8: 15, 4: 30, 2: 66, 1: 132}  # K1's and K2's counts on an H100 (PRs 4, 5)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 rounds finite values: to
    nearest, ties away from zero, the low 13 bits cleared."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def emulate_wgrad(h2: torch.Tensor, gm2: torch.Tensor, bounds) -> torch.Tensor:
    """h2^T g_m2 [D, D] for h2, g_m2 [R, D] f32, as the kernel sums it."""
    ahi, chi = tf32(h2), tf32(gm2)
    alo, clo = tf32(h2 - ahi), tf32(gm2 - chi)
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):  # CTA j's rows
        acc = torch.zeros(h2.shape[1], gm2.shape[1])
        for r0 in range(lo, hi, k2.WGRAD_STEP):
            r = slice(r0, min(r0 + k2.WGRAD_STEP, hi))
            acc = acc + ((alo[r].t() @ chi[r] + ahi[r].t() @ clo[r]) + ahi[r].t() @ chi[r])
        parts.append(acc)
    total = parts[0]
    for part in parts[1:]:  # CTA order
        total = total + part
    return total


def _rel(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def _operands(rows, d, seed):
    rng = np.random.default_rng(seed)
    h2 = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32))
    gm2 = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32))
    return h2, gm2, h2.double().t() @ gm2.double()


@pytest.mark.parametrize("rows,d", [(17920, 512), (105, 208), (10, 16), (2240, 48)])
def test_emulation_matches_f64(rows, d):
    """Within 2e-6 of max|f64 product| at TED B=512 (R = 17,920, D = 512)
    and at ragged row counts and widths, with the H100's geometry."""
    h2, gm2, ref = _operands(rows, d, seed=rows + d)
    geo = k2.wgrad_geometry(rows, d)
    assert _rel(emulate_wgrad(h2, gm2, geo.bounds), ref) <= 2e-6


def test_one_pass_tf32_misses_the_gradient_tolerance():
    """Why three products: at TED B=512 one pass of TF32 (each operand
    rounded once) leaves an error of about 3e-4 of the largest entry, three
    times GRAD_TOL; 3xTF32 stays three orders of magnitude inside it."""
    h2, gm2, ref = _operands(17920, 512, seed=1)
    one_pass = tf32(h2).double().t() @ tf32(gm2).double()
    assert _rel(one_pass, ref) > GRAD_TOL
    assert _rel(emulate_wgrad(h2, gm2, k2.wgrad_geometry(17920, 512).bounds), ref) <= GRAD_TOL / 100


def _backbones(seq, dim, layers, act, seed):
    jm = JTransMLP(seq_len=seq, num_layers=layers, dim=dim, act=act)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, seq, dim)),
                     jnp.zeros((1,), jnp.int32))["params"]
    params = random_normal_params(jax.device_get(params), np.random.default_rng(seed))
    tm = TransMLP(seq, layers, dim, act)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return params, tm


def _layer_operands(packed, x, emb, cot, act):
    """(h2, g_m2) of every layer as [B*S, D], the weight-gradient kernel's
    operands: from the plain forward, and each layer's output cotangent
    through autograd."""
    fn, dact = k2._act_pair(act)
    b, _, d = x.shape
    emb = emb.reshape(b, 1, d)
    layers = packed["token_w"].shape[0]
    ins, outs, h = [], [], x
    for l in range(layers):
        h = h.detach().requires_grad_(True)
        ins.append(h)
        rec = k2._block_recompute(h, emb, l, packed, fn)
        h = rec[5] + fn(rec[9])  # r1 + act(m2)
        outs.append((h, rec[6].detach(), rec[9].detach()))  # (y, h2, m2)
    ops, g = [None] * layers, cot
    for l in reversed(range(layers)):
        y, h2, m2 = outs[l]
        ops[l] = (h2.reshape(-1, d), (g * dact(m2)).reshape(-1, d))
        (g,) = torch.autograd.grad(y, ins[l], g)
    return ops


@pytest.fixture(scope="module")
def pallas_case():
    """jax.vjp of the Pallas training kernel in interpret mode (a ragged
    batch of 5 with batch tile 4, two blocks of [36, 64]) and the port's
    plain operands of the weight-gradient kernel on the same inputs."""
    seq, dim, layers, b, act = 36, 64, 2, 5, "silu"
    params, tm = _backbones(seq, dim, layers, act, seed=30)
    rng = np.random.default_rng(31)
    x = rng.normal(size=(b, seq, dim)).astype(np.float32)
    emb = rng.normal(size=(b, dim)).astype(np.float32)
    cot = rng.normal(size=(b, seq, dim)).astype(np.float32)
    jp = jfused.pack_transmlp_params(params, layers)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda xx, ee, pp: jtrain.fused_transmlp_train(xx, ee, pp, act, 4),
                         jnp.asarray(x), jnp.asarray(emb), jp)
        jdcw = np.asarray(vjp(jnp.asarray(cot))[2]["ch_w"])
    with torch.no_grad():
        packed = k2.pack_transmlp_train_params(tm)
    ops = _layer_operands(packed, *(torch.from_numpy(v) for v in (x, emb, cot)), act)
    return jdcw, ops, packed, (x, emb, cot, act)


@pytest.mark.parametrize("resident", [None, PR5_RESIDENT, {n: 1 for n in range(1, 9)}])
def test_emulation_matches_pallas_vjp(pallas_case, resident):
    """d ch_w of every layer as the kernel sums it, at the H100's geometry
    and at others (fewer or single CTAs), against jax.vjp of the Pallas
    kernel: rtol 1e-4 / atol 1e-4 of its max, the tolerance the plain
    versions are held to."""
    jdcw, ops, _, _ = pallas_case
    for l, (h2, gm2) in enumerate(ops):
        geo = k2.wgrad_geometry(h2.shape[0], h2.shape[1], resident)
        got = emulate_wgrad(h2.contiguous(), gm2.contiguous(), geo.bounds)
        np.testing.assert_allclose(got.numpy(), jdcw[l], rtol=1e-4,
                                   atol=1e-4 * np.abs(jdcw[l]).max(), err_msg=f"layer {l}")


def test_operands_give_the_plain_backward(pallas_case):
    """The operands above are the plain backward's: channel_mix_wgrad's CPU
    version on them is its d ch_w."""
    _, ops, packed, (x, emb, cot, act) = pallas_case
    x, emb, cot = (torch.from_numpy(v) for v in (x, emb, cot))
    _, stash = k2.fused_transmlp_train_forward_reference(x, emb, packed, act)
    want = k2.fused_transmlp_train_backward_reference(stash, emb, cot, packed, act)[2]["ch_w"]
    for l, (h2, gm2) in enumerate(ops):
        torch.testing.assert_close(k2.channel_mix_wgrad(h2, gm2), want[l], rtol=1e-5, atol=1e-5)


H100_RESIDENT = k2.H100_WGRAD_RESIDENT_CLUSTERS
SHAPES = [(1, 16), (10, 16), (31, 64), (33, 48), (105, 208), (300, 512), (2240, 512),
          (17920, 512), (18432, 512), (18432, 400), (12600, 128)]


@pytest.mark.parametrize("resident", [H100_RESIDENT, PR5_RESIDENT])
@pytest.mark.parametrize("rows,d", SHAPES)
def test_wgrad_geometry_one_wave(rows, d, resident):
    """The grid runs in one wave of the clusters the card holds, with the
    largest cluster that does and that gives every CTA a 32-row step."""
    geo = k2.wgrad_geometry(rows, d, resident)
    steps = -(-rows // 32)
    assert geo.tiles == (-(-d // k2.WGRAD_TILE)) ** 2
    assert geo.tiles <= resident[geo.cluster] and geo.cluster <= steps
    for n in range(geo.cluster + 1, 9):
        assert n > steps or geo.tiles > resident.get(n, 0)


@pytest.mark.parametrize("rows,d", SHAPES)
def test_wgrad_geometry_bounds_cover_the_rows_once(rows, d):
    """CTA j takes [bounds[j], bounds[j + 1]): from 0 to R without gap or
    overlap, every CTA at least one row, every inner boundary on a 32-row
    step."""
    b = k2.wgrad_geometry(rows, d).bounds
    assert b[0] == 0 and b[-1] == rows
    assert all(lo < hi for lo, hi in zip(b[:-1], b[1:]))
    assert all(x % 32 == 0 for x in b[:-1])


@pytest.mark.parametrize("rows,d,resident,cluster", [
    (17920, 512, None, 6), (18432, 512, None, 6), (2240, 512, None, 6),
    (17920, 512, PR5_RESIDENT, 4), (17920, 128, None, 8), (17920, 384, None, 8),
    (105, 512, None, 4), (10, 512, None, 1),
])
def test_wgrad_geometry_choices(rows, d, resident, cluster):
    """At D=512 the 16 tiles take clusters of 6 on an H100 (it holds 17 of
    6 and 15 of 7): 96 CTAs; up to 15 tiles take 8; few rows cap the
    cluster."""
    assert k2.wgrad_geometry(rows, d, resident).cluster == cluster


@pytest.mark.parametrize("rows,d,match", [
    (0, 512, "0 rows"), (-3, 512, "-3 rows"), (100, 520, "D=520"), (100, 8, "D=8"),
    (100, 40, "D=40"), (100, 1024, "D=1024"),
])
def test_wgrad_geometry_refuses_what_the_kernel_refuses(rows, d, match):
    with pytest.raises(ValueError, match=match):
        k2.wgrad_geometry(rows, d)


def test_reduce_partials_layout():
    """The CPU version of the reduce reads part's row layout as the block
    kernel writes it: d ln1 scale and bias, d ln2 scale and bias, d ch_b [D]
    each, d token_b [S], d token_w [S, S]."""
    b, s, d = 3, 5, 16
    rng = np.random.default_rng(2)
    want = {"ln1_scale": (d,), "ln1_bias": (d,), "ln2_scale": (d,), "ln2_bias": (d,),
            "ch_b": (d,), "token_b": (s,), "token_w": (s, s)}
    rows = {k: torch.from_numpy(rng.normal(size=(b,) + shp).astype(np.float32))
            for k, shp in want.items()}
    part = torch.cat([v.reshape(b, -1) for v in rows.values()], 1)
    got = k2.reduce_partials(part, s, d)
    assert set(got) == set(want)
    for k, v in rows.items():
        torch.testing.assert_close(got[k], v.sum(0))
