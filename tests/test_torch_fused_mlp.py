"""Parity of the port's TransMLP and fused-stack ops with the JAX package.

Same seeded numpy inputs and the same (randomised) weights go through the
Flax/Pallas function and its PyTorch counterpart. The Pallas kernel runs in
interpret mode on the CPU; the CUDA kernel is compared with its plain
version on a card in ``test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from livelyspeaker_tpu.models.mlp_backbone import TransMLP as JTransMLP
from livelyspeaker_tpu.ops.pallas import fused_mlp as jfused
from livelyspeaker_tpu_torch.models.initializers import random_normal_
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP, get_activation, sinusoidal_table
from livelyspeaker_tpu_torch.ops import fused_mlp as tfused
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    random_normal_params,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _backbones(seq, dim, layers, act, seed=0):
    """A Flax TransMLP and its port, sharing randomised weights."""
    jm = JTransMLP(seq_len=seq, num_layers=layers, dim=dim, act=act)
    x0 = jnp.zeros((1, seq, dim))
    params = jm.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32))["params"]
    params = random_normal_params(jax.device_get(params), np.random.default_rng(seed))
    tm = TransMLP(seq, layers, dim, act)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return jm, params, tm


def _inputs(rng, b, seq, dim):
    x = rng.normal(size=(b, seq, dim)).astype(np.float32)
    t = rng.integers(0, 1000, size=(b,))
    return x, t


@pytest.mark.parametrize("act", ["silu", "relu", "gelu", "lrelu"])
def test_transmlp_matches_flax(act):
    rng = np.random.default_rng(1)
    jm, params, tm = _backbones(35, 64, 2, act)
    x, t = _inputs(rng, 3, 35, 64)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_sinusoidal_table_matches_jax():
    from livelyspeaker_tpu.models.mlp_backbone import sinusoidal_table as jtable

    np.testing.assert_array_equal(
        sinusoidal_table(5000, 64).numpy(), np.asarray(jtable(5000, 64))
    )


@pytest.mark.parametrize("fold_ln2", [False, True])
def test_pack_matches_jax(fold_ln2):
    seq, dim, layers = 35, 64, 2
    _, params, tm = _backbones(seq, dim, layers, "silu")
    jp = jfused.pack_transmlp_params(params, layers, fold_ln2=fold_ln2)
    tp = tfused.pack_transmlp_params(tm, fold_ln2=fold_ln2)
    assert set(tp) == set(jp)
    for k in jp:
        ref = np.asarray(jp[k])
        if k == "token_w":
            ref = ref[:, :seq, :seq]
        elif k == "token_b":
            ref = ref[:, :seq, 0]
        np.testing.assert_allclose(tp[k].numpy(), ref, atol=1e-6, rtol=1e-6, err_msg=k)
    jo = jfused.pack_out_proj(params["block_0"]["channel_mix"]["kernel"][:, :27],
                              params["block_0"]["channel_mix"]["bias"][:27])
    lin = torch.nn.Linear(dim, 27)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(jo["out_w"])[:, :27].T.copy()))
        lin.bias.copy_(torch.from_numpy(np.asarray(jo["out_b"])[0, :27].copy()))
    to = tfused.pack_out_proj(lin)
    np.testing.assert_allclose(to["out_w"].numpy(), np.asarray(jo["out_w"])[:, :27], atol=1e-6)
    np.testing.assert_allclose(to["out_b"].numpy(), np.asarray(jo["out_b"])[0, :27], atol=1e-6)


@pytest.mark.parametrize("fold_ln2", [False, True])
@pytest.mark.parametrize("with_out", [False, True])
def test_plain_fused_matches_pallas(fold_ln2, with_out):
    """The plain version equals the Pallas kernel (interpret mode), on a
    ragged batch of 5 with batch tile 4."""
    seq, dim, layers, feats = 36, 64, 2, 27
    rng = np.random.default_rng(2)
    _, params, tm = _backbones(seq, dim, layers, "silu", seed=3)
    x, t = _inputs(rng, 5, seq, dim)
    emb = rng.normal(size=(5, dim)).astype(np.float32)
    ow = (rng.normal(size=(dim, feats)) / np.sqrt(dim)).astype(np.float32)
    ob = (0.1 * rng.normal(size=(feats,))).astype(np.float32)

    jp = jfused.pack_transmlp_params(params, layers, fold_ln2=fold_ln2)
    jout = jfused.pack_out_proj(jnp.asarray(ow), jnp.asarray(ob)) if with_out else None
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfused.fused_transmlp(
            jnp.asarray(x), jnp.asarray(emb), jp, batch_tile=4, out_proj=jout))
    if with_out:
        ref = ref[..., :feats]

    tp = tfused.pack_transmlp_params(tm, fold_ln2=fold_ln2)
    tout = ({"out_w": torch.from_numpy(ow), "out_b": torch.from_numpy(ob)}
            if with_out else None)
    calls = tfused.fused_transmlp_reference.calls
    out = tfused.fused_transmlp(torch.from_numpy(x), torch.from_numpy(emb), tp,
                                out_proj=tout).numpy()
    assert tfused.fused_transmlp_reference.calls == calls + 1  # CPU -> plain
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_plain_fused_matches_eager_backbone():
    """Kernel semantics: the packed stack plus the PE-table embedding equals
    the eager TransMLP."""
    seq, dim = 35, 64
    rng = np.random.default_rng(4)
    _, _, tm = _backbones(seq, dim, 2, "gelu", seed=5)
    x, t = _inputs(rng, 3, seq, dim)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        ref = tm(xt, tt)
        emb = tm.embed_timestep(tt)
        out = tfused.fused_transmlp(xt, emb, tfused.pack_transmlp_params(tm, True), "gelu")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_unknown_activation_raises():
    _, _, tm = _backbones(35, 64, 1, "lrelu")
    x = torch.zeros(1, 35, 64)
    with pytest.raises(ValueError, match="lrelu"):
        tfused.fused_transmlp(x, torch.zeros(1, 64), tfused.pack_transmlp_params(tm), "lrelu")


def test_wrapper_rejects_other_devices():
    _, _, tm = _backbones(35, 64, 1, "silu")
    x = torch.zeros(1, 35, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfused.fused_transmlp(x, torch.zeros(1, 64), tfused.pack_transmlp_params(tm))


# --- the kernel's launch geometry (csrc/fused_transmlp.cu), decided on the host

H100 = tfused.H100_RESIDENT_CLUSTERS


@pytest.mark.parametrize("dim", list(range(16, 513, 16)))
def test_geometry_column_slices(dim):
    """At every width the kernel takes, each batch size gets a cluster that
    divides D into column slices of whole 16-byte loads, at most 256 wide,
    in the shared memory one block may use, with a weight ring of two to
    eight stages."""
    for b in (0, 1, 2, 15, 16, 17, 30, 31, 133, 512):
        geo = tfused.transmlp_geometry(b, 35, dim)
        assert geo.cluster in (1, 2, 4, 8)
        assert geo.cluster * geo.cols == dim
        assert (geo.cols * 4) % 16 == 0 and geo.cols <= 256
        assert geo.cluster in tfused.forward_cluster_sizes(dim)
        assert geo.m_tiles == (2 if geo.cols > 64 else 1)
        assert 2 <= geo.stages <= 8
        assert geo.smem_bytes <= tfused.SMEM_LIMIT and geo.ctas_per_sm >= 1


@pytest.mark.parametrize("b,s,d,resident,cluster", [
    (16, 35, 512, None, 4),     # the serving call: 16 clusters of 8 do not fit at once
    (15, 35, 512, None, 8),     # 15 do: the batch on 120 SMs
    (2, 35, 512, None, 8),
    (512, 35, 512, None, 2),    # DDPM-1000 at batch 256: many waves, the widest slices
    (64, 36, 512, None, 2),     # 64 clusters of 2 fit at once, of 4 not
    (16, 35, 512, {8: 16, 4: 33}, 8),  # a card that holds 16 clusters of 8
    (16, 35, 512, {8: 0, 4: 0}, 2),    # none at once: the widest slices
    (3, 10, 64, None, 1),       # below 2 x 64 columns one CTA takes the row
    (8, 35, 128, None, 2),
    (16, 35, 272, None, 4),     # 272 / 8 is not whole loads: 4 CTAs of 68
])
def test_geometry_choices(b, s, d, resident, cluster):
    geo = tfused.transmlp_geometry(b, s, d, resident)
    assert geo.cluster == cluster
    assert geo.cols == d // cluster


def test_geometry_at_the_serving_and_ddpm_shapes():
    """The choices the H100 gets at TED's and BEAT's D = 512."""
    serve = tfused.transmlp_geometry(16, 35, 512)
    assert (serve.cluster, serve.cols, serve.m_tiles, serve.stages) == (4, 128, 2, 5)
    ddpm = tfused.transmlp_geometry(512, 35, 512)
    assert (ddpm.cluster, ddpm.cols, ddpm.m_tiles, ddpm.stages) == (2, 256, 2, 3)
    small = tfused.transmlp_geometry(2, 36, 512)
    assert (small.cluster, small.cols, small.m_tiles, small.stages) == (8, 64, 1, 8)
    assert H100[8] < 16 <= H100[4]  # why 2B = 16 takes clusters of 4
    assert H100[4] < 31 <= H100[2]  # and 2B = 31 clusters of 2


@pytest.mark.parametrize("b,s,d,match", [
    (-1, 35, 512, "batch"),
    (2, 0, 512, "S=0"),
    (2, 37, 512, "S=37"),
    (2, 35, 8, "D=8"),
    (2, 35, 520, "D=520"),
    (2, 35, 200, "D=200"),
])
def test_geometry_refuses_what_the_kernel_refuses(b, s, d, match):
    with pytest.raises(ValueError, match=match):
        tfused.transmlp_geometry(b, s, d)


def test_cluster_sizes_are_the_kernels():
    """The training backward's block kernel takes column slices of at most
    128, the forward of at most 256 (one sequence's K split over the
    cluster)."""
    assert tfused.cluster_sizes(512) == [8, 4]
    assert tfused.cluster_sizes(272) == [4]
    assert tfused.cluster_sizes(64) == [8, 4, 2, 1]
    assert tfused.cluster_sizes(48) == [4, 2, 1]
    assert tfused.forward_cluster_sizes(512) == [8, 4, 2]
    assert tfused.forward_cluster_sizes(272) == [4, 2]
    assert tfused.forward_cluster_sizes(64) == [8, 4, 2, 1]
    assert tfused.forward_cluster_sizes(48) == [4, 2, 1]


def _sliced_ln_core(x, cluster, eps=1e-5):
    """``_ln_core`` as the kernel computes it (csrc/fused_transmlp.cu:
    row_stats): two-pass (mean, M2) over each of ``cluster`` column slices,
    combined with Chan's formula, mean = avg(mean_r), M2 = sum(M2_r) + Dc *
    sum((mean_r - mean)^2)."""
    d = x.shape[-1]
    parts = x.reshape(*x.shape[:-1], cluster, d // cluster)
    mean_r = parts.mean(-1)
    m2_r = ((parts - mean_r[..., None]) ** 2).sum(-1)
    mean = mean_r.mean(-1, keepdim=True)
    m2 = m2_r.sum(-1, keepdim=True) + (d // cluster) * ((mean_r - mean) ** 2).sum(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(m2 / d + eps)


@pytest.mark.parametrize("cluster,rows", [
    *[pytest.param(n, "f64", id=str(n)) for n in (1, 2, 4, 8)],
    *[pytest.param(n, "bf16", id=f"bf16-{n}") for n in (1, 2, 4, 8)]])
def test_sliced_ln_statistics_match_two_pass(cluster, rows):
    """The kernels' LayerNorm statistics: two-pass (mean, M2) per column
    slice, combined with Chan's formula, against the two-pass ``_ln_core``
    on rows with a large mean and a small spread. f64 rows: the comparison
    is of the algebra, not of the rounding. bf16 rows (the bf16 kernel's
    residual), the statistics taken in f32 from the bf16 values as that
    kernel takes them, against f64 on the same values. E[x^2] - E[x]^2 on
    the same rows, in the same type, loses the spread."""
    rng = np.random.default_rng(6)
    if rows == "f64":
        x = torch.from_numpy(1e4 + 1e-3 * rng.normal(size=(3, 35, 512)))
    else:  # bf16's spacing at 1e3 is 4: a spread of a few steps
        x = torch.from_numpy(1e3 + 4.0 * rng.normal(size=(3, 35, 512))).float().bfloat16().float()
    ref = tfused._ln_core(x.double())
    out = _sliced_ln_core(x, cluster)
    assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-6
    mean = x.mean(-1, keepdim=True)
    naive = (x - mean) * torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + 1e-5)
    assert ((naive.double() - ref).abs().max() / ref.abs().max()).item() > 1e-3


# --- the kernel's arithmetic (csrc/fused_transmlp.cu), emulated on the CPU

def _tf32(x):
    """x rounded to TF32 as csrc/tf32_mma.cuh's to_tf32 rounds it: half a
    TF32 ulp added to the bits, the low 13 bits cleared (to nearest, ties
    away from zero)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _emulated_product(h, w, terms):
    """h @ w as the kernel's wgmma take it: with three terms each operand is
    split, x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and each K-chunk of
    32 sums lo.hi, hi.lo and hi.hi (lo.lo left out) in f32, added into the
    running f32 sum as hi.hi + (lo.hi + hi.lo); with one, each chunk of
    tf32(h) @ tf32(w) is added."""
    hh, wh = _tf32(h), _tf32(w)
    hl, wl = _tf32(h - hh), _tf32(w - wh)
    run = torch.zeros(*h.shape[:-1], w.shape[1])
    for k0 in range(0, h.shape[-1], 32):
        k = slice(k0, k0 + 32)
        chunk = hh[..., k] @ wh[k]
        if terms == 3:
            chunk = chunk + (hh[..., k] @ wl[k] + hl[..., k] @ wh[k])
        run = run + chunk
    return run


def _emulated_stack(x, emb, packed, out_proj, terms):
    """fused_transmlp_reference with the channel mix and the pose
    projection taken as :func:`_emulated_product`."""
    act = get_activation("silu")
    emb = emb[:, None]
    for l in range(packed["token_w"].shape[0]):
        x = x + emb
        h = tfused._ln_core(x) * packed["ln1_scale"][l] + packed["ln1_bias"][l]
        h = torch.einsum("ij,bjd->bid", packed["token_w"][l], h)
        x = x + act(h + packed["token_b"][l][None, :, None])
        h = tfused._ln_core(x)
        x = x + act(_emulated_product(h, packed["ch_w"][l], terms) + packed["ch_b"][l])
    return _emulated_product(x, out_proj["out_w"], terms) + out_proj["out_b"]


@pytest.mark.parametrize("seq,feats", [pytest.param(35, 27, id="ted"),
                                       pytest.param(36, 282, id="beat")])
def test_3xtf32_products_hold_f32_and_one_pass_does_not(seq, feats):
    """The kernel's 3xTF32 channel mix and pose projection, emulated on
    seeded TED and BEAT stacks (D = 512, 8 blocks, LN2 folded; the order of
    the tensor cores' sums inside a K-chunk is the emulation's), stay within
    rel 1e-5 of max|plain f32|, the kernel's tolerance on the card; one pass
    of TF32 does not, so the comparison tells the two apart."""
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        tm = random_normal_(TransMLP(seq, 8, 512, "silu"), g)
        packed = tfused.pack_transmlp_params(tm, fold_ln2=True)
        lin = random_normal_(torch.nn.Linear(512, feats), g)
        op = tfused.pack_out_proj(lin)
        x = torch.randn(2, seq, 512, generator=g)
        emb = torch.randn(2, 512, generator=g)
        ref = tfused.fused_transmlp_reference(x, emb, packed, out_proj=op)
        rel = lambda out: ((out - ref).abs().max() / ref.abs().max()).item()
        three = rel(_emulated_stack(x, emb, packed, op, terms=3))
        one = rel(_emulated_stack(x, emb, packed, op, terms=1))
    assert three <= 1e-5, three
    assert one > 1e-5, one
