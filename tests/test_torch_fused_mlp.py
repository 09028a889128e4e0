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
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP, sinusoidal_table
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
    divides D into column slices of whole 16-byte loads, at most 128 wide,
    in the shared memory one block may use."""
    for b in (0, 1, 2, 15, 16, 17, 30, 31, 133, 512):
        geo = tfused.transmlp_geometry(b, 35, dim)
        assert geo.cluster in (1, 2, 4, 8)
        assert geo.cluster * geo.cols == dim
        assert (geo.cols * 4) % 16 == 0 and geo.cols <= 128
        assert geo.cluster in tfused.cluster_sizes(dim)
        assert 1 <= geo.k_slices <= 8
        assert geo.smem_bytes <= tfused.SMEM_LIMIT and geo.ctas_per_sm >= 1


@pytest.mark.parametrize("b,s,d,resident,cluster", [
    (16, 35, 512, None, 4),     # the serving call: 16 clusters of 8 do not fit at once
    (15, 35, 512, None, 8),     # 15 do: the batch on 120 SMs
    (2, 35, 512, None, 8),
    (512, 35, 512, None, 4),    # DDPM-1000 at batch 256: many waves, the widest slices
    (64, 36, 512, None, 4),
    (16, 35, 512, {8: 16, 4: 33}, 8),  # a card that holds 16 clusters of 8
    (16, 35, 512, {8: 0, 4: 0}, 4),    # none at once: the widest slices
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
    assert (serve.cluster, serve.cols, serve.k_slices) == (4, 128, 4)
    ddpm = tfused.transmlp_geometry(512, 35, 512)
    assert (ddpm.cluster, ddpm.cols, ddpm.k_slices) == (4, 128, 4)
    small = tfused.transmlp_geometry(2, 36, 512)
    assert (small.cluster, small.cols, small.k_slices) == (8, 64, 8)
    assert H100[8] < 16 <= H100[4]  # why 2B = 16 takes clusters of 4


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
    assert tfused.cluster_sizes(512) == [8, 4]
    assert tfused.cluster_sizes(272) == [4]
    assert tfused.cluster_sizes(64) == [8, 4, 2, 1]
    assert tfused.cluster_sizes(48) == [4, 2, 1]


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


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_sliced_ln_statistics_match_two_pass(cluster):
    """The kernel's LayerNorm statistics: two-pass (mean, M2) per column
    slice, combined with Chan's formula, against the two-pass ``_ln_core``
    on rows with a large mean and a small spread (f64: the comparison is of
    the algebra, not of the rounding). E[x^2] - E[x]^2 on the same rows
    loses the spread."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(1e4 + 1e-3 * rng.normal(size=(3, 35, 512)))
    ref = tfused._ln_core(x)
    out = _sliced_ln_core(x, cluster)
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-6
    mean = x.mean(-1, keepdim=True)
    naive = (x - mean) * torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + 1e-5)
    assert ((naive - ref).abs().max() / ref.abs().max()).item() > 1e-3
