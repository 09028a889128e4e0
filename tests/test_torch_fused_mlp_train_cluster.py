"""The arithmetic the cluster design adds to the training kernels (K2), held
on the CPU: a plain PyTorch mirror of the column-split backward of
``csrc/fused_transmlp_train.cu`` (each CTA's column slice, LN2's statistics
combined across the slices, the row sums of the LayerNorm backward
exchanged and added in CTA order, the per-CTA
``d token_w`` partials and their fixed-order sum), and the backward's
geometry function. The kernels themselves run on a card
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
from livelyspeaker_tpu_torch.ops import fused_mlp
from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    random_normal_params,
)


def _chan_stats(slices, eps=1e-5):
    """(mean, 1/std) of the rows of cat(slices) from each slice's two-pass
    (mean, M2), combined as the kernels combine them."""
    n, dc = len(slices), slices[0].shape[-1]
    means = [s.mean(-1, keepdim=True) for s in slices]
    m2s = [((s - m) ** 2).sum(-1, keepdim=True) for s, m in zip(slices, means)]
    mean = sum(means) / n
    m2 = sum(m2s) + dc * sum((m - mean) ** 2 for m in means)
    return mean, torch.rsqrt(m2 / (n * dc) + eps)


def _ordered_sum(parts):
    total = parts[0]
    for part in parts[1:]:  # CTA 0 first, as the kernel adds them
        total = total + part
    return total


def split_backward(stash, emb, g, packed, act_name, n):
    """The backward as a cluster of ``n`` CTAs computes it: every [B, S, D]
    intermediate as n column slices, whole rows only where the kernel
    gathers them (h2 and g_m2, for the two channel-mix products)."""
    act, dact = k2._act_pair(act_name)
    num_layers = packed["token_w"].shape[0]
    b, _, d = g.shape
    dc = d // n
    cols = [slice(r * dc, (r + 1) * dc) for r in range(n)]
    emb = emb.reshape(b, 1, d)
    grads = {k: [None] * num_layers for k in k2.PACKED_KEYS}
    gemb = torch.zeros((b, d), dtype=g.dtype)
    for l in reversed(range(num_layers)):
        w = {k: packed[k][l] for k in k2.PACKED_KEYS}
        cw_t = w["ch_w"].t().contiguous()
        whole = stash[l] + emb  # every CTA reads the whole rows of the block input
        mean1 = whole.mean(-1, keepdim=True)
        inv1 = torch.rsqrt(((whole - mean1) ** 2).mean(-1, keepdim=True) + 1e-5)
        a = [whole[..., c] for c in cols]
        xhat1 = [(a[r] - mean1) * inv1 for r in range(n)]
        h1 = [xhat1[r] * w["ln1_scale"][cols[r]] + w["ln1_bias"][cols[r]] for r in range(n)]
        m1 = [torch.einsum("ij,bjd->bid", w["token_w"], h1[r]) + w["token_b"][None, :, None]
              for r in range(n)]
        r1 = [a[r] + act(m1[r]) for r in range(n)]
        mean2, inv2 = _chan_stats(r1)
        xhat2 = [(r1[r] - mean2) * inv2 for r in range(n)]
        h2 = torch.cat([xhat2[r] * w["ln2_scale"][cols[r]] + w["ln2_bias"][cols[r]]
                        for r in range(n)], -1)  # gathered into every CTA
        g_m2 = torch.cat([g[..., cols[r]] * dact(h2 @ w["ch_w"][:, cols[r]] + w["ch_b"][cols[r]])
                          for r in range(n)], -1)  # each CTA its columns, then gathered
        grads["ch_w"][l] = torch.einsum("bsk,bsn->kn", h2, g_m2)  # the weight-gradient kernel
        grads["ch_b"][l] = g_m2.sum((0, 1))
        g_h2 = [g_m2 @ cw_t[:, cols[r]] for r in range(n)]

        def ln_backward(g_y, xhat, inv, scale):
            gx = [g_y[r] * scale[cols[r]] for r in range(n)]
            s1 = _ordered_sum([gx[r].sum(-1, keepdim=True) for r in range(n)]) / d
            s2 = _ordered_sum([(gx[r] * xhat[r]).sum(-1, keepdim=True) for r in range(n)]) / d
            return ([inv * (gx[r] - s1 - xhat[r] * s2) for r in range(n)],
                    torch.cat([(g_y[r] * xhat[r]).sum((0, 1)) for r in range(n)]),
                    torch.cat([g_y[r].sum((0, 1)) for r in range(n)]))

        g_ln2, grads["ln2_scale"][l], grads["ln2_bias"][l] = ln_backward(
            g_h2, xhat2, inv2, w["ln2_scale"])
        g_r1 = [g[..., cols[r]] + g_ln2[r] for r in range(n)]
        g_m1 = [g_r1[r] * dact(m1[r]) for r in range(n)]
        # each CTA's partial over its columns; the cluster adds them in CTA
        # order per sequence, the reduce kernel then over the batch
        dtw = _ordered_sum([torch.einsum("bid,bjd->bij", g_m1[r], h1[r]) for r in range(n)])
        dtb = _ordered_sum([g_m1[r].sum(-1) for r in range(n)])
        grads["token_w"][l], grads["token_b"][l] = dtw.sum(0), dtb.sum(0)
        g_h1 = [torch.einsum("ji,bjd->bid", w["token_w"], g_m1[r]) for r in range(n)]
        g_ln1, grads["ln1_scale"][l], grads["ln1_bias"][l] = ln_backward(
            g_h1, xhat1, inv1, w["ln1_scale"])
        g = torch.cat([g_r1[r] + g_ln1[r] for r in range(n)], -1)
        gemb = gemb + g.sum(1)
    return g, gemb, {k: torch.stack(v) for k, v in grads.items()}


def _backbones(seq, dim, layers, act, seed):
    jm = JTransMLP(seq_len=seq, num_layers=layers, dim=dim, act=act)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, seq, dim)),
                     jnp.zeros((1,), jnp.int32))["params"]
    params = random_normal_params(jax.device_get(params), np.random.default_rng(seed))
    tm = TransMLP(seq, layers, dim, act)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return params, tm


def _case(seq, dim, layers, b, act, seed):
    params, tm = _backbones(seq, dim, layers, act, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(b, seq, dim)).astype(np.float32)
    emb = rng.normal(size=(b, dim)).astype(np.float32)
    cot = rng.normal(size=(b, seq, dim)).astype(np.float32)
    with torch.no_grad():
        packed = k2.pack_transmlp_train_params(tm)
    return params, packed, x, emb, cot


@pytest.mark.parametrize("act", ["silu", "relu", "lrelu02"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_backward_matches_reference_f64(n, act):
    """rel <= 1e-6 of each tensor's max in float64: the split changes the
    order of the sums, nothing else."""
    _, packed, x, emb, cot = _case(35, 64, 2, 3, act, seed=10)
    packed = {k: v.double() for k, v in packed.items()}
    x, emb, cot = (torch.from_numpy(v).double() for v in (x, emb, cot))
    _, stash = k2.fused_transmlp_train_forward_reference(x, emb, packed, act)
    want = k2.fused_transmlp_train_backward_reference(stash, emb, cot, packed, act)
    got = split_backward(stash, emb, cot, packed, act, n)
    pairs = {"dx": (got[0], want[0]), "d_emb": (got[1], want[1])}
    pairs.update({k: (got[2][k], want[2][k]) for k in k2.PACKED_KEYS})
    for k, (a, ref) in pairs.items():
        assert a.shape == ref.shape, k
        rel = ((a - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-6, (k, rel)


@pytest.fixture(scope="module")
def pallas_vjp():
    """jax.vjp of the Pallas training kernel in interpret mode, once for the
    module: a ragged batch of 5 with batch tile 4, two blocks of [36, 64]."""
    seq, dim, layers, b, act = 36, 64, 2, 5, "silu"
    params, packed, x, emb, cot = _case(seq, dim, layers, b, act, seed=20)
    jp = jfused.pack_transmlp_params(params, layers)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda xx, ee, pp: jtrain.fused_transmlp_train(xx, ee, pp, act, 4),
                         jnp.asarray(x), jnp.asarray(emb), jp)
        jgx, jgemb, jgp = vjp(jnp.asarray(cot))
    ref = {"dx": np.asarray(jgx), "d_emb": np.asarray(jgemb)}
    for k in k2.PACKED_KEYS:
        v = np.asarray(jgp[k])
        ref[k] = v[:, :seq, :seq] if k == "token_w" else v[:, :seq, 0] if k == "token_b" else v
    return ref, packed, x, emb, cot, act


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_backward_matches_pallas_vjp(pallas_vjp, n):
    """The f32 mirror against jax.vjp of the Pallas kernel: rtol 1e-4 /
    atol 1e-4 of each tensor's max, the tolerance the plain versions are
    held to (f32 sums in another order over 2 blocks)."""
    ref, packed, x, emb, cot, act = pallas_vjp
    x, emb, cot = (torch.from_numpy(v) for v in (x, emb, cot))
    _, stash = k2.fused_transmlp_train_forward_reference(x, emb, packed, act)
    gx, gemb, grads = split_backward(stash, emb, cot, packed, act, n)
    got = {"dx": gx, "d_emb": gemb, **grads}
    for k, want in ref.items():
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-6), err_msg=k)


@pytest.mark.parametrize("dim,cluster", [(512, 4), (512, 8), (128, 1), (128, 2), (64, 1),
                                         (16, 1), (48, 1), (272, 4), (400, 4)])
def test_backward_shared_memory(dim, cluster):
    """The block kernel's shared memory fits one block of an H100 at every
    geometry it takes; at TED's and BEAT's width it leaves no room for a
    second block on the SM."""
    smem = k2._bwd_smem_bytes(dim, cluster)
    assert smem <= fused_mlp.SMEM_LIMIT
    dc, dp = dim // cluster, dim + 4
    floats = (smem - 512) // 4
    # the ring, the full rows (or the partial tiles) and four [36, Dc] tiles
    assert floats >= 12288 + max(36 * dp, 256 * 76) + 4 * 36 * dc
    if dim == 512:
        assert 2 * smem > fused_mlp.SM_SHARED


@pytest.mark.parametrize("b,s,d,resident,cluster", [
    (1, 35, 512, None, 8), (15, 35, 512, None, 8), (16, 35, 512, None, 4),
    (64, 36, 512, None, 4), (512, 35, 512, None, 4),
    (16, 35, 512, {8: 16, 4: 33}, 8),  # a card that holds more clusters of 8
    (3, 10, 64, None, 1), (133, 35, 128, None, 1), (5, 35, 128, None, 2),
])
def test_backward_geometry_choices(b, s, d, resident, cluster):
    """The forward's rule on the block kernel's shared memory: the largest
    cluster whose batch runs in one wave, else the widest column slices."""
    geo = k2.backward_geometry(b, s, d, resident)
    assert geo.cluster == cluster
    assert geo.cols == d // cluster
    assert geo.smem_bytes == k2._bwd_smem_bytes(d, cluster)
    assert geo.cluster in fused_mlp.cluster_sizes(d)


@pytest.mark.parametrize("b,s,d,match", [
    (4, 37, 512, "S=37"), (4, 0, 512, "S=0"), (4, 35, 520, "D=520"), (4, 35, 8, "D=8"),
    (4, 35, 1024, "D=1024"), (-1, 35, 512, "batch"),
])
def test_backward_geometry_refuses_what_the_kernel_refuses(b, s, d, match):
    with pytest.raises(ValueError, match=match):
        k2.backward_geometry(b, s, d)
