"""Parity of K1's bf16 option with the JAX package: the port's plain bf16
stack (``ops.fused_mlp.fused_transmlp_bf16_reference``, what a bf16 call
runs on the CPU) against the Pallas kernel on bf16 inputs in interpret mode,
the bf16 packs, and the wrapper's dtype rules. The bf16 CUDA kernel is
held against the plain version on a card in ``test_torch_cuda.py``.

The Pallas kernel is compiled with XLA's ``xla_allow_excess_precision``
off, so that its bf16 intermediates are rounded where the kernel says (by
default XLA on the CPU may keep them in f32). The two then differ only
where a sum taken in another order moves one bf16 rounding: measured at
most 1 bf16 ulp of the element, 0.25 ulps of max|y|; held within 1 ulp of
max|y| (2^(floor(log2 max|y|) - 7)). Both are held against the f32 stack
within the JAX test's atol = rtol = 0.05 (``tests/test_pallas_kernels.py``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from livelyspeaker_tpu.models.mlp_backbone import TimestepEmbedder as JTimestepEmbedder
from livelyspeaker_tpu.models.mlp_backbone import TransMLP as JTransMLP
from livelyspeaker_tpu.ops.pallas import fused_mlp as jfused
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
from livelyspeaker_tpu_torch.ops import fused_mlp as tfused
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, random_normal_params

SEQ, DIM, LAYERS, FEATS, BATCH = 35, 64, 2, 27, 5


def _ulp_of_max(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _backbones(seq, dim, layers, seed=0, randomise=True):
    jm = JTransMLP(seq_len=seq, num_layers=layers, dim=dim)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, seq, dim)),
                                    jnp.zeros((1,), jnp.int32))["params"])
    if randomise:
        params = random_normal_params(params, np.random.default_rng(seed))
    tm = TransMLP(seq, layers, dim)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return jm, params, tm


def _pallas_bf16(x, emb, packed, out_proj=None):
    """The Pallas kernel on bf16 inputs in interpret mode, its bf16
    intermediates rounded (no excess precision); the result as f32."""
    args = (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(emb).astype(jnp.bfloat16), packed)
    with pltpu.force_tpu_interpret_mode():
        fn = jfused.fused_transmlp.lower(*args, batch_tile=16, out_proj=out_proj).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return np.asarray(fn(*args, out_proj=out_proj).astype(jnp.float32))


@pytest.mark.parametrize("fold_ln2", [False, True], ids=["ln2_affine", "ln2_folded"])
@pytest.mark.parametrize("with_out", [False, True], ids=["out_D", "out_F"])
def test_plain_bf16_matches_pallas(fold_ln2, with_out):
    rng = np.random.default_rng(1)
    _, params, tm = _backbones(SEQ, DIM, LAYERS, seed=3)
    x = rng.normal(size=(BATCH, SEQ, DIM)).astype(np.float32)
    emb = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    lin = torch.nn.Linear(DIM, FEATS)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.normal(size=(FEATS, DIM)) / np.sqrt(DIM)))
        lin.bias.copy_(torch.from_numpy(0.1 * rng.normal(size=FEATS)))

    jp = jfused.pack_transmlp_params(params, LAYERS, dtype=jnp.bfloat16, fold_ln2=fold_ln2)
    jout = (jfused.pack_out_proj(jnp.asarray(lin.weight.detach().numpy().T),
                                 jnp.asarray(lin.bias.detach().numpy()), dtype=jnp.bfloat16)
            if with_out else None)
    ref = _pallas_bf16(x, emb, jp, jout)
    if with_out:
        ref = ref[..., :FEATS]

    tp = tfused.pack_transmlp_params(tm, fold_ln2=fold_ln2, dtype=torch.bfloat16)
    tout = tfused.pack_out_proj(lin, dtype=torch.bfloat16) if with_out else None
    calls = tfused.fused_transmlp_reference.calls
    out = tfused.fused_transmlp(torch.from_numpy(x).bfloat16(), torch.from_numpy(emb).bfloat16(),
                                tp, out_proj=tout)
    assert tfused.fused_transmlp_reference.calls == calls + 1  # CPU -> plain
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= _ulp_of_max(ref), (err, _ulp_of_max(ref))


def test_bf16_stack_within_the_f32_tolerance():
    """As the JAX package's bf16 test: its init, D=128, L=2; the port's
    plain bf16 stack and the Pallas kernel both within atol = rtol = 0.05 of
    the f32 Flax stack."""
    jm, params, tm = _backbones(35, 128, 2, randomise=False)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 35, 128)).astype(np.float32)
    t = np.array([0, 10, 500, 999])
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    emb = np.asarray(JTimestepEmbedder(128).apply({"params": params["embed_timestep"]},
                                                  jnp.asarray(t)))
    pallas = _pallas_bf16(x, emb, jfused.pack_transmlp_params(params, 2, dtype=jnp.bfloat16))
    port = tfused.fused_transmlp(torch.from_numpy(x).bfloat16(), torch.from_numpy(emb).bfloat16(),
                                 tfused.pack_transmlp_params(tm, dtype=torch.bfloat16))
    for out in (pallas, port.float().numpy()):
        np.testing.assert_allclose(out, ref, atol=0.05, rtol=0.05)


@pytest.mark.parametrize("fold_ln2", [False, True], ids=["ln2_affine", "ln2_folded"])
def test_bf16_pack(fold_ln2):
    """bf16 token and channel mixes (the channel mix [L, D_out, D_in]), the
    fold done in f32 before the rounding; LayerNorm parameters and biases
    f32 and equal to the f32 pack's."""
    _, _, tm = _backbones(SEQ, DIM, LAYERS, seed=4)
    p32 = tfused.pack_transmlp_params(tm, fold_ln2=fold_ln2)
    p16 = tfused.pack_transmlp_params(tm, fold_ln2=fold_ln2, dtype=torch.bfloat16)
    assert sorted(p16) == sorted(p32)
    for k in p32:
        if k in ("token_w", "ch_w"):
            assert p16[k].dtype == torch.bfloat16 and p16[k].is_contiguous()
        else:
            assert p16[k].dtype == torch.float32 and torch.equal(p16[k], p32[k]), k
    assert torch.equal(p16["token_w"], p32["token_w"].bfloat16())
    assert torch.equal(p16["ch_w"], p32["ch_w"].transpose(1, 2).bfloat16())
    lin = torch.nn.Linear(DIM, FEATS)
    o16 = tfused.pack_out_proj(lin, dtype=torch.bfloat16)
    assert o16["out_w"].shape == (FEATS, DIM) and o16["out_w"].dtype == torch.bfloat16
    assert o16["out_b"].dtype == torch.float32
    with pytest.raises(TypeError, match="float16"):
        tfused.pack_transmlp_params(tm, dtype=torch.float16)


def test_wrapper_refuses_mixed_and_other_dtypes():
    """On any device: a mix of f32 and bf16 tensors, or f16, raises naming
    the tensor; the plain version is not run."""
    _, _, tm = _backbones(SEQ, DIM, 1, seed=5)
    p32 = tfused.pack_transmlp_params(tm)
    p16 = tfused.pack_transmlp_params(tm, dtype=torch.bfloat16)
    x = torch.zeros(2, SEQ, DIM)
    emb = torch.zeros(2, DIM)
    calls = tfused.fused_transmlp_reference.calls
    cases = [
        ((x.bfloat16(), emb, p16), "emb is torch.float32 and x is torch.bfloat16"),
        ((x.bfloat16(), emb.bfloat16(), p32), "token_w is torch.float32"),
        ((x, emb, p16), "token_w is torch.bfloat16 and x is torch.float32"),
        ((x.half(), emb.half(), p16), "x is torch.float16"),
        ((x.bfloat16(), emb.bfloat16(), {**p16, "ch_b": p16["ch_b"].bfloat16()}),
         "ch_b is torch.bfloat16"),
    ]
    for args, msg in cases:
        with pytest.raises(TypeError, match=msg):
            tfused.fused_transmlp(*args)
    lin = torch.nn.Linear(DIM, FEATS)
    with pytest.raises(TypeError, match="out_w is torch.float32"):
        tfused.fused_transmlp(x.bfloat16(), emb.bfloat16(), p16, out_proj=tfused.pack_out_proj(lin))
    assert tfused.fused_transmlp_reference.calls == calls


# transmlp_bf16_geometry's choice on an H100 SXM's resident clusters, by 2B
BF16_GEOMETRY = {1: (8, 1), 2: (8, 1), 15: (8, 1), 16: (4, 1), 64: (2, 1), 512: (2, 2),
                 1024: (2, 2)}


@pytest.mark.parametrize("seq", [35, 36], ids=["TED", "BEAT"])
@pytest.mark.parametrize("b2", sorted(BF16_GEOMETRY))
def test_bf16_geometry_choice(seq, b2):
    """The bf16 kernel's (cluster, group) at TED's and BEAT's D = 512: the
    batch covered by whole clusters, the channel mix's wgmma N of 40 rows a
    sequence a warpgroup, the shared memory within an H100's."""
    geo = tfused.transmlp_bf16_geometry(b2, seq, 512)
    assert (geo.cluster, geo.group) == BF16_GEOMETRY[b2]
    assert geo.cols == 512 // geo.cluster and geo.clusters == -(-b2 // geo.group)
    assert geo.wgmma_n == (40 * geo.group if geo.cols > 64 else 40)
    assert 2 <= geo.stages <= 8 and geo.smem_bytes <= tfused.SMEM_LIMIT


@pytest.mark.parametrize("dim", [16, 48, 64, 128, 272, 400, 512])
def test_bf16_geometry_shared_memory_fits(dim):
    """Every (cluster, group) the bf16 kernel takes at width D fits an H100
    block's shared memory with at least two ring stages; the cluster sizes
    keep Dc a multiple of 4 and at most 256."""
    sizes = tfused.bf16_cluster_sizes(dim)
    assert sizes and all(dim % (4 * n) == 0 and dim // n <= 256 for n in sizes)
    for n in sizes:
        for g in tfused.BF16_GROUPS:
            geo = tfused._bf16_geometry(16, dim, n, g)
            assert geo.smem_bytes <= tfused.SMEM_LIMIT and geo.stages >= 2, (n, g, geo)
    assert tfused.transmlp_bf16_geometry(16, 35, dim).cluster in sizes


def test_bf16_cluster_sizes():
    assert tfused.bf16_cluster_sizes(512) == [8, 4, 2]
    assert tfused.bf16_cluster_sizes(272) == [4, 2]
    assert tfused.bf16_cluster_sizes(64) == [8, 4, 2, 1]
    assert tfused.bf16_cluster_sizes(48) == [4, 2, 1]


@pytest.mark.parametrize("b,s,d,match", [
    (-1, 35, 512, "batch"),
    (2, 0, 512, "S=0"),
    (2, 37, 512, "S=37"),
    (2, 35, 8, "D=8"),
    (2, 35, 520, "D=520"),
    (2, 35, 200, "D=200"),
])
def test_bf16_geometry_refuses_what_the_kernel_refuses(b, s, d, match):
    with pytest.raises(ValueError, match=match):
        tfused.transmlp_bf16_geometry(b, s, d)


def test_k1_bf16_counts_the_weight_reads_a_call():
    """k1_bf16.py's L2 weight reads a call: every cluster reads all of
    ``ch_w`` and ``out_w``. At TED 2B = 512 that is 2.16 GB with one CTA a
    sequence, and half with two sequences a cluster."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import k1_bf16

    packed = {"ch_w": torch.empty(8, 512, 512, dtype=torch.bfloat16)}
    op = {"out_w": torch.empty(27, 512, dtype=torch.bfloat16)}
    one = k1_bf16.weight_bytes(512, packed, op)
    assert one == 512 * (8 * 512 * 512 + 27 * 512) * 2 and round(one / 1e9, 2) == 2.16
    geo = tfused.transmlp_bf16_geometry(512, 35, 512)
    assert geo.group == 2 and k1_bf16.weight_bytes(geo.clusters, packed, op) * 2 == one


def test_k1_bf16_phase_anchors_match_the_kernel():
    """k1_bf16.py --phases patches the kernel's source by text: every
    anchor is found once, and the patched source differs."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import k1_bf16

    src = (k1_bf16.CSRC_DIR / "fused_transmlp_bf16.cu").read_text()
    for anchor, _ in k1_bf16.PATCHES:
        assert src.count(anchor) == 1, anchor
    assert "k1_bf16_set_prof" in k1_bf16.instrumented_source()
    assert len(k1_bf16.PHASES) == 16
