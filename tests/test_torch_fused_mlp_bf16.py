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
