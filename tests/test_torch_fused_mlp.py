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
