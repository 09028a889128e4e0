"""Parity of the port's training stack (K2's plain versions and its
autograd Function) with the JAX package and with torch autograd.

The Pallas training kernel runs in interpret mode on the CPU, on a ragged
batch of 5 with batch tile 4; the CUDA kernels are held against the plain
versions on a card in ``test_torch_cuda.py``.
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

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _backbones(seq, dim, layers, act, seed=0):
    jm = JTransMLP(seq_len=seq, num_layers=layers, dim=dim, act=act)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, seq, dim)),
                     jnp.zeros((1,), jnp.int32))["params"]
    params = random_normal_params(jax.device_get(params), np.random.default_rng(seed))
    tm = TransMLP(seq, layers, dim, act)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return params, tm


def _packed(tm):
    with torch.no_grad():
        return k2.pack_transmlp_train_params(tm)


@pytest.mark.parametrize("seq,dim,act", [
    (35, 128, "silu"), (36, 64, "silu"), (35, 64, "relu"), (36, 64, "lrelu02"),
])
def test_plain_versions_match_pallas_vjp(seq, dim, act):
    """Forward, stash and every gradient of the plain versions against
    jax.vjp of the Pallas kernel (interpret mode). rtol 1e-4 / atol 1e-4 of
    each tensor's max: f32 sums in another order over 2 blocks."""
    layers, b = 2, 5
    params, tm = _backbones(seq, dim, layers, act, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(b, seq, dim)).astype(np.float32)
    emb = rng.normal(size=(b, dim)).astype(np.float32)
    cot = rng.normal(size=(b, seq, dim)).astype(np.float32)

    jp = jfused.pack_transmlp_params(params, layers)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda xx, ee, pp: jtrain.fused_transmlp_train(xx, ee, pp, act, 4),
                         jnp.asarray(x), jnp.asarray(emb), jp)
        jgx, jgemb, jgp = vjp(jnp.asarray(cot))
        _, (jstash, *_) = jtrain._fwd_impl(jnp.asarray(x), jnp.asarray(emb), jp, act, 4)
    jstash = np.asarray(jstash)[:, :seq, :b].transpose(0, 2, 1, 3)  # -> [L, B, S, D]

    tp = _packed(tm)
    calls = (k2.fused_transmlp_train_forward_reference.calls,
             k2.fused_transmlp_train_backward_reference.calls)
    out, stash = k2.fused_transmlp_train_forward(torch.from_numpy(x), torch.from_numpy(emb), tp, act)
    gx, gemb, grads = k2.fused_transmlp_train_backward(
        stash, torch.from_numpy(emb), torch.from_numpy(cot), tp, act)
    assert (k2.fused_transmlp_train_forward_reference.calls,
            k2.fused_transmlp_train_backward_reference.calls) == (calls[0] + 1, calls[1] + 1)

    def close(a, ref, name):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-6), err_msg=name)

    close(out, y, "out")
    close(stash, jstash, "stash")
    close(gx, jgx, "dx")
    close(gemb, jgemb, "d_emb")
    for k in k2.PACKED_KEYS:
        ref = np.asarray(jgp[k])
        if k == "token_w":
            ref = ref[:, :seq, :seq]
        elif k == "token_b":
            ref = ref[:, :seq, 0]
        close(grads[k], ref, k)


@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
def test_fused_backbone_matches_eager_autograd(act):
    """TransMLP(fused_vjp=True) against autograd of the eager stack: loss,
    the input gradient and the gradient of every parameter (the
    differentiable packing reaches every block_i parameter)."""
    seq, dim, layers = 35, 64, 2
    _, eager = _backbones(seq, dim, layers, act, seed=3)
    fused = TransMLP(seq, layers, dim, act, fused_vjp=True)
    fused.load_state_dict(eager.state_dict())
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(4, seq, dim)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=(4,)))
    w = torch.from_numpy(rng.normal(size=(4, seq, dim)).astype(np.float32))
    res = []
    for m in (eager, fused):
        xx = x.clone().requires_grad_(True)
        loss = (m(xx, t) * w).sum()
        params = dict(m.named_parameters())
        grads = torch.autograd.grad(loss, [xx] + list(params.values()))
        res.append((loss.item(), dict(zip(["x"] + list(params), grads))))
    (le, ge), (lf, gf) = res
    assert abs(lf - le) <= 1e-5 * abs(le)
    assert set(gf) == set(ge)
    for k in ge:
        assert gf[k] is not None and float(gf[k].abs().max()) > 0, k
        np.testing.assert_allclose(gf[k].numpy(), ge[k].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(ge[k].abs().max()), err_msg=k)


def test_function_gradcheck_float64():
    """Finite differences of the Function (plain versions on the CPU)."""
    _, tm = _backbones(6, 16, 2, "silu", seed=5)
    tm = tm.double()
    packed = {k: v.detach().clone().requires_grad_(True) for k, v in _packed(tm).items()}
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3, 6, 16, dtype=torch.float64, generator=g, requires_grad=True)
    e = torch.randn(3, 16, dtype=torch.float64, generator=g, requires_grad=True)
    f = lambda xx, ee, *ws: k2.fused_transmlp_train(xx, ee, dict(zip(k2.PACKED_KEYS, ws)))
    assert torch.autograd.gradcheck(f, (x, e, *[packed[k] for k in k2.PACKED_KEYS]))


def test_no_grad_call_is_the_stash_free_stack():
    """Without autograd the call is the plain forward; the eager stack
    gives the same output."""
    _, tm = _backbones(35, 64, 2, "silu", seed=7)
    fused = TransMLP(35, 2, 64, "silu", fused_vjp=True)
    fused.load_state_dict(tm.state_dict())
    x = torch.randn(3, 35, 64, generator=torch.Generator().manual_seed(8))
    t = torch.tensor([3, 500, 999])
    with torch.no_grad():
        calls = k2.fused_transmlp_train_forward_reference.calls
        out = fused(x, t)
        assert k2.fused_transmlp_train_forward_reference.calls == calls + 1
        np.testing.assert_allclose(out.numpy(), tm(x, t).numpy(), rtol=1e-5, atol=1e-5)


def test_gelu_and_bf16_raise():
    _, tm = _backbones(35, 64, 1, "gelu")
    x, e = torch.zeros(2, 35, 64), torch.zeros(2, 64)
    with pytest.raises(ValueError, match="gelu"):
        k2.fused_transmlp_train(x, e, _packed(tm), "gelu")
    fused = TransMLP(35, 1, 64, "gelu", fused_vjp=True)
    with pytest.raises(ValueError, match="gelu"):
        fused(x, torch.zeros(2, dtype=torch.long))
    # bf16 is not refused: the stack runs in f32 on the bf16 values and
    # returns bf16, as the JAX kernel does (test_torch_measure.py holds it
    # against the JAX kernel)
    _, tm = _backbones(35, 64, 1, "silu")
    xb = torch.randn(2, 35, 64, generator=torch.Generator().manual_seed(9)).to(torch.bfloat16)
    eb = torch.randn(2, 64, generator=torch.Generator().manual_seed(10)).to(torch.bfloat16)
    out = k2.fused_transmlp_train(xb, eb, _packed(tm), "silu")
    assert out.dtype == torch.bfloat16
    want = k2.fused_transmlp_train(xb.float(), eb.float(), _packed(tm), "silu")
    assert torch.equal(out, want.to(torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel"):
        k2.fused_transmlp_train_forward(x.to("meta"), e.to("meta"), _packed(tm))


def test_sampler_packing_stays_no_grad():
    """The sampler's packing cuts the graph; the training packing keeps it."""
    from livelyspeaker_tpu_torch.ops.fused_mlp import pack_transmlp_params

    _, tm = _backbones(35, 64, 1, "silu")
    assert not any(v.requires_grad for v in pack_transmlp_params(tm).values())
    assert all(v.requires_grad for v in k2.pack_transmlp_train_params(tm).values())
