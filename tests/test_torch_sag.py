"""Parity of the port's SAG stage with the JAX package, at small widths:
the attention, the post-LN encoder and decoder layers and stacks, the SAG
encoder, decoder and autoencoder (TED 9x3, BEAT 47x6), ``sag_losses``, the
released-format converter, the weight bridge both ways and the fresh init.

The Flax parameters are replaced with seeded normals of unit-fan-in scale
and carried over by the weight bridge; inputs come from a seeded numpy
generator. rel = max|port - jax| / max|jax|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.models import sag as jsag
from livelyspeaker_tpu.models import transformer as jtr
from livelyspeaker_tpu.utils.torch_convert import sag_params_from_torch_state_dict
from livelyspeaker_tpu_torch.models import (
    SAG,
    MultiHeadAttention,
    SAGDecoder,
    SAGEncoder,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
    sag_losses,
)
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    random_normal_params,
    sag_state_dict_from_reference,
    state_dict_to_jax_params,
)

TOL = 1e-5
D, FF, HEADS, T = 64, 128, 4, 34
VARIANTS = {"ted": (9, 3), "beat": (47, 6)}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _bridge(jmodule, tmodule, *init_args, seed=0):
    """Flax init, reseeded with numpy normals, loaded into the port
    (strict); returns the params tree."""
    params = jmodule.init(jax.random.PRNGKey(seed), *init_args)["params"]
    params = random_normal_params(jax.device_get(params), np.random.default_rng(seed + 50))
    tmodule.load_state_dict(jax_params_to_state_dict(params))
    tmodule.eval()
    return params


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _padding_mask(b, n, masked):
    """[B, n] True = valid, ``masked[i]`` False in row i."""
    m = np.ones((b, n), bool)
    m[np.arange(b), masked] = False
    return m


@pytest.mark.parametrize("padding", [False, True], ids=["no_padding", "padding"])
@pytest.mark.parametrize("additive", [False, True], ids=["no_attn_mask", "attn_mask"])
def test_multihead_attention_matches_jax(padding, additive):
    rng = np.random.default_rng(1)
    b, lq, lk = 3, 7, 5
    q, k, v = _normal(rng, b, lq, D), _normal(rng, b, lk, D), _normal(rng, b, lk, D)
    jm, tm = jtr.MultiHeadAttention(D, HEADS), MultiHeadAttention(D, HEADS)
    params = _bridge(jm, tm, q, k, v)
    kw_np = {}
    if padding:  # one key masked per row
        kw_np["key_padding_mask"] = _padding_mask(b, lk, rng.integers(0, lk, size=b))
    if additive:
        kw_np["attn_mask"] = _normal(rng, lq, lk)
    ref = jm.apply({"params": params}, q, k, v, **{n: jnp.asarray(a) for n, a in kw_np.items()})
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (q, k, v)),
                 **{n: torch.from_numpy(a) for n, a in kw_np.items()})
    assert rel(out.numpy(), ref) <= TOL


def test_cross_attention_to_one_key_matches_jax():
    """The SAG decoder's cross-attention: a 1-token memory."""
    rng = np.random.default_rng(2)
    q, mem = _normal(rng, 3, T, D), _normal(rng, 3, 1, D)
    jm, tm = jtr.MultiHeadAttention(D, HEADS), MultiHeadAttention(D, HEADS)
    params = _bridge(jm, tm, q, mem, mem)
    ref = jm.apply({"params": params}, q, mem, mem)
    with torch.no_grad():
        out = tm(torch.from_numpy(q), torch.from_numpy(mem), torch.from_numpy(mem))
    assert rel(out.numpy(), ref) <= TOL


def _layer_case(kind, act):
    """(flax module, port module, positional inputs, keyword masks) of one
    layer or stack, with one padded key a row on each masked input."""
    rng = np.random.default_rng(3)
    b, n, m = 3, 10, 4
    src, mem = _normal(rng, b, n, D), _normal(rng, b, m, D)
    src_mask = _padding_mask(b, n, rng.integers(0, n, size=b))
    mem_mask = _padding_mask(b, m, rng.integers(0, m, size=b))
    if kind == "encoder_layer":
        pair = (jtr.TransformerEncoderLayer(D, HEADS, FF, activation=act),
                TransformerEncoderLayer(D, HEADS, FF, activation=act))
    elif kind == "decoder_layer":
        pair = (jtr.TransformerDecoderLayer(D, HEADS, FF, activation=act),
                TransformerDecoderLayer(D, HEADS, FF, activation=act))
    elif kind == "encoder":
        pair = (jtr.TransformerEncoder(2, D, HEADS, FF, activation=act),
                TransformerEncoder(2, D, HEADS, FF, activation=act))
    else:
        pair = (jtr.TransformerDecoder(2, D, HEADS, FF, activation=act),
                TransformerDecoder(2, D, HEADS, FF, activation=act))
    if kind.startswith("encoder"):
        return pair, (src,), {"key_padding_mask": src_mask}
    return pair, (src, mem), {"tgt_key_padding_mask": src_mask,
                              "memory_key_padding_mask": mem_mask}


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("kind", ["encoder_layer", "decoder_layer", "encoder", "decoder"])
def test_transformer_layers_match_jax(kind, act):
    (jm, tm), args, masks = _layer_case(kind, act)
    params = _bridge(jm, tm, *args)
    ref = jm.apply({"params": params}, *args, **{k: jnp.asarray(v) for k, v in masks.items()})
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, args), **{k: torch.from_numpy(v) for k, v in masks.items()})
    assert rel(out.numpy(), ref) <= TOL


def test_gelu_is_the_tanh_approximation():
    """A layer on pre-activations near 1 tells Flax's tanh gelu from
    torch's exact one: with the exact gelu the port would miss the bound."""
    (jm, tm), args, masks = _layer_case("encoder_layer", "gelu")
    params = _bridge(jm, tm, *args)
    ref = jm.apply({"params": params}, *args, **{k: jnp.asarray(v) for k, v in masks.items()})
    tm.act = lambda x: torch.nn.functional.gelu(x)  # exact erf
    with torch.no_grad():
        exact = tm(*map(torch.from_numpy, args), **{k: torch.from_numpy(v) for k, v in masks.items()})
    assert rel(exact.numpy(), ref) > 10 * TOL


def _sag_inputs(variant, b=3):
    nj, nf = VARIANTS[variant]
    rng = np.random.default_rng(4)
    x = _normal(rng, b, nj, nf, T)
    mask = np.ones((b, T), bool)
    mask[:, -3:] = False  # the last 3 frames are padding
    z = _normal(rng, b, D)
    return x, mask, z


def _sag_pair(variant, cls_j, cls_t, **kw):
    nj, nf = VARIANTS[variant]
    kw = dict(njoints=nj, nfeats=nf, latent_dim=D, ff_size=FF, num_layers=2,
              num_heads=HEADS, **kw)
    return cls_j(**kw), cls_t(**kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sag_encoder_matches_jax(variant):
    x, mask, _ = _sag_inputs(variant)
    jm, tm = _sag_pair(variant, jsag.SAGEncoder, SAGEncoder)
    params = _bridge(jm, tm, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))["mu"]
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask))["mu"]
    assert rel(out.numpy(), ref) <= TOL
    with torch.no_grad():  # the padding changes mu: the mask reaches the attention
        assert not torch.allclose(out, tm(torch.from_numpy(x))["mu"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sag_decoder_matches_jax(variant):
    x, mask, z = _sag_inputs(variant)
    jm, tm = _sag_pair(variant, jsag.SAGDecoder, SAGDecoder)
    params = _bridge(jm, tm, jnp.asarray(z), jnp.asarray(x))
    for m in (None, mask):
        ref = jm.apply({"params": params}, jnp.asarray(z), jnp.asarray(x),
                       None if m is None else jnp.asarray(m))
        with torch.no_grad():
            out = tm(torch.from_numpy(z), torch.from_numpy(x),
                     None if m is None else torch.from_numpy(m))
        assert rel(out.numpy(), ref) <= TOL
    assert torch.all(out[..., -3:] == 0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sag_autoencoder_matches_jax(variant):
    x, mask, z = _sag_inputs(variant)
    jm, tm = _sag_pair(variant, jsag.SAG, SAG)
    params = _bridge(jm, tm, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask))
        enc = tm.encode(torch.from_numpy(x), torch.from_numpy(mask))
        dec = tm.decode(torch.from_numpy(z), torch.from_numpy(x))
    for k in ("z", "output"):
        assert rel(out[k].numpy(), ref[k]) <= TOL, k
    torch.testing.assert_close(enc, out["z"], rtol=0, atol=0)
    ref_dec = jm.apply({"params": params}, jnp.asarray(z), jnp.asarray(x), method=jm.decode)
    assert rel(dec.numpy(), ref_dec) <= TOL


def test_sag_losses_match_jax():
    rng = np.random.default_rng(5)
    x, out = _normal(rng, 3, 9, 3, T), _normal(rng, 3, 9, 3, T)
    z, text = _normal(rng, 3, D), _normal(rng, 3, D)
    ref = jsag.sag_losses(*map(jnp.asarray, (x, out, z, text)), lam_cos=0.7)
    got = sag_losses(*map(torch.from_numpy, (x, out, z, text)), lam_cos=0.7)
    assert set(got) == set(ref) == {"xyz_loss", "vel_loss", "clip_loss", "cos_sim", "sum"}
    for k in ref:
        assert abs(got[k].item() - float(ref[k])) <= TOL * abs(float(ref[k])), k


def _reference_sag_state_dict(nj, nf, layers, rng):
    """A state_dict with the released SAG's key names (MotionCLIP: stock
    torch transformer layers under seqTransEncoder/seqTransDecoder) and
    seeded random values of unit-fan-in scale."""
    enc = torch.nn.TransformerEncoder(
        torch.nn.TransformerEncoderLayer(D, HEADS, FF), layers, enable_nested_tensor=False)
    dec = torch.nn.TransformerDecoder(torch.nn.TransformerDecoderLayer(D, HEADS, FF), layers)
    shapes = {"encoder.muQuery": (1, D), "encoder.sigmaQuery": (1, D),
              "encoder.skelEmbedding.weight": (D, nj * nf), "encoder.skelEmbedding.bias": (D,),
              "decoder.mapping.weight": (D, nj * nf + 1), "decoder.mapping.bias": (D,),
              "decoder.finallayer.weight": (nj * nf, D), "decoder.finallayer.bias": (nj * nf,)}
    shapes.update({f"encoder.seqTransEncoder.{k}": tuple(v.shape)
                   for k, v in enc.state_dict().items()})
    shapes.update({f"decoder.seqTransDecoder.{k}": tuple(v.shape)
                   for k, v in dec.state_dict().items()})
    sd = {}
    for k, shape in shapes.items():
        std = 1.0 / np.sqrt(shape[1]) if len(shape) == 2 else 0.1
        sd[k] = torch.from_numpy((std * rng.normal(size=shape)).astype(np.float32))
        if k.rsplit(".", 2)[-2].startswith("norm") and k.endswith("weight"):
            sd[k] = 1.0 + sd[k]
    sd["clip_model.logit_scale"] = torch.ones(())  # outside the SAG: ignored
    return sd


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_released_sag_state_dict_converts_like_jax(variant):
    """The reference-format state_dict, through the JAX converter into Flax
    and through the port's into the port: the same forward."""
    nj, nf = VARIANTS[variant]
    sd = _reference_sag_state_dict(nj, nf, 2, np.random.default_rng(6))
    jm, tm = _sag_pair(variant, jsag.SAG, SAG)
    tm.load_state_dict(sag_state_dict_from_reference(sd, num_layers=2))
    tm.eval()
    params = sag_params_from_torch_state_dict(sd, num_layers=2)
    x, mask, _ = _sag_inputs(variant)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask))
    for k in ("z", "output"):
        assert rel(out[k].numpy(), ref[k]) <= TOL, k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_weight_bridge_round_trips_the_sag_tree():
    """JAX params -> state_dict -> JAX params gives the same tree, bit for
    bit; the packed in_proj_weight [3D, D] and the [1, D] queries keep
    their layout."""
    x, _, _ = _sag_inputs("ted")
    jm, tm = _sag_pair("ted", jsag.SAG, SAG)
    params = _bridge(jm, tm, jnp.asarray(x))
    sd = jax_params_to_state_dict(params)
    w = params["decoder"]["decoder"]["layer_0"]["multihead_attn"]["in_proj_weight"]
    np.testing.assert_array_equal(
        sd["decoder.decoder.layer_0.multihead_attn.in_proj_weight"].numpy(), w)
    np.testing.assert_array_equal(sd["encoder.mu_query"].numpy(), params["encoder"]["mu_query"])
    back, orig = _flat(state_dict_to_jax_params(tm.state_dict(), tm)), _flat(params)
    assert set(back) == set(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


def assert_init_matches_flax(flax_params, module):
    """The port's fresh init has the Flax init's distribution, leaf by
    leaf: the same zeros and ones, the std within the sampling error of two
    draws, and (for large leaves) the same kurtosis, which tells a uniform
    (1.8) from a normal cut at 2 sigma (2.37) and an uncut one (3)."""
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.array, flax_params))
    own = {k: v.detach() for k, v in module.state_dict().items()}
    assert set(own) == set(ref)
    kurtosis = lambda a: (((a - a.mean()) / a.std()) ** 4).mean().item()
    for k, r in ref.items():
        r, o = r.double(), own[k].double()
        assert o.shape == r.shape, k
        if torch.all(r == r.flatten()[0]):  # zeros and LayerNorm ones
            assert torch.equal(o, r), k
            continue
        n = r.numel()
        assert abs(o.std().item() / r.std().item() - 1) < 5 / np.sqrt(n) + 0.02, k
        assert abs(o.mean().item()) < 5 * r.std().item() / np.sqrt(n), k
        if n >= 8192:
            assert abs(kurtosis(o) - kurtosis(r)) < 0.3, (k, kurtosis(o), kurtosis(r))


@pytest.mark.parametrize("which", ["attention", "encoder_layer", "decoder_layer", "encoder",
                                   "decoder", "sag_encoder", "sag_decoder", "sag_ted",
                                   "sag_beat"])
def test_fresh_init_matches_flax_statistics(which):
    """Lecun-normal Dense kernels, xavier-uniform in_proj_weight, normal(1)
    queries, zero biases and unit LayerNorm scales, from a seeded
    generator; a second generator of the same seed gives the same weights."""
    g = lambda: torch.Generator().manual_seed(0)
    x = jnp.zeros((2, 12, D))
    layers = {"encoder_layer": (jtr.TransformerEncoderLayer, TransformerEncoderLayer, ()),
              "decoder_layer": (jtr.TransformerDecoderLayer, TransformerDecoderLayer, ()),
              "encoder": (jtr.TransformerEncoder, TransformerEncoder, (2,)),
              "decoder": (jtr.TransformerDecoder, TransformerDecoder, (2,))}
    if which == "attention":
        jm, make = jtr.MultiHeadAttention(D, HEADS), lambda: MultiHeadAttention(D, HEADS, g())
        args = (x, x, x)
    elif which in layers:
        jcls, cls, stack = layers[which]
        jm, make = jcls(*stack, D, HEADS, FF), lambda: cls(*stack, D, HEADS, FF, generator=g())
        args = (x,) if which.startswith("encoder") else (x, x[:, :1])
    elif which in ("sag_encoder", "sag_decoder"):
        jcls, cls = ((jsag.SAGEncoder, SAGEncoder) if which == "sag_encoder"
                     else (jsag.SAGDecoder, SAGDecoder))
        kw = dict(latent_dim=D, ff_size=FF, num_layers=2, num_heads=HEADS)
        jm, make = jcls(**kw), lambda: cls(**kw, generator=g())
        motion = jnp.zeros((2, 9, 3, T))
        args = (motion,) if which == "sag_encoder" else (jnp.zeros((2, D)), motion)
    else:
        variant = which.split("_")[1]
        jm, _ = _sag_pair(variant, jsag.SAG, SAG)
        nj, nf = VARIANTS[variant]
        make = lambda: SAG(njoints=nj, nfeats=nf, latent_dim=D, ff_size=FF, num_layers=2,
                           num_heads=HEADS, generator=g())
        args = (jnp.zeros((2, nj, nf, T)),)
    flax_params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    module = make()
    assert_init_matches_flax(flax_params, module)
    again = make().state_dict()
    for k, v in module.state_dict().items():
        assert torch.equal(v, again[k]), k
