"""Parity of the port's text front end with the JAX package: the CLIP text
tower (width 64, 2 layers) on the same seeded weights, the released-format
converter, the weight bridge both ways, the fresh init, and the two
tokenizers, bit for bit.

rel = max|port - jax| / max|jax|.
"""

import gzip

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.data import clip_tokenizer as jtok
from livelyspeaker_tpu.models import clip_text as jclip
from livelyspeaker_tpu_torch.data import clip_tokenizer as ttok
from livelyspeaker_tpu_torch.models import CLIPTextConfig, CLIPTextEncoder, quick_gelu
from livelyspeaker_tpu_torch.utils.convert import (
    clip_text_state_dict_from_openai,
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)

from test_torch_sag import (  # noqa: F401 (_no_tf32: autouse fixture)
    _bridge,
    _flat,
    _no_tf32,
    assert_init_matches_flax,
    rel,
)

TOL = 1e-5
SMALL = dict(vocab_size=49408, context_length=77, width=64, layers=2, heads=4, embed_dim=64)
SENTENCES = [
    "Hello there.",
    'A person is talking: "we should go to the market before it closes tonight"',
    "  The   weather,  TODAY,\tis quite &amp; surprisingly warm!  ",
]


def _pair(seed=0):
    """The Flax tower and its port on the same randomised weights."""
    jm = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**SMALL))
    tm = CLIPTextEncoder(CLIPTextConfig(**SMALL))
    params = _bridge(jm, tm, jnp.zeros((1, 77), jnp.int32), seed=seed)
    return jm, params, tm


def test_clip_text_encoder_matches_jax():
    """HashTokenizer ids of three sentences of different lengths: the EOT
    sits at a different position in each row."""
    tokens = jtok.HashTokenizer()(SENTENCES)
    assert len(set(np.argmax(tokens, axis=-1))) == 3
    jm, params, tm = _pair()
    ref = jm.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens))
        out64 = tm(torch.from_numpy(tokens).long())
    assert out.shape == (3, 64)
    assert rel(out.numpy(), ref) <= TOL
    torch.testing.assert_close(out, out64, rtol=0, atol=0)


def test_quick_gelu_matches_jax():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def _openai_state_dict(rng, layers=2, dtype=torch.float32):
    """A state_dict with OpenAI CLIP's key names (the text tower of
    ``clip.model.CLIP``, and two vision keys) and seeded random values."""
    w, v, n = SMALL["width"], SMALL["vocab_size"], SMALL["context_length"]
    shapes = {"token_embedding.weight": (v, w), "positional_embedding": (n, w),
              "text_projection": (w, SMALL["embed_dim"]), "ln_final.weight": (w,),
              "ln_final.bias": (w,), "logit_scale": (), "visual.proj": (w, w)}
    for i in range(layers):
        pre = f"transformer.resblocks.{i}"
        shapes.update({
            f"{pre}.ln_1.weight": (w,), f"{pre}.ln_1.bias": (w,),
            f"{pre}.attn.in_proj_weight": (3 * w, w), f"{pre}.attn.in_proj_bias": (3 * w,),
            f"{pre}.attn.out_proj.weight": (w, w), f"{pre}.attn.out_proj.bias": (w,),
            f"{pre}.ln_2.weight": (w,), f"{pre}.ln_2.bias": (w,),
            f"{pre}.mlp.c_fc.weight": (4 * w, w), f"{pre}.mlp.c_fc.bias": (4 * w,),
            f"{pre}.mlp.c_proj.weight": (w, 4 * w), f"{pre}.mlp.c_proj.bias": (w,),
        })
    sd = {}
    for k, shape in shapes.items():
        std = 1.0 / np.sqrt(shape[-1]) if len(shape) == 2 else 0.1
        a = std * rng.normal(size=shape)
        if ".ln_" in k or k.startswith("ln_"):
            a = a + (k.endswith("weight"))
        sd[k] = torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["f32", "f16"])
def test_openai_state_dict_converts_like_jax(dtype):
    """The OpenAI-format state_dict (f32, or the released f16), through the
    JAX converter into Flax and through the port's into the port."""
    sd = _openai_state_dict(np.random.default_rng(3), dtype=dtype)
    jm = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**SMALL))
    params = jclip.clip_text_params_from_torch(sd, layers=2)
    tm = CLIPTextEncoder(CLIPTextConfig(**SMALL))
    tm.load_state_dict(clip_text_state_dict_from_openai(sd, layers=2))
    tm.eval()
    tokens = jtok.HashTokenizer()(SENTENCES)
    ref = jm.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens))
    assert rel(out.numpy(), ref) <= TOL


def test_weight_bridge_round_trips_the_clip_tree():
    """JAX params -> state_dict -> JAX params, bit for bit; the embeddings,
    the packed attn_in_proj_weight [3W, W] and text_projection [W, E] keep
    their layout (they are not Dense kernels)."""
    _, params, tm = _pair(seed=1)
    sd = jax_params_to_state_dict(params)
    for k in ("token_embedding", "positional_embedding", "text_projection"):
        np.testing.assert_array_equal(sd[k].numpy(), params[k], err_msg=k)
    np.testing.assert_array_equal(sd["block_1.attn_in_proj_weight"].numpy(),
                                  params["block_1"]["attn_in_proj_weight"])
    back, orig = _flat(state_dict_to_jax_params(tm.state_dict(), tm)), _flat(params)
    assert set(back) == set(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


def test_fresh_init_matches_flax_statistics():
    """normal(0.02) token embedding and in_proj, normal(0.01) positions,
    normal(width^-0.5) projection, lecun-normal Dense kernels, zero biases,
    from a seeded generator."""
    jm = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**SMALL))
    flax_params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"]
    module = CLIPTextEncoder(CLIPTextConfig(**SMALL), generator=torch.Generator().manual_seed(0))
    assert_init_matches_flax(flax_params, module)
    again = CLIPTextEncoder(CLIPTextConfig(**SMALL), generator=torch.Generator().manual_seed(0))
    assert torch.equal(module.token_embedding, again.token_embedding)
    assert abs(module.text_projection.std().item() * 8 - 1) < 0.05


LONG = " ".join(f"word{i} and, more" for i in range(60))  # past 77 tokens either way


def test_hash_tokenizer_matches_jax():
    texts = SENTENCES + [LONG, ""]
    ref = jtok.HashTokenizer()(texts)
    out = ttok.HashTokenizer()(texts)
    assert out.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    assert out[3, -1] == ttok.HashTokenizer.eot  # truncated to the context
    np.testing.assert_array_equal(ttok.tokenize(texts), jtok.tokenize(texts))
    np.testing.assert_array_equal(ttok.HashTokenizer()(texts, 16), jtok.HashTokenizer()(texts, 16))


def _merges(rng):
    """A merges file of CLIP's format: a header line, then pairs of symbols
    (the results of earlier merges, or bytes; a word's last with </w>)."""
    words = ["the", "person", "talking", "market", "weather", "hello", "warm", "word"]
    lines, symbols = ["#version: 0.2"], set()
    for w in words:  # left to right, so every piece exists before it is merged
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            lines.append(f"{parts[0]} {parts[1]}")
            symbols.add(parts[0] + parts[1])
            parts = [parts[0] + parts[1]] + parts[2:]
    letters = "abcdefghijklmnopqrstuvwxyz"
    for _ in range(40):  # and some random pairs of letters
        a, b = rng.choice(list(letters), 2)
        lines.append(f"{a} {b}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz"])
def test_clip_tokenizer_matches_jax(tmp_path, suffix):
    """CLIP's BPE on a small merges file, plain and gzipped: ids, the
    77-token truncation and encode() equal the JAX package's."""
    text = _merges(np.random.default_rng(4))
    path = tmp_path / f"merges{suffix}"
    if suffix.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(text.encode("utf-8"))
    else:
        path.write_text(text, encoding="utf-8")
    texts = SENTENCES + [LONG, "It's the person's market; they'll be warm: 42 degrees!", ""]
    jt, tt = jtok.CLIPTokenizer(str(path)), ttok.CLIPTokenizer(str(path))
    ref, out = jt(texts), tt(texts)
    np.testing.assert_array_equal(out, ref)
    assert (out[3] != 0).all() and out[3, -1] == tt.eot  # LONG fills the context
    assert len(tt.encode(texts[1])) < len(texts[1])  # the merges apply
    for t in texts:
        assert tt.encode(t) == jt.encode(t)
    np.testing.assert_array_equal(ttok.tokenize(texts, str(path)), jtok.tokenize(texts, str(path)))


def test_clip_tokenizer_needs_its_merges_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        ttok.CLIPTokenizer(str(tmp_path / "missing.txt.gz"))
