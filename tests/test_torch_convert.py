"""The port's checkpoint conversion against the JAX package's.

- ``utils/convert.py: rag_state_dict_from_reference`` on state_dicts with
  exactly the reference RAG's keys and shapes (``tests/manifests/rag_ted``,
  ``rag_beat``) equals ``jax_params_to_state_dict`` of the JAX converter's
  tree bit for bit, loads into ``RAG(RAGConfig.ted())`` / ``.beat()`` with
  ``strict=True``, and a small forward matches the Flax forward on the same
  weights within the RAG parity tests' tolerance (atol 3e-4).
- The port's manifest test: every converter of the port consumes each
  manifest key but the documented ignores (sinusoid tables the models
  rebuild, the decoder halves and variational heads FGD and FID never run,
  BatchNorm step counters), and its state_dict loads with ``strict=True``.
- ``scripts/convert_checkpoint.py``: each kind's npz equals the JAX
  script's, run in this process on the same ``.pt``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.utils.torch_convert import rag_params_from_torch_state_dict
from livelyspeaker_tpu_torch.models import SAG, RAG, RAGConfig, audio_samples_for_frames
from livelyspeaker_tpu_torch.models.embedding_net import (
    BeatEmbeddingEncoder,
    TedEmbeddingEncoder,
)
from livelyspeaker_tpu_torch.scripts import convert_checkpoint
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    pose_embedding_state_dict_from_torch,
    rag_state_dict_from_reference,
    sag_state_dict_from_reference,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST_DIR = os.path.join(REPO, "tests", "manifests")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: torch's CPU thread pool costs more than it
    gives here, and its spinning threads slow the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_manifest(name):
    with open(os.path.join(MANIFEST_DIR, f"{name}.json")) as f:
        return json.load(f)


def reference_state_dict(name, seed=0):
    """A seeded torch state_dict with exactly the manifest's keys and shapes,
    at unit-fan-in scale (std 1/sqrt(fan_in) for a weight of two or more
    axes, 1 for an embedding table; norm scales near 1, biases and running
    means near 0, running variances above 0.5; step counters int64)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in load_manifest(name).items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7, dtype=torch.int64)
            continue
        a = rng.normal(size=shape)
        if k.endswith("running_var"):
            a = np.abs(a) + 0.5
        elif k.endswith(("alpha", "running_mean")) or (k.endswith("weight") and len(shape) == 1):
            a = (1.0 if not k.endswith("running_mean") else 0.0) + 0.1 * a
        elif "embedding.weight" in k:
            pass
        elif len(shape) >= 2 and k.endswith("weight"):
            a = a / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * a
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


class RecordingDict(dict):
    """A state_dict that records which keys a converter reads."""

    def __init__(self, data):
        super().__init__(data)
        self.touched = set()

    def __getitem__(self, k):
        self.touched.add(k)
        return super().__getitem__(k)


RAG_PE = {"sequence_pos_encoder.pe", "backbone.sequence_pos_encoder.pe",
          "backbone.embed_timestep.sequence_pos_encoder.pe"}


def _embedding_ignores(manifest):
    return {k for k in manifest if k.startswith("decoder.")
            or k.startswith("pose_encoder.fc_logvar.") or k.endswith("num_batches_tracked")}


MANIFEST_CASES = {
    "rag_ted": (lambda sd: rag_state_dict_from_reference(sd, 8, 0),
                lambda: RAG(RAGConfig.ted()), lambda m: RAG_PE),
    "rag_beat": (lambda sd: rag_state_dict_from_reference(sd, 8, 8),
                 lambda: RAG(RAGConfig.beat()), lambda m: RAG_PE),
    "sag": (lambda sd: sag_state_dict_from_reference(sd, 3), lambda: SAG(),
            lambda m: {"encoder.sequence_pos_encoder.pe", "decoder.sequence_pos_encoder.pe"}),
    "ted_evaluator": (pose_embedding_state_dict_from_torch, lambda: TedEmbeddingEncoder(),
                      _embedding_ignores),
    "beat_half_embedding": (pose_embedding_state_dict_from_torch,
                            lambda: BeatEmbeddingEncoder(), _embedding_ignores),
}


@pytest.mark.parametrize("name", list(MANIFEST_CASES))
def test_manifest_surface_and_structure(name):
    """Every key of the released checkpoint's surface is read or
    deliberately ignored, and the result loads into the port's module."""
    convert, make, ignores = MANIFEST_CASES[name]
    manifest = load_manifest(name)
    sd = RecordingDict(reference_state_dict(name))
    state = convert(sd)
    ignore = ignores(manifest)
    assert not ignore - set(manifest), "an ignored key is not in the manifest"
    skipped = set(manifest) - sd.touched - ignore
    assert not skipped, f"manifest keys the converter skipped: {sorted(skipped)}"
    make().load_state_dict(state, strict=True)


@pytest.mark.parametrize("name,emotions", [("rag_ted", 0), ("rag_beat", 8)], ids=["ted", "beat"])
def test_rag_state_dict_from_reference_matches_jax(name, emotions):
    sd = reference_state_dict(name, seed=1)
    ours = rag_state_dict_from_reference(sd, num_layers=8, num_emotions=emotions)
    params = rag_params_from_torch_state_dict(sd, num_layers=8, num_emotions=emotions)
    theirs = jax_params_to_state_dict(params)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == torch.float32, k
        torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0, msg=k)

    tcfg, jcfg = ((RAGConfig.beat(), JRAGConfig.beat()) if emotions
                  else (RAGConfig.ted(), JRAGConfig.ted()))
    model = RAG(tcfg).eval()
    model.load_state_dict(ours, strict=True)
    # one small forward on the converted weights, both sides
    rng = np.random.default_rng(2)
    b = 2
    cond = {"audio": (0.1 * rng.normal(size=(b, audio_samples_for_frames(34)))).astype(np.float32),
            "vid": rng.integers(0, tcfg.n_speakers, size=(b,)),
            "origin_x": rng.normal(size=(b, tcfg.njoints, tcfg.nfeats, 34)).astype(np.float32),
            "style_eps": rng.normal(size=(b, 1, tcfg.latent_dim)).astype(np.float32),
            "cond_drop": np.array([0.0, 1.0], np.float32)}
    if emotions:
        cond["emo"] = rng.integers(0, emotions, size=(b,))
    x = rng.normal(size=(b, tcfg.njoints, tcfg.nfeats, 34)).astype(np.float32)
    t = np.array([3, 870])
    ref = JRAG(jcfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                           {k: jnp.asarray(v) for k, v in cond.items()})["output"]
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    {k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()})["output"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-4)


# --- convert_checkpoint --------------------------------------------------------

def _clip_reference(seed):
    from test_torch_clip_text import _openai_state_dict

    return _openai_state_dict(np.random.default_rng(seed), layers=12)


# kind: (what torch.save writes, extra argv)
CONVERT_CASES = {
    "rag_ted": ("rag", lambda: reference_state_dict("rag_ted"), []),
    "rag_beat": ("rag", lambda: reference_state_dict("rag_beat"),
                 ["--layers", "8", "--num_emotions", "8"]),
    "sag": ("sag", lambda: reference_state_dict("sag"), []),
    "clip": ("clip", lambda: _clip_reference(3), []),
    "fgd": ("fgd", lambda: {"gen_dict": reference_state_dict("ted_evaluator"), "pose_dim": 27}, []),
    "beat_fid": ("beat_fid", lambda: {"model_state": reference_state_dict("beat_half_embedding")},
                 []),
}


@pytest.fixture(scope="module")
def jax_convert():
    """The JAX package's ``scripts/convert_checkpoint.py``, imported once."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import convert_checkpoint as jscript
    finally:
        sys.path.pop(0)
    return jscript


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_convert_checkpoint_matches_the_jax_script(case, tmp_path, monkeypatch, jax_convert):
    kind, make, extra = CONVERT_CASES[case]
    src = str(tmp_path / "ckpt.pt")
    torch.save(make(), src)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    convert_checkpoint.main([kind, src, ours] + extra)
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", kind, src, theirs] + extra)
    jax_convert.main()
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
