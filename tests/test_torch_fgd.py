"""Parity of the port's FGD evaluator with the JAX package: the pose
embedding encoder (TED and BEAT widths) on the same weights within rel
1e-5, the reference-layout converter, the Fréchet distance, the diversity
score and the evaluator's scores on the same motions.

The Flax parameters are replaced with seeded normals of unit-fan-in scale
(BatchNorm variances kept positive, scales near 1) and carried over by
``jax_params_to_state_dict``; rel = max|port - jax| / max|jax|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from livelyspeaker_tpu.eval import fgd as jfgd
from livelyspeaker_tpu.models import embedding_net as jemb
from livelyspeaker_tpu_torch.eval import fgd as tfgd
from livelyspeaker_tpu_torch.models import embedding_net as temb
from livelyspeaker_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    pose_embedding_state_dict_from_torch,
    random_normal_params,
)

TOL = 1e-5


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


def _jax_params(jmodule, pose_dim, n_frames, seed):
    params = jax.jit(jmodule.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, n_frames, pose_dim)))["params"]
    params = random_normal_params(jax.tree.map(np.asarray, params), np.random.default_rng(seed))
    for k in list(params):
        if k.endswith("_bn_var"):
            params[k] = np.abs(params[k]) + 0.5
        elif k.endswith("_bn_scale"):  # near 1, as a trained BatchNorm's
            params[k] = 1.0 + params[k]
    return params


VARIANTS = {
    "ted": (jemb.TedEmbeddingEncoder, temb.TedEmbeddingEncoder, 27, 34),
    "ted_short": (jemb.TedEmbeddingEncoder, temb.TedEmbeddingEncoder, 27, 20),
    "beat": (jemb.BeatEmbeddingEncoder, temb.BeatEmbeddingEncoder, 282, 34),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_embedding_encoder_matches_jax(variant):
    jcls, tcls, pose_dim, n_frames = VARIANTS[variant]
    jnet = jcls(pose_dim=pose_dim, n_frames=n_frames)
    params = _jax_params(jnet, pose_dim, n_frames, seed=1)
    net = tcls(pose_dim=pose_dim, n_frames=n_frames)
    net.load_state_dict(jax_params_to_state_dict(params))
    x = np.random.default_rng(2).normal(size=(5, n_frames, pose_dim)).astype(np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert rel(out, jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))) <= TOL


def _reference_state_dict(rng, pose_dim=27, b=32, mults=(8, 4), length=12):
    """A PoseEncoderConv state_dict in the reference's key layout."""
    sd = {}

    def put(name, shape, positive=False):
        a = rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[-1] if len(shape) > 1 else 1)
        sd[f"pose_encoder.{name}"] = torch.from_numpy(np.abs(a) + 0.5 if positive else a)

    for name, c_in, c_out, k in (("net.0.0", pose_dim, b, 3), ("net.1.0", b, 2 * b, 3),
                                 ("net.2.0", 2 * b, 2 * b, 4), ("net.3", 2 * b, b, 3)):
        put(f"{name}.weight", (c_out, c_in, k))
        put(f"{name}.bias", (c_out,))
    for name, c_in, c_out in (("out_net.0", b * length, b * mults[0]),
                              ("out_net.3", b * mults[0], b * mults[1]),
                              ("out_net.6", b * mults[1], b), ("fc_mu", b, b)):
        put(f"{name}.weight", (c_out, c_in))
        put(f"{name}.bias", (c_out,))
    for name, c in (("net.0.1", b), ("net.1.1", 2 * b), ("net.2.1", 2 * b),
                    ("out_net.1", b * mults[0]), ("out_net.4", b * mults[1])):
        put(f"{name}.weight", (c,))
        put(f"{name}.bias", (c,))
        put(f"{name}.running_mean", (c,))
        put(f"{name}.running_var", (c,), positive=True)
    return sd


def test_reference_checkpoint_converter_matches_jax():
    sd = _reference_state_dict(np.random.default_rng(3))
    net = temb.TedEmbeddingEncoder()
    net.load_state_dict(pose_embedding_state_dict_from_torch(sd))
    params = jemb.pose_embedding_params_from_torch(sd)
    x = np.random.default_rng(4).normal(size=(6, 34, 27)).astype(np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert rel(out, jemb.TedEmbeddingEncoder().apply({"params": params}, jnp.asarray(x))) <= TOL


def _features(seed, n=40, d=32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(0.3, 1.2, size=(n, d))


@pytest.mark.parametrize("seed", [5, 6])
def test_frechet_and_diversity_match_jax(seed):
    a, b = _features(seed)
    assert tfgd.frechet_from_samples(a, b) == jfgd.frechet_from_samples(a, b)
    mu, sigma = a.mean(0), np.cov(a, rowvar=False)
    assert (tfgd.calculate_frechet_distance(mu, sigma, b.mean(0), np.cov(b, rowvar=False))
            == jfgd.calculate_frechet_distance(mu, sigma, b.mean(0), np.cov(b, rowvar=False)))
    batches = [a[i:i + 8] for i in range(0, len(a), 8)]
    assert tfgd.diversity_score(batches) == jfgd.diversity_score(batches)


def test_evaluator_scores_match_jax(tmp_path):
    params = _jax_params(jemb.TedEmbeddingEncoder(), 27, 34, seed=7)
    ours = tfgd.EmbeddingSpaceEvaluator(jax_params_to_state_dict(params), device="cpu")
    theirs = jfgd.EmbeddingSpaceEvaluator(params)
    rng = np.random.default_rng(8)
    for _ in range(3):
        gen = rng.normal(size=(16, 34, 27)).astype(np.float32)
        real = rng.normal(0.1, 1.1, size=(16, 34, 27)).astype(np.float32)
        ours.push_samples(torch.from_numpy(gen), real)
        theirs.push_samples(gen, real)
    assert ours.get_no_of_samples() == theirs.get_no_of_samples() == 3
    for a, b in zip(ours.real_feat_list + ours.generated_feat_list,
                    theirs.real_feat_list + theirs.generated_feat_list):
        assert rel(a, b) <= TOL
    (fd, dist), (jfd, jdist) = ours.get_scores(), theirs.get_scores()
    assert abs(fd - jfd) <= 1e-3 * abs(jfd) and abs(dist - jdist) <= TOL * abs(jdist)
    assert abs(ours.get_diversity_scores() - theirs.get_diversity_scores()) <= 1e-4
    pytest.importorskip("sklearn")
    real2d, gen2d = ours.get_features_for_viz()
    assert real2d.shape == gen2d.shape == (48, 2)
    ours.reset()
    assert ours.get_no_of_samples() == 0


def test_evaluator_reads_the_reference_checkpoint(tmp_path):
    sd = _reference_state_dict(np.random.default_rng(9))
    torch.save({"gen_dict": sd, "pose_dim": 27}, tmp_path / "ted_eval.bin")
    ours = tfgd.EmbeddingSpaceEvaluator.from_torch_checkpoint(str(tmp_path / "ted_eval.bin"),
                                                              device="cpu")
    theirs = jfgd.EmbeddingSpaceEvaluator.from_torch_checkpoint(str(tmp_path / "ted_eval.bin"))
    x = np.random.default_rng(10).normal(size=(4, 34, 27)).astype(np.float32)
    assert rel(ours.embed(x), theirs.embed(x)) <= TOL


def test_evaluator_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tfgd.EmbeddingSpaceEvaluator(temb.TedEmbeddingEncoder().state_dict())
