"""Fréchet Gesture Distance evaluator (TED) and Fréchet math.

Port of ``livelyspeaker_tpu/eval/fgd.py``: the embedding net runs batched
on the device; only its 32-d features cross to the host, where the Fréchet
distance (scipy's ``sqrtm``) and the HA2G diversity score are computed, as
in the reference's ``scripts/model/ted_evaluator.py``.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..models.embedding_net import TedEmbeddingEncoder
from ..utils.device import place_model

__all__ = ["calculate_frechet_distance", "frechet_from_samples",
           "EmbeddingSpaceEvaluator", "diversity_score"]


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """pytorch-fid's stable Fréchet distance (ted_evaluator.py:89-142)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real
    return float(
        diff.dot(diff)
        + np.trace(sigma1)
        + np.trace(sigma2)
        - 2 * np.trace(covmean)
    )


def frechet_from_samples(a: np.ndarray, b: np.ndarray) -> float:
    """Fréchet distance between two sample sets [N, D] (with the reference's
    1e10-style sentinel on numerical failure, ted_evaluator.py:69-73)."""
    try:
        return calculate_frechet_distance(
            a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)
        )
    except ValueError:
        return float(1e10)


def diversity_score(
    generated_feats_batched: List[np.ndarray], seed: int = 233
) -> float:
    """HA2G diversity (ted_evaluator.py:144-151): mean L1 between the
    generated features and a batch-shuffled copy."""
    rng = np.random.default_rng(seed)
    n = min(len(generated_feats_batched), 500)
    feat1 = np.vstack(generated_feats_batched[:n])
    idx = rng.permutation(len(generated_feats_batched))[:n]
    feat2 = np.vstack([generated_feats_batched[i] for i in idx])
    m = min(len(feat1), len(feat2))
    return float(np.mean(np.sum(np.abs(feat1[:m] - feat2[:m]), axis=-1)))


class EmbeddingSpaceEvaluator:
    """Accumulate real and generated embeddings; score FGD, feature
    distance and diversity.

    ``state_dict`` holds :class:`TedEmbeddingEncoder`'s weights.
    ``push_samples(generated, real)`` takes [B, T, D] mean-subtracted
    dir-vec motions, as arrays or tensors. The encoder runs on the card
    unless ``device`` says otherwise (``utils/device.py``'s rule).
    """

    def __init__(self, state_dict: Mapping[str, torch.Tensor], pose_dim: int = 27,
                 n_frames: int = 34, device: Optional[Union[str, torch.device]] = None):
        self.net = TedEmbeddingEncoder(pose_dim=pose_dim, n_frames=n_frames)
        self.net.load_state_dict(state_dict)
        self.device = place_model(self.net.eval(), device, "EmbeddingSpaceEvaluator")
        self.real_feat_list: List[np.ndarray] = []
        self.generated_feat_list: List[np.ndarray] = []

    @classmethod
    def from_torch_checkpoint(cls, path: str, device: Optional[Union[str, torch.device]] = None
                              ) -> "EmbeddingSpaceEvaluator":
        """The reference's evaluator checkpoint: ``gen_dict`` and
        ``pose_dim``."""
        from ..utils.convert import pose_embedding_state_dict_from_torch

        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = pose_embedding_state_dict_from_torch(ckpt["gen_dict"])
        return cls(sd, pose_dim=int(ckpt["pose_dim"]), device=device)

    def reset(self) -> None:
        self.real_feat_list = []
        self.generated_feat_list = []

    @torch.no_grad()
    def embed(self, poses) -> np.ndarray:
        x = torch.as_tensor(poses).to(self.device, torch.float32)
        return self.net(x).cpu().numpy()

    def push_samples(self, generated_poses, real_poses) -> None:
        self.generated_feat_list.append(self.embed(generated_poses))
        self.real_feat_list.append(self.embed(real_poses))

    def get_no_of_samples(self) -> int:
        return len(self.real_feat_list)

    def get_scores(self) -> Tuple[float, float]:
        gen = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        fd = frechet_from_samples(gen, real)
        feat_dist = float(np.mean(np.sum(np.abs(real - gen), axis=-1)))
        return fd, feat_dist

    def get_diversity_scores(self) -> float:
        return diversity_score(self.generated_feat_list)

    def get_features_for_viz(self):
        """2-D projection of generated and real features for plotting (PCA;
        sklearn is imported here, at first use)."""
        from sklearn.decomposition import PCA

        gen = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        both = PCA(n_components=2).fit_transform(np.vstack([gen, real]))
        n = len(gen)
        return both[n:], both[:n]
