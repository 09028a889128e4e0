"""Evaluation: the FGD evaluator, the Fréchet distance and the diversity
score."""

from .fgd import (
    EmbeddingSpaceEvaluator,
    calculate_frechet_distance,
    diversity_score,
    frechet_from_samples,
)
