"""Evaluation: the FGD evaluator, the Fréchet distance, the diversity score,
beat alignment, SRGR, L1 diversity and the audio DSP they read."""

from .fgd import (
    EmbeddingSpaceEvaluator,
    calculate_frechet_distance,
    diversity_score,
    frechet_from_samples,
)
from .metrics import (
    Alignment,
    L1Div,
    SRGR,
    long_form_seam_report,
    motion_beat_times_ted,
    ted_beat_align_batch,
)
