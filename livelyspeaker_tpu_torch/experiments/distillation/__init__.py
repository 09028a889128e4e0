from .distill import distill_targets, make_distill_step

__all__ = ["distill_targets", "make_distill_step"]
