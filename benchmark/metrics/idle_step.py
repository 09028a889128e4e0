"""The share of the traced stretch in which the card idled while the host
was in the sampler's reverse steps (``rag.step``: the denoiser,
inpainting, the update and the step noise), in %. The ``idle_*`` metrics
of a cell sum to its ``idle`` (``benchmark/spans.py``)."""

from benchmark import spans


def read(obs, ctx):
    return spans.idle_share(obs, "step")
