"""The share of the traced stretch in which the card idled while the host
was in the denoiser's per-batch preparation (``rag.prepare``: the audio
encoding, the CFG rows, ``precompute_rag_static``), in %. The ``idle_*``
metrics of a cell sum to its ``idle`` (``benchmark/spans.py``)."""

from benchmark import spans


def read(obs, ctx):
    return spans.idle_share(obs, "prepare")
