"""The device time of the work launched inside ``rag.prepare`` (the audio
encoding, the CFG rows, ``precompute_rag_static``), per batch traced, in
ms."""

from benchmark import spans


def read(obs, ctx):
    return spans.span_device_ms(obs, ("rag.prepare",))
