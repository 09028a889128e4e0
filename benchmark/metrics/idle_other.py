"""The share of the traced stretch in which the card idled while the host
was in none of the program's stage spans: the benchmark's own code, and
``rag.sample``'s glue between its stages, in %. The ``idle_*`` metrics of
a cell sum to its ``idle`` (``benchmark/spans.py``)."""

from benchmark import spans


def read(obs, ctx):
    return spans.idle_share(obs, "other")
