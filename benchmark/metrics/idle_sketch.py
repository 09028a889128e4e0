"""The share of the traced stretch in which the card idled while the host
was in the composition's sketch (``compose.clip``: tokens and CLIP's text
tower; ``compose.sag``: the SAG's decode), in %. The ``idle_*`` metrics of
a cell sum to its ``idle`` (``benchmark/spans.py``)."""

from benchmark import spans


def read(obs, ctx):
    return spans.idle_share(obs, "sketch")
