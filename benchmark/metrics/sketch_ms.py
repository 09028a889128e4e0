"""The device time of the work launched inside ``compose.clip`` and
``compose.sag`` (the token copy, CLIP's text tower, the SAG's decode), per
batch traced, in ms."""

from benchmark import spans


def read(obs, ctx):
    return spans.span_device_ms(obs, ("compose.clip", "compose.sag"))
