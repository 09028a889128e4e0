"""The device time of the work launched inside ``compose.lm`` (the
language model tower's call: the index copy and its 27 layers), per batch
traced, in ms."""

from benchmark import spans


def read(obs, ctx):
    return spans.span_device_ms(obs, ("compose.lm",))
