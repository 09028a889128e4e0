"""The device time of the work launched inside the tower's ``lm.ffn``
spans (layer 0's SwiGLU; each routed layer's expert products, weighted
combine and shared experts), per batch traced, in ms."""

from benchmark import spans


def read(obs, ctx):
    return spans.span_device_ms(obs, ("lm.ffn",))
