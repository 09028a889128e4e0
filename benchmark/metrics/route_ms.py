"""The device time of the work launched inside the tower's ``lm.route``
spans (each routed layer's norm, router, top-k, and the sort, counts and
gather of its dispatch), per batch traced, in ms."""

from benchmark import spans


def read(obs, ctx):
    return spans.span_device_ms(obs, ("lm.route",))
