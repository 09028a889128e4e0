"""The device time of the work launched inside the tower's ``lm.attn``
spans (each layer's input norm and latent attention), per batch traced,
in ms."""

from benchmark import spans


def read(obs, ctx):
    return spans.span_device_ms(obs, ("lm.attn",))
