"""The tower's feed-forward work against the card's TF32 peak: the FLOPs
of the dense, routed and shared SwiGLUs over a batch's real tokens
(``benchmark/arith_lm.py``, the traced batches' mean, which the kind
leaves in ``obs``) over the device time of ``lm.ffn`` a batch, over
``arith.PEAK_TF32``, in %."""

from benchmark import arith, spans


def read(obs, ctx):
    flops = (obs.get("lm_flops_per_batch") or {}).get("ffn")
    ms = spans.span_device_ms(obs, ("lm.ffn",))
    if not flops or not ms:
        return None
    return 100.0 * flops / (ms / 1e3) / arith.PEAK_TF32
