"""The whole step's share of the card's TF32 peak: the model's matmul
FLOPs a unit of work (``flops_per_unit``, by ``benchmark/arith.py``: a
batch, a served clip or a training step) times the units the traced
stretch held, over its span, in %."""

from benchmark import arith


def read(obs, ctx):
    trace, traced, per = obs.get("trace"), obs.get("traced"), obs.get("flops_per_unit")
    if not trace or not traced or not per:
        return None
    (unit, flops), = per.items()
    if not traced.get(unit):
        return None
    return 100.0 * flops * traced[unit] / trace["span_s"] / arith.PEAK_TF32
