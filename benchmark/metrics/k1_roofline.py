"""K1's share of its roofline: the least time of its calls (the frozen
``arith.k1_cost`` at the cell's shape, against the TF32 peak and HBM3)
over their device time in the trace, in %. Every K1 call of a sampling
cell runs the CFG batch: twice the rows the sampler is given (the
traffic's ``max_batch`` when it serves, its ``batch`` otherwise)."""

from benchmark import arith
from benchmark.kinds.common import k1_call


def read(obs, ctx):
    trace = obs.get("trace")
    if not trace:
        return None
    secs, n = arith.kernel_time_s(trace, arith.K1_KERNELS)
    if not n:
        return None
    rows = 2 * ctx.traffic.get("max_batch", ctx.traffic.get("batch"))
    return 100.0 * n * arith.bound_s(*k1_call(ctx.config["rag"], rows)) / secs
