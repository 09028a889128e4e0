"""K2's share of its roofline over a training step: the sum of its
kernels' least times (the frozen ``arith.k2_cost`` at the traffic's
batch, against the TF32 peak and HBM3) times the steps traced, over the
sum of their device time, in %."""

from benchmark import arith
from benchmark.kinds.common import seq_len


def read(obs, ctx):
    trace, traced = obs.get("trace"), obs.get("traced")
    if not trace or not traced or not traced.get("steps"):
        return None
    secs, n = arith.kernel_time_s(trace, arith.K2_KERNELS)
    if not n:
        return None
    c = ctx.config["rag"]
    cost = arith.k2_cost(ctx.traffic["batch"], seq_len(c), c["latent_dim"], c["num_layers"])
    bound = sum(arith.bound_s(f, b) for f, b in cost.values())
    return 100.0 * traced["steps"] * bound / secs
