"""Requests a served batch held over the traced stretch: the batcher's
``stats()`` counters, copied at the stretch's start and stop, as
requests served over batches served between the two."""


def read(obs, ctx):
    counters = obs.get("counters", {})
    if "start" not in counters or "stop" not in counters:
        return None
    a, b = counters["start"].get("batcher"), counters["stop"].get("batcher")
    if not a or not b:
        return None
    batches = b["batches_served"] - a["batches_served"]
    return (b["requests_served"] - a["requests_served"]) / batches if batches else None
