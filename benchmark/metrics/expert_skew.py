"""How unevenly the tower's routing loads its experts over the traced
stretch: in each routed layer the busiest expert's (token, expert) pairs
over the mean expert's, from the port's ``moe_text`` counters
(``utils/profiling.counters()``) at the stretch's stop less its start;
the worst layer's. 1 is even."""


def read(obs, ctx):
    counters = obs.get("counters", {})
    try:
        a = counters["start"]["program"]["moe_text"]["expert_load"]
        b = counters["stop"]["program"]["moe_text"]["expert_load"]
    except KeyError:
        return None
    worst = None
    for before, after in zip(a, b):
        load = [y - x for x, y in zip(before, after)]
        if sum(load):
            skew = max(load) * len(load) / sum(load)
            worst = skew if worst is None else max(worst, skew)
    return worst
