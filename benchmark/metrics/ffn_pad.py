"""How much of the grouped SwiGLU's routed work is padding over the traced
stretch: 100 x (1 - the routed (token, expert) pairs / the rows the kernel
computed for them), from the port's ``moe_text`` counters
(``utils/profiling.counters()``: ``expert_load`` and ``ffn_tile_rows``,
each expert's pairs rounded up to whole row tiles) at the stretch's stop
less its start, over every routed layer. 0 is no padding. A program
without ``ffn_tile_rows`` reads nothing."""


def read(obs, ctx):
    counters = obs.get("counters", {})
    try:
        a = counters["start"]["program"]["moe_text"]
        b = counters["stop"]["program"]["moe_text"]
        pairs = sum(map(sum, b["expert_load"])) - sum(map(sum, a["expert_load"]))
        rows = sum(b["ffn_tile_rows"]) - sum(a["ffn_tile_rows"])
    except KeyError:
        return None
    if rows <= 0:
        return None
    return 100.0 * (1.0 - pairs / rows)
