"""Host calls that wait on the card (``spans.BLOCKING``) started inside
``compose.lm`` on its thread, per batch traced: the tower's dispatch
reads each routed layer's expert sizes back. ``spans.py``'s set of
program spans is fixed, so this reader carries its own."""

from benchmark import arith, spans


def read(obs, ctx):
    events = obs.get("trace_events")
    if not obs.get("trace") or not events:
        return None
    ivs = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == "compose.lm":
            ivs.setdefault((e.get("pid"), e.get("tid")), []).append((e["ts"], e["ts"] + e["dur"]))
    if not ivs:
        return None
    merged = {k: arith._merged(v) for k, v in ivs.items()}
    n = sum(1 for e in events
            if e.get("cat") in arith.LAUNCH_CATS and e["name"] in spans.BLOCKING
            and any(lo <= e["ts"] <= hi for lo, hi in merged.get((e.get("pid"), e.get("tid")), ())))
    return spans.per_unit(obs, n)
