"""The port's own spans in a traced stretch (``utils/profiling.annotate``:
``record_function`` events, category ``user_annotation``, on the clock of
the kernels and copies): which stage the host was in while the card idled,
and the host calls inside a stage that wait on the card.

Each reader returns None where the stretch holds no trace (the CPU) or no
span of the program (a checkout without them), so a cell reads nothing
rather than nought there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from benchmark import arith

# leaf span -> the stage its idle time is put down to; a gap under no leaf
# (the harness's own code, rag.sample's glue) is "other"
STAGES = {"rag.prepare": "prepare", "rag.step": "step", "compose.clip": "sketch",
          "compose.sag": "sketch", "train.loader": "loader", "train.grads": "grads",
          "train.sync": "update", "train.apply": "update"}
SPANS = frozenset(STAGES) | {"rag.sample"}
# host calls that return only once the card has drained what they wait on
BLOCKING = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy"))


def program_spans(events: List[Dict]) -> List[Dict]:
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] in SPANS]


def idle_by_stage(events: List[Dict]) -> Optional[Dict[str, float]]:
    """The share of the stretch (``t0..t1`` of all its events) in which the
    card ran no kernel, copy or set, by stage, in %: each gap between the
    card's busy intervals, and before the first and after the last, as
    ``arith.idle_gaps`` walks them, goes to the stage of the innermost
    (shortest) program span open at its midpoint. The shares sum to the
    stretch's idle share. None without program spans or device work."""
    spans = sorted(program_spans(events), key=lambda e: e["ts"])
    dev = [e for e in events if e.get("cat") in arith.DEVICE_CATS]
    if not spans or not dev:
        return None
    merged = arith._merged([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    out = dict.fromkeys(sorted(set(STAGES.values())) + ["other"], 0.0)
    active: List[Dict] = []
    nxt = 0
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        while nxt < len(spans) and spans[nxt]["ts"] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [e for e in active if e["ts"] + e["dur"] >= mid]
        inner = min(active, key=lambda e: e["dur"], default=None)
        stage = STAGES.get(inner["name"], "other") if inner is not None else "other"
        out[stage] += hi - lo
    return {k: 100.0 * v / (t1 - t0) for k, v in out.items()}


def idle_share(obs: Dict, stage: str) -> Optional[float]:
    """``idle_by_stage``'s share of ``stage``, or None where no span of that
    stage ran in the stretch (``other``: where no program span ran)."""
    events = obs.get("trace_events")
    if not obs.get("trace") or not events:
        return None
    shares = idle_by_stage(events)
    if shares is None:
        return None
    if stage != "other" and not any(STAGES.get(e["name"]) == stage
                                    for e in program_spans(events)):
        return None
    return shares[stage]


def blocking_calls(events: List[Dict]) -> Optional[int]:
    """Host calls of :data:`BLOCKING` that start inside a program span on
    that span's thread; None without program spans."""
    spans = program_spans(events)
    if not spans:
        return None
    ivs: Dict[tuple, List[tuple]] = {}
    for e in spans:
        ivs.setdefault((e.get("pid"), e.get("tid")), []).append((e["ts"], e["ts"] + e["dur"]))
    merged = {k: arith._merged(v) for k, v in ivs.items()}

    def inside(e):
        return any(lo <= e["ts"] <= hi for lo, hi in merged.get((e.get("pid"), e.get("tid")), ()))

    return sum(1 for e in events
               if e.get("cat") in arith.LAUNCH_CATS and e["name"] in BLOCKING and inside(e))


def per_unit(obs: Dict, value: Optional[float]) -> Optional[float]:
    """``value`` over the units of work the stretch held (its batches or
    steps)."""
    traced = obs.get("traced")
    if value is None or not traced:
        return None
    (units,) = traced.values()
    return value / units if units else None


def span_device_ms(obs: Dict, names) -> Optional[float]:
    """The device milliseconds of the work launched inside the spans
    ``names`` (``arith.span_times``), per unit of work; None where none of
    them ran."""
    spans = (obs.get("trace") or {}).get("spans") or {}
    hit = [spans[n]["device_s"] for n in names if n in spans]
    return per_unit(obs, 1e3 * sum(hit)) if hit else None
