"""Host calls that wait on the card (stream, device and event
synchronises, synchronous copies) started inside a span of the program on
its thread, per unit traced (batch or step): the harness's own
synchronises are outside every span and not counted."""

from benchmark import spans


def read(obs, ctx):
    events = obs.get("trace_events")
    if not obs.get("trace") or not events:
        return None
    return spans.per_unit(obs, spans.blocking_calls(events))
