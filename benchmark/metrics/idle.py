"""The share of the traced stretch in which no kernel, copy or set ran
on the card, in %."""


def read(obs, ctx):
    trace = obs.get("trace")
    return None if not trace else 100.0 * trace["idle_share"]
