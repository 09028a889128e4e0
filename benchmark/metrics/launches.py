"""The host's kernel-launch calls (runtime and driver API; a graph
launch counts once) in the traced stretch, per batch the stretch held."""


def read(obs, ctx):
    trace, traced = obs.get("trace"), obs.get("traced")
    if not trace or not traced or not traced.get("batches") or not trace["launch_calls"]:
        return None
    return trace["launch_calls"] / traced["batches"]
