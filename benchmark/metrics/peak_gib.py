"""Device memory the window held at its peak:
``torch.cuda.max_memory_allocated()`` after a reset at the window's
start, in GiB."""


def read(obs, ctx):
    peak = obs.get("peak_bytes_window")
    return None if not peak else peak / 2 ** 30
