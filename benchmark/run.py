"""Run one cell of the benchmark once, on the card.

    python3 -m benchmark.run --workload beat-sample-ddim100-b256 --seed 7 --seconds 51 --trace 0

from the root of a checkout. Loads, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error). Exits non-zero, printing no
result, without enough CUDA cards, when the port is not this checkout's,
or when the JAX stack or the JAX package was loaded.
"""

import time

T0 = time.monotonic()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import harness  # noqa: E402


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its own libraries into
    ``livelyspeaker_tpu_torch/csrc/_build``)."""
    cache = harness.ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    import livelyspeaker_tpu_torch as port

    if harness.ROOT not in Path(port.__file__).resolve().parents:
        print(f"the program under test must come from this checkout, not {port.__file__}",
              file=sys.stderr)
        return 2
    ctx = harness.make_ctx(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T0)
    out = harness.run_cell(ctx)
    found = harness.foreign_modules()
    if found:
        print(f"the JAX stack or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    line = harness.result_line(spec, ctx, out)
    if ctx.trace:  # the rooflines and mfu are shares of the 700 W peaks
        out.notes["card"] = _card()
    if out.notes:
        print(json.dumps({"notes": out.notes}), flush=True)
    for k, v in line["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
