"""Readings that set a cell's limits: the program's and the control's.

    python3 -m benchmark.control --workload ted-train-b512 --seeds 11,12,13 --seconds 4

runs the cell once a seed in this one process (kernels built once), at the
cell's own sizes and load for a short window, and prints one JSON line a
seed: each number compared, read from the program, and the same number
read from the control, the plain reference computed in TF32 in the
program's place (``control.<name>``); for a training cell also the
reference with half of each batch left out, the mean taken over the rest
(``half_batch.<name>``). The benchmark's own runs read none of these.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--no-control", action="store_true",
                    help="read the program alone")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.make_ctx(spec, args.workload, seed, args.seconds, False,
                               torch.device("cuda", 0), time.monotonic(),
                               control=not args.no_control)
        out = harness.run_cell(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": {k: v[0] for k, v in out.checks.items()},
                          "e2e": out.e2e, "setup_s": out.setup_s, "notes": out.notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
