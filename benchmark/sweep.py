"""Find the serving knee: the highest rate a serving cell sustains without
a growing backlog.

    python3 -m benchmark.sweep --traffic ted-serve-mb32 --config livelyspeaker-ted \
        --rates 400,600,800 --seconds 10

runs the serving traffic ``benchmark/workloads/<traffic>.json`` on the
configuration ``benchmark/configs/<config>.json`` (a cell of its own, in
``BENCHMARK.json`` or not yet) once a rate in this one process, at the rate
given in place of its traffic file's, and prints one JSON line a rate: the latency
percentiles, the median latency of the first and of the second half of
the requests, and the requests still unanswered when the last was due.
A backlog that grows shows as a second half slower than the first and
many unanswered at the end. The knee is found once, when a cell is
defined; its traffic file then holds a fixed rate.
"""

import time

import argparse
import json
import sys

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cell = {"name": args.traffic, "config": args.config, "traffic": args.traffic, "chips": 1}
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = harness.load_json(harness.BENCH_DIR / "workloads" / f"{args.traffic}.json")
        traffic["rate"] = rate
        ctx = harness.make_ctx(spec, args.traffic, args.seed, args.seconds, False,
                               torch.device("cuda", 0), time.monotonic(), traffic=traffic,
                               cell=cell)
        out = harness.run_cell(ctx)
        print(json.dumps({"rate": rate, "p95_ms": out.e2e["serve_p95_ms"], **out.notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
