"""The TED training step through K3, the step on the cuDNN WavEncoder and
the serving burst, timed in turns against another checkout.

    python3 k3_step_turns.py --other DIR [--rounds 2] [--runs 3]

Runs one process a turn, in the order other, this, this, other (``--rounds``
times), each from its own checkout (this one or DIR, a checkout of another
commit) and with that checkout's ``chip_smoke.py``: the device and build
phases, the TED serving burst (``serving_phase``: 24 requests from 3
threads), one training run of 30 steps at batch 512 on the cuDNN
WavEncoder and ``--runs`` with the K3 drop-in (``train_phase``). Prints
each process's numbers as it ends, then for each checkout the median of
its runs' step medians, their range, and the burst's clips/s, with the
card's name and power limit. Every run is checked as ``chip_smoke.py``
checks it.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def child(checkout, runs):
    """One turn in ``checkout``: its chip_smoke's phases; a JSON line of
    the numbers as the last line."""
    os.chdir(checkout)
    sys.path.insert(0, str(checkout))
    import chip_smoke

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        card = chip_smoke.device_phase()
        chip_smoke.build_phase()
        chip_smoke.serving_phase(card)
        _, _, _, _, base = chip_smoke.train_phase(card)
        for _ in range(runs):
            chip_smoke.train_phase(card, wav_kernels=True, beside=base)
    text = "".join(tee.parts)
    medians = {tag: [float(v) for v in re.findall(
        rf"^\[{tag}\] step [0-9.]+ ms \(median ([0-9.]+)", text, re.M)]
        for tag in ("train", "train-k3")}
    clips = [float(v) for v in re.findall(r"^\[serving\] .* ([0-9.]+) clips/s", text, re.M)]
    print(json.dumps({"card": card, "cudnn": medians["train"], "k3": medians["train-k3"],
                      "serving": clips}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", metavar="DIR", required=True,
                        help="a checkout of another commit, timed in turns with this one")
    parser.add_argument("--rounds", type=int, default=2, help="turns of other, this, this, other")
    parser.add_argument("--runs", type=int, default=3, help="K3 training runs a process")
    parser.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(Path(args.child), args.runs)
        return
    other = Path(args.other).resolve()
    names = {"other": other, "this": ROOT}
    order = ["other", "this", "this", "other"] * args.rounds
    got = {k: [] for k in names}
    for k in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--other",
                               str(other), "--runs", str(args.runs), "--child", str(names[k])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            raise SystemExit(f"k3_step_turns: the {k} turn failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        got[k].append(res)
        print(f"[turn] {k} ({names[k].name}): K3 step medians {res['k3']} ms, cuDNN "
              f"{res['cudnn']} ms, serving {res['serving']} clips/s ({res['card']})", flush=True)
    for k, results in got.items():
        k3 = [v for r in results for v in r["k3"]]
        cudnn = [v for r in results for v in r["cudnn"]]
        serving = [v for r in results for v in r["serving"]]
        print(f"[step-turns] {k} ({names[k].name}), {len(results)} processes: TED step through "
              f"K3 median {np.median(k3):.2f} ms (range {min(k3):.2f}-{max(k3):.2f}, {len(k3)} "
              f"runs); on cuDNN {np.median(cudnn):.2f} ms ({min(cudnn):.2f}-{max(cudnn):.2f}); "
              f"serving burst {np.median(serving):.1f} clips/s ({min(serving):.1f}-"
              f"{max(serving):.1f}) ({results[0]['card']})")


if __name__ == "__main__":
    main()
