"""The control on the card, at each cell's own sizes and load for a short
window: the plain reference computed in TF32 in the program's place must
come out not correct on every seed, while the program comes out correct.
Run on the card with ``python3 -m pytest benchmark/tests -m cuda``."""

import time

import pytest

from benchmark import harness

SEEDS = (2 ** 32 + 17, 2 ** 32 + 18, 2 ** 32 + 19)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_spec()["workloads"]])
def test_control_fails_and_program_passes(cuda_device, cell):
    spec = harness.load_spec()
    for seed in SEEDS:
        ctx = harness.make_ctx(spec, cell, seed, 2.0, False, cuda_device, time.monotonic(),
                               control=True)
        out = harness.run_cell(ctx)
        own = {k: v for k, v in out.checks.items() if "." not in k}
        control = {k[len("control."):]: v for k, v in out.checks.items()
                   if k.startswith("control.")}
        assert all(v <= lim for v, lim in own.values()), (seed, own)
        assert any(v > lim for v, lim in control.values()), (seed, control)
