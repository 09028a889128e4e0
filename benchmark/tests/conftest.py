"""Shared fixtures of the benchmark's own tests: tiny configurations and
traffic for rehearsing a cell on the CPU, and the card for the tests
marked ``cuda``. Nothing here imports JAX."""

import copy
import time

import pytest
import torch

from benchmark import harness

TINY_CONFIG = {
    "rag": {"latent_dim": 32, "num_layers": 2, "n_speakers": 10, "speaker_dim": 16},
    "sag": {"latent_dim": 32, "ff_size": 64, "num_layers": 1, "num_heads": 2},
    "clip": {"width": 32, "layers": 1, "heads": 2, "embed_dim": 32},
}
TINY_TRAFFIC = {
    "ted-serve-mb32": {"max_batch": 4, "rate": 120, "warmup": 4, "check_batches": 3,
                       "audio_pool": 8, "trace_s": 0.3},
    "beat-sample-ddim100-b256": {"batch": 3, "respacing": "ddim10", "audio_pool": 8,
                                 "trace_units": 1},
    "ted-train-b512": {"batch": 4, "pool": 32, "trace_units": 2, "warmup_steps": 1,
                       "check_within": 3},
    "beat-compose-b64": {"batch": 3, "respacing": "ddim10", "skip": 7, "audio_pool": 8,
                         "trace_units": 1, "check_batches": 2},
}
CELLS = sorted(TINY_TRAFFIC)
# a cell whose files are here but whose entry BENCHMARK.json does not hold
# yet (PERF.md, Open questions)
UNLISTED = {"ted-serve-mb32": {"name": "ted-serve-mb32", "config": "livelyspeaker-ted",
                               "traffic": "ted-serve-mb32", "chips": 1}}


def tiny_ctx(cell, seed=2 ** 33 + 5, seconds=0.6, trace=False, control=False):
    """A context for ``cell`` at the tiny sizes, on the CPU."""
    spec = harness.load_spec()
    c = UNLISTED.get(cell) or harness.find_cell(spec, cell)
    cfg = copy.deepcopy(harness.load_json(harness.config_file(spec, c["config"])))
    for group, kv in TINY_CONFIG.items():
        cfg[group].update(kv)
    tr = harness.load_json(harness.BENCH_DIR / "workloads" / f"{c['traffic']}.json")
    tr.update(TINY_TRAFFIC[cell])
    return harness.make_ctx(spec, cell, seed, seconds, trace, torch.device("cpu"),
                            time.monotonic(), config=cfg, traffic=tr, control=control, cell=c)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)
