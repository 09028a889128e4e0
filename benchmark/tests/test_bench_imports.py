"""What the benchmark may load: never the JAX stack or the JAX package
(compared by whole top-level name, since the port's name begins with the
JAX package's), and in the reference nothing of the port either."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = harness.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "livelyspeaker_tpu"}

RUN_ALL = """
import json, sys
from benchmark import harness
from benchmark.tests.conftest import CELLS, tiny_ctx
for cell in CELLS:
    out = harness.run_cell(tiny_ctx(cell, seconds=0.3))
    assert out.correct, (cell, out.checks)
    harness.reader  # every metric reader is loaded below
for m in harness.load_spec()["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""

REFERENCE_ONLY = """
import json, sys
import benchmark.reference.rag, benchmark.reference.diffusion, benchmark.reference.text
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def _tops(code):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _tops(RUN_ALL)
    assert "livelyspeaker_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    tops = _tops(REFERENCE_ONLY)
    assert not tops & (FORBIDDEN | {"livelyspeaker_tpu_torch"})


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_name_no_jax():
    for path in BENCH.rglob("*.py"):
        tops = set(_imported(path))
        assert not tops & FORBIDDEN, path
        if path.parent.name == "reference":
            assert "livelyspeaker_tpu_torch" not in tops, path


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "beat-sample-ddim100-b256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
