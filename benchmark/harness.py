"""What every cell shares: the spec, the per-layer readers, the traced
interval, the comparison's readings and the result line.

A cell's traffic file names its ``kind``; ``benchmark/kinds/<kind>.py``
drives it. A kind's ``run(ctx)`` builds the program from the cell's
configuration and the seed, warms it up, measures for ``ctx.seconds`` (and,
in a traced run, traces a stretch of the window), then frees the program
and compares what the window produced with the plain reference. It returns
an :class:`Outcome`; :func:`result_line` turns it into the printed JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from . import arith

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "livelyspeaker_tpu")


def load_spec(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(spec: Dict, name: str) -> Path:
    for c in spec["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t0: float  # time.monotonic() at process start
    trace_dir: str
    control: bool = False  # also read the control (the reference in TF32)


@dataclasses.dataclass
class Outcome:
    setup_s: float
    e2e: Dict[str, float]  # end-to-end readings, by metric name
    attempted: int
    failed: int
    checks: Dict[str, List[float]]  # name -> [value, limit]
    obs: Dict[str, Any]  # what the per-layer readers read
    memory_peak_bytes: int
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def make_ctx(spec: Dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, trace_dir: Optional[str] = None, control: bool = False,
             config: Optional[Dict] = None, traffic: Optional[Dict] = None,
             cell: Optional[Dict] = None) -> Ctx:
    """A run of the cell ``cell_name`` of ``spec``, or of ``cell`` (a
    workload entry not in ``spec``), with its files or the ``config`` and
    ``traffic`` given."""
    cell = cell or find_cell(spec, cell_name)
    cfg = config if config is not None else load_json(config_file(spec, cell["config"]))
    tr = traffic if traffic is not None else load_json(
        BENCH_DIR / "workloads" / f"{cell['traffic']}.json")
    tdir = trace_dir or os.path.join(
        os.environ.get("TMPDIR") or str(ROOT / ".bench_tmp"), "livelyspeaker-bench-trace")
    return Ctx(cell=cell, config=cfg, traffic=tr, seed=seed, seconds=seconds, trace=trace,
               device=device, t0=t0, trace_dir=tdir, control=control)


def run_cell(ctx: Ctx) -> Outcome:
    kind = importlib.import_module(f"benchmark.kinds.{ctx.traffic['kind']}")
    return kind.run(ctx)


# ------------------------------------------------------------- readers
def reader(name: str) -> Callable[[Dict, "Ctx"], Optional[float]]:
    """``read(obs, ctx)`` of ``benchmark/metrics/<name>.py``, or where there
    is none, of ``benchmark/metrics/<stem>.py`` (the name up to its first
    dot): ``idle.py`` reads ``idle.serve`` and ``idle.train`` alike. A
    reader takes what the run observed (``obs``, set out in
    :class:`Tracer`) and the run's context (the cell, its configuration and
    traffic) and returns the metric, or None where it finds nothing to
    read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` its per-layer
    metrics, else its end-to-end ones."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


# --------------------------------------------------------------- tracing
def program_counters() -> Dict[str, Any]:
    """The port's own counters, copied whole: K1's launches (f32 and bf16),
    K2's by kernel, and whatever ``livelyspeaker_tpu_torch.utils.profiling``'s
    ``counters()`` returns, where the port has that function."""
    out: Dict[str, Any] = {}
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train
    from livelyspeaker_tpu_torch.utils import profiling

    k1 = fused_mlp.fused_transmlp
    out["k1"] = {"launches": getattr(k1, "launches", None),
                 "bf16_launches": getattr(k1, "bf16_launches", None)}
    out["k2"] = dict(getattr(fused_mlp_train, "LAUNCHES", {}))
    more = getattr(profiling, "counters", None)
    if callable(more):
        out["program"] = more()
    return out


class Tracer:
    """Profile a stretch of the window when ``ctx.trace``, and leave in
    ``obs`` what the per-layer readers read:

    - ``trace``: :func:`arith.trace_summary` of the stretch (its span, the
      card's busy time and idle share, device time and count by operation,
      the host's launch calls, the idle gaps, each annotation's host and
      device seconds);
    - ``trace_events``: the stretch's complete events as the profiler wrote
      them (``name``, ``cat``, ``ts``, ``dur``, ``args``, ``pid``, ``tid``),
      for a reader that needs more than the summary;
    - ``traced``: the work the stretch held, by unit (``batches``,
      ``clips``, ``steps``), as :meth:`stop` is given it;
    - ``counters``: :func:`program_counters` and the kind's own
      (``counters()``, such as the batcher's ``stats()``), copied whole at
      the stretch's ``start`` and ``stop``.

    The profiler records the activities that the traffic's
    ``trace_activities`` names (``cpu``, ``cuda``; both by default; ``cuda``
    only with a card). Its first start in a process takes seconds:
    :meth:`warm` pays that in set-up. :meth:`finish`, once the window has
    closed, writes the trace under ``TMPDIR``, reads it and deletes it."""

    def __init__(self, ctx: Ctx, obs: Dict, counters: Optional[Callable[[], Dict]] = None):
        self.ctx, self.obs = ctx, obs
        self.kind_counters = counters or dict
        self.prof = self.units = None
        self.active = False

    def _counters(self) -> Dict[str, Any]:
        return {**program_counters(), **self.kind_counters()}

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        want = self.ctx.traffic.get("trace_activities", ["cpu", "cuda"])
        acts = [ProfilerActivity.CPU] if "cpu" in want else []
        if "cuda" in want and self.ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts or [ProfilerActivity.CPU])

    def warm(self) -> None:
        """Start and stop the profiler once, tracing nothing of the window."""
        if self.ctx.trace:
            prof = self._profile()
            prof.start()
            prof.stop()

    def start(self) -> None:
        if not self.ctx.trace:
            return
        sync(self.ctx.device)
        self.obs.setdefault("counters", {})["start"] = self._counters()
        self.prof = self._profile()
        self.prof.start()
        self.active = True

    def stop(self, **units: float) -> None:
        """End the stretch, which held ``units`` of work (``batches=3``)."""
        if not self.active:
            return
        sync(self.ctx.device)
        self.prof.stop()
        self.obs["counters"]["stop"] = self._counters()
        self.active, self.units = False, units

    def finish(self) -> None:
        if self.prof is None:
            return
        if self.active:
            raise RuntimeError("the traced stretch was never stopped")
        os.makedirs(self.ctx.trace_dir, exist_ok=True)
        path = os.path.join(self.ctx.trace_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            events = arith.load_trace(path)
        finally:
            os.unlink(path)
        summary = arith.trace_summary(events)
        if summary and self.units and all(self.units.values()):
            self.obs.update(trace=summary, trace_events=events, traced=self.units)


# ----------------------------------------------------------- comparison
def rel_gap(prog, ref) -> float:
    """max |prog - ref| over max |ref|, of one answer."""
    denom = float(ref.abs().max())
    return float((prog - ref).abs().max()) / max(denom, 1e-30)


def leaf_norm_gaps(prog: Dict, ref: Dict, ref_grad: Dict) -> "tuple[float, str, float]":
    """The worst leaf's gap of norms, | |prog| - |ref| | over the larger of
    the reference leaf's norm and the median leaf's. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out: the exact gradient is nought there (a bias before an
    InstanceNorm), and Adam turns round-off into steps. Returns the worst
    gap, its leaf and the median leaf's gap."""
    gnorm = {k: float(v.norm()) for k, v in ref_grad.items()}
    gmed = statistics.median(gnorm.values())
    keep = [k for k in ref if gnorm[k] >= 1e-3 * gmed]
    rn = {k: float(ref[k].norm()) for k in keep}
    pn = {k: float(prog[k].norm()) for k in keep}
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, statistics.median(gaps.values())


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products and convolutions, in TF32 when ``tf32`` (the
    control) and in full float32 otherwise (the reference)."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def free_device() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ the line
def device_info(device, count: int) -> Dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}
    return {"platform": "cpu", "kind": "cpu", "count": count}


def foreign_modules() -> List[str]:
    """The JAX stack or the JAX package among the loaded modules, by whole
    top-level name."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result_line(spec: Dict, ctx: Ctx, out: Outcome) -> Dict:
    metrics = {}
    for m in cell_metrics(spec, ctx.cell["name"], ctx.trace):
        if ctx.trace:
            value = reader(m["name"])(out.obs, ctx)
        elif m["name"] == "setup_s":
            value = out.setup_s
        else:
            value = out.e2e.get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(ctx.device, ctx.cell["chips"])
    dev["memory_peak_bytes"] = out.memory_peak_bytes
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    summary = out.obs.get("trace")
    if ctx.trace and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["span_s"]
        gaps = sorted(summary["idle_gaps_s"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {
            "device_ops": [[n, t] for n, t in list(summary["by_name_s"].items())[:10]],
            "idle_gaps": [[n, t] for n, t in gaps]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def now() -> float:
    return time.monotonic()
