"""The readers of the program's spans (``benchmark/spans.py``) on
synthetic traces: idle gaps go to the innermost span open at their
midpoint, a cell's ``idle_*`` metrics sum to its ``idle``, blocking calls
count only inside a span on its own thread, and with no span every reader
reads nothing."""

import pytest

from benchmark import arith, harness, spans


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def kernel(ts, dur, corr=None):
    return ev("kernel", "k", ts, dur, tid=7, corr=corr)


# A sampled batch over 0..200 us: the card idles 0-10 (no span), 20-30
# (rag.prepare), 50-60 and 80-100 (rag.step), 120-130 (rag.sample alone)
# and 140-200 (after rag.sample, the harness's own code).
SAMPLE = [ev("cpu_op", "aten::empty", 0.0, 1.0),
          ev("user_annotation", "rag.sample", 6.0, 130.0),
          ev("user_annotation", "rag.prepare", 12.0, 26.0),
          ev("user_annotation", "rag.step", 40.0, 30.0),
          ev("user_annotation", "rag.step", 75.0, 40.0),
          ev("user_annotation", "harness", 150.0, 5.0),  # not the program's
          ev("cuda_runtime", "cudaLaunchKernel", 13.0, 1.0, corr=1),
          ev("cuda_runtime", "cudaStreamSynchronize", 20.0, 10.0),
          ev("cuda_runtime", "cudaLaunchKernel", 31.0, 1.0, corr=2),
          ev("cuda_runtime", "cudaMemcpy", 85.0, 2.0, tid=2),  # another thread
          ev("cuda_runtime", "cudaDeviceSynchronize", 140.0, 60.0),  # outside the spans
          kernel(10.0, 10.0, corr=1), kernel(30.0, 20.0, corr=2), kernel(60.0, 20.0),
          kernel(100.0, 20.0), kernel(130.0, 10.0)]


def obs_of(events, **traced):
    return {"trace": arith.trace_summary(events), "trace_events": events,
            "traced": traced or {"batches": 1}}


def test_gaps_go_to_the_innermost_open_span():
    shares = spans.idle_by_stage(SAMPLE)
    span = 200.0
    assert shares["prepare"] == pytest.approx(100 * 10 / span)
    assert shares["step"] == pytest.approx(100 * 30 / span)
    # before rag.sample, rag.sample's own gap and the harness's
    assert shares["other"] == pytest.approx(100 * (10 + 10 + 60) / span)
    assert shares["sketch"] == shares["loader"] == 0.0


@pytest.mark.parametrize("cell,stages", [
    ("sample", ("step", "prepare", "other")),
    ("compose", ("step", "prepare", "sketch", "other")),
    ("train", ("loader", "grads", "update", "other")),
])
def test_a_cells_idle_metrics_sum_to_its_idle(cell, stages):
    events = list(SAMPLE)
    if cell == "compose":  # the sketch before the chain
        events = [ev("user_annotation", "compose.clip", 0.0, 4.0),
                  ev("user_annotation", "compose.sag", 4.5, 0.5)] + events
    if cell == "train":
        events = [dict(e, name={"rag.prepare": "train.loader", "rag.step": "train.grads",
                                "rag.sample": "train.apply"}.get(e["name"], e["name"]))
                  for e in events]
        events.append(ev("user_annotation", "train.sync", 79.0, 1.0))
    obs = obs_of(events)
    parts = [harness.reader(f"idle_{s}.{cell}")(obs, None) for s in stages]
    assert all(p is not None for p in parts)
    assert sum(parts) == pytest.approx(harness.reader(f"idle.{cell}")(obs, None))


def test_a_stage_with_no_span_reads_nothing():
    obs = obs_of(SAMPLE)
    assert harness.reader("idle_sketch.compose")(obs, None) is None
    assert harness.reader("idle_loader.train")(obs, None) is None
    assert harness.reader("sketch_ms.compose")(obs, None) is None


def test_blocking_calls_inside_spans_on_their_thread():
    """The stream synchronise inside rag.prepare counts; the copy on
    another thread and the harness's synchronise outside every span do
    not."""
    assert spans.blocking_calls(SAMPLE) == 1
    obs = obs_of(SAMPLE, batches=2)
    assert harness.reader("syncs.sample")(obs, None) == 0.5


def test_device_ms_of_a_span_per_unit():
    obs = obs_of(SAMPLE, batches=2)
    assert harness.reader("prepare_ms.sample")(obs, None) == pytest.approx(1e-3 * 30 / 2)


@pytest.mark.parametrize("name", ["idle_step.sample", "idle_other.train", "prepare_ms.sample",
                                  "sketch_ms.compose", "syncs.compose"])
def test_no_program_span_reads_nothing(name):
    events = [e for e in SAMPLE if e["name"] not in spans.SPANS]
    assert harness.reader(name)(obs_of(events), None) is None
    assert harness.reader(name)({}, None) is None
