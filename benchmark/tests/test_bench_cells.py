"""Each cell's harness path end to end at a tiny size on the CPU: set-up,
window, traced stretch, the comparison with the reference and the result
line; and with the timed path broken underneath, ``correct`` false."""

import pytest
import torch

from benchmark import harness

from .conftest import CELLS, tiny_ctx

SAMPLING = ("ted-serve-mb32", "beat-sample-ddim100-b256", "beat-compose-b64")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace):
    spec = harness.load_spec()
    ctx = tiny_ctx(cell, trace=trace)
    out = harness.run_cell(ctx)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    line = harness.result_line(spec, ctx, out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    if not trace:
        want = {m["name"] for m in harness.cell_metrics(spec, cell, False)}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:  # no kernel ran: the readers of the trace read nothing
        assert set(line["metrics"]) <= {"peak_gib.train"}
        if cell == "ted-serve-mb32":  # the batcher's counters over the stretch
            occupancy = harness.reader("occupancy.serve")(out.obs, ctx)
            assert 1 <= occupancy <= ctx.traffic["max_batch"]


def _sampler_fault(monkeypatch, fault):
    """Break the sampling path underneath the harness."""
    from livelyspeaker_tpu_torch import pipeline

    if fault == "stale_step":  # one denoiser step returns its state unchanged
        make = pipeline.make_fused_cfg_denoiser

        def stale(*a, **kw):
            denoise, calls = make(*a, **kw), [0]

            def step(x, t, generator=None):
                calls[0] += 1
                return x if calls[0] == 2 else denoise(x, t, generator)

            return step

        monkeypatch.setattr(pipeline, "make_fused_cfg_denoiser", stale)
        return
    call = pipeline.RAGSampler.__call__

    def broken(self, *a, **kw):
        out = call(self, *a, **kw).clone()
        if fault == "half_batch":  # the second half of the rows never computed
            h = (out.shape[0] + 1) // 2
            out[h:] = out[: out.shape[0] - h]
        else:  # one answer altered where it is produced
            out[0, 0, 0, -1] += 0.01 * float(out.abs().max())
        return out

    monkeypatch.setattr(pipeline.RAGSampler, "__call__", broken)


def _train_fault(monkeypatch, fault, sound_calls=0):
    """Break the training step underneath the harness, from its call
    ``sound_calls`` on."""
    from livelyspeaker_tpu_torch.training import loop, trainer

    if fault == "altered_answer":  # one leaf's gradient altered where produced
        update = trainer.AdamW.update

        def altered(self, grads, state, params, clip_norm=None):
            grads = dict(grads)
            grads["input_mapping.weight"] = grads["input_mapping.weight"] * 1.01
            return update(self, grads, state, params, clip_norm)

        monkeypatch.setattr(trainer.AdamW, "update", altered)
        return
    make = loop.make_train_step

    def broken_make(*a, **kw):
        step, calls = make(*a, **kw), [0]

        def run(state, batch, generator=None, **x):
            calls[0] += 1
            if calls[0] <= sound_calls:
                return step(state, batch, generator, **x)
            if fault == "half_batch":  # the mean taken over half of the batch
                h = batch["motion"].shape[0] // 2
                return step(state, {k: v[:h] for k, v in batch.items()}, generator,
                            **{k: v[:h] for k, v in x.items()})
            before = {k: v.detach().clone() for k, v in state.params.items()}
            new, m = step(state, batch, generator, **x)
            with torch.no_grad():  # a step that returns its state unchanged
                for k, v in new.params.items():
                    v.copy_(before[k])
            return new, m

        return run

    monkeypatch.setattr(loop, "make_train_step", broken_make)


@pytest.mark.parametrize("fault", ["stale_step", "half_batch", "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    if cell in SAMPLING:
        _sampler_fault(monkeypatch, fault)
    else:
        _train_fault(monkeypatch, fault)
    out = harness.run_cell(tiny_ctx(cell))
    assert not out.correct, out.checks


@pytest.mark.parametrize("fault", ["stale_step", "half_batch"])
def test_training_broken_only_in_the_window_is_not_correct(monkeypatch, fault):
    """A step that goes wrong only once set-up's steps are done (as a step
    captured or compiled after warm-up could) fails the window's check."""
    ctx = tiny_ctx("ted-train-b512")
    _train_fault(monkeypatch, fault, sound_calls=3 + ctx.traffic["warmup_steps"])
    out = harness.run_cell(ctx)
    assert not out.correct, out.checks
    setup = {k: v for k, v in out.checks.items() if not k.startswith("window_")}
    assert all(v <= lim for v, lim in setup.values()), setup
