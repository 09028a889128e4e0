"""The port's profiler spans (``utils/profiling.annotate``), on the CPU.

- Under ``device_trace`` the sampler, the composition, the loaders and the
  train step record their fixed spans, nested and ordered as the work runs.
- No loader span stays open while the consumer holds a batch.
- The outputs are the same with and without a profiler running.
- With no profiler running, ``annotate`` calls nothing of the profiler.
"""

import json

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.data import DataLoader, DeviceDataLoader
from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
from livelyspeaker_tpu_torch.models import SAG, RAG, CLIPTextConfig, CLIPTextEncoder, RAGConfig
from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline, RAGSampler
from livelyspeaker_tpu_torch.training import (TrainConfig, init_train_state, make_optimizer,
                                              make_train_step)
from livelyspeaker_tpu_torch.utils import profiling

KW = dict(latent_dim=16, num_layers=1, n_speakers=6)
CLIP = dict(vocab_size=64, context_length=8, width=16, layers=1, heads=2, embed_dim=16)
SAG_KW = dict(njoints=9, nfeats=3, latent_dim=16, ff_size=32, num_layers=1, num_heads=2)
B = 2
N_AUDIO = 36267  # 34 frames at 15 fps, 16 kHz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's CPU thread pool costs more than it gives here,
    and its spinning threads slow the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(tmp_path, fn):
    """(what ``fn()`` returns, the annotations it recorded under
    ``device_trace`` as (name, start, end) in start order)."""
    with profiling.device_trace(str(tmp_path)):
        out = fn()
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, [(name, ts, ts - neg) for ts, neg, name in spans]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _rag(seed=0):
    return RAG(RAGConfig.ted(**KW), generator=torch.Generator().manual_seed(seed))


def _cond(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"audio": 0.1 * torch.randn(B, N_AUDIO, generator=g),
            "vid": torch.randint(0, KW["n_speakers"], (B,), generator=g),
            "origin_x": torch.randn(B, 9, 3, 34, generator=g)}


class _Tokens:
    """A word's id is its length; the last id ends the sentence."""

    def __call__(self, sentences):
        ids = np.zeros((len(sentences), CLIP["context_length"]), np.int64)
        for i, s in enumerate(sentences):
            words = s.split()
            ids[i, :len(words)] = [len(w) for w in words]
            ids[i, len(words)] = CLIP["vocab_size"] - 1
        return ids


class _Pool:
    """Seeded windows in the record datasets' interface."""

    def __init__(self, n=8, seed=2):
        rng = np.random.default_rng(seed)
        self.host = {"motion": rng.normal(size=(n, 9, 3, 34)).astype(np.float32),
                     "audio": (0.1 * rng.normal(size=(n, N_AUDIO))).astype(np.float32),
                     "vid": rng.integers(0, KW["n_speakers"], size=(n,))}

    def __len__(self):
        return len(self.host["motion"])

    def batch(self, idx, fields=None):
        return {k: v[idx] for k, v in self.host.items() if fields is None or k in fields}


def _sample(method, steps=4):
    sampler = RAGSampler(_rag(), steps=20, timestep_respacing=f"ddim{steps}", method=method,
                         device="cpu")
    return lambda: sampler(_cond(), torch.Generator().manual_seed(3))


def _compose():
    g = torch.Generator().manual_seed(6)
    pipe = LivelySpeakerPipeline(
        _rag(), SAG(**SAG_KW, generator=g), CLIPTextEncoder(CLIPTextConfig(**CLIP), generator=g),
        _Tokens(), steps=20, timestep_respacing="ddim4", skip_timesteps=2, device="cpu")
    return lambda: pipe(["so we went", "and then"], _cond(), torch.Generator().manual_seed(3))


def _train(steps=1):
    model = _rag()
    cfg = TrainConfig(lr=1e-3)
    tx = make_optimizer(cfg)
    sched = DiffusionSchedule.create(steps=20)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=cfg,
                             num_timesteps=sched.num_timesteps)
    step = make_train_step(model, sched, tx, cfg)
    loader = DeviceDataLoader(_Pool(), B, seed=4, device="cpu")

    def run():
        nonlocal state
        losses = []
        for _, batch in zip(range(steps), loader):
            state, m = step(state, batch, torch.Generator().manual_seed(5))
            losses.append(m["loss"])
        params = [v.detach().reshape(-1) for v in state.params.values()]
        return torch.cat(params + [torch.tensor(losses)])

    return run


@pytest.mark.parametrize("method", ["ddim", "ddpm", "plms", "dpmpp"])
def test_sampler_records_one_step_span_a_reverse_step(tmp_path, method):
    """``rag.sample`` once, inside it ``rag.prepare`` once and then
    ``rag.step`` once a reverse step (PLMS's two-call first step is one)."""
    _, spans = _spans(tmp_path, _sample(method, steps=4))
    assert [s[0] for s in spans] == ["rag.sample", "rag.prepare"] + ["rag.step"] * 4
    assert all(_within(s, spans[0]) for s in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))  # one after another


def test_composition_records_sketch_spans_before_the_chain(tmp_path):
    _, spans = _spans(tmp_path, _compose())
    names = [s[0] for s in spans]
    assert names == ["compose.clip", "compose.sag", "rag.sample", "rag.prepare"] + \
        ["rag.step"] * 2
    assert spans[0][2] <= spans[1][1] and spans[1][2] <= spans[2][1]


def test_train_step_records_its_parts_in_order(tmp_path):
    """One step fed by ``DeviceDataLoader``: the loader's gather, the
    gradients, the host sync and the update, once each."""
    _, spans = _spans(tmp_path, _train())
    assert [s[0] for s in spans] == ["train.loader", "train.grads", "train.sync", "train.apply"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("make", [DeviceDataLoader, DataLoader])
def test_loader_span_is_closed_while_the_consumer_holds_a_batch(tmp_path, make):
    """Each batch's ``train.loader`` span ends before the consumer's code
    that follows ``next()`` starts (no span is open across a ``yield``)."""
    loader = make(_Pool(), B, seed=4, device="cpu")

    def consume():
        for batch in loader:
            with torch.profiler.record_function("consumer"):
                batch["motion"].sum()

    _, spans = _spans(tmp_path, consume)
    loads = [s for s in spans if s[0] == "train.loader"]
    users = [s for s in spans if s[0] == "consumer"]
    # the streaming loader's last wait, for the end of the epoch, is one more
    assert len(users) == len(loader) and len(loads) == len(loader) + (make is DataLoader)
    assert all(lo[2] <= use[1] for lo, use in zip(loads, users))
    assert not any(lo[1] < use[2] and use[1] < lo[2] for lo in loads for use in users)


@pytest.mark.parametrize("path", ["sample", "compose", "train"])
def test_outputs_equal_with_and_without_a_profiler(tmp_path, path):
    make = {"sample": lambda: _sample("ddim"), "compose": _compose, "train": _train}[path]
    plain = make()()
    traced, spans = _spans(tmp_path, make())
    assert spans
    assert torch.equal(plain, traced)


def test_annotate_calls_no_profiler_when_none_runs(monkeypatch, tmp_path):
    """With no profiler running ``annotate`` and every span of a sampled
    chain and a train step leave ``record_function`` uncalled; under a
    profiler the same calls reach it."""
    def refuse(*a, **kw):
        raise AssertionError("record_function called with no profiler running")

    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.annotate("rag.step"):
        pass
    _sample("ddim")()
    _train()()

    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    _spans(tmp_path, _sample("ddim", steps=2))
    assert calls == ["rag.sample", "rag.prepare", "rag.step", "rag.step"]
