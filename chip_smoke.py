"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Drives the port's two paths at the full TED width (latent 512, 8 blocks,
1400 speakers) with seeded random weights: RAG sampling behind the serving
batcher, and RAG training through TrainLoop with the fused backbone. Checks:

1. device: a CUDA card is required (no CPU run); TF32 is off for matmul
   and cuDNN, so every comparison below is f32 against f32;
2. build: the fused TransMLP kernel is compiled from csrc/ with nvcc;
3. kernel against plain version: TED (S=35, F=27) and BEAT (S=36, F=282),
   D=512, L=8, 2B in {16, 512}, LN2 folded and not, with and without the
   pose projection; rel = max|kernel - plain| / max|plain| <= 1e-5, and the
   time per call of both;
4. serving: build_rag_server with the default ServeConfig (DPM-Solver++ over
   ddim20, max_batch 8, guidance 1.5) answers 24 requests from 3 threads;
   every clip is finite [9, 3, 34], the kernel ran 20 times per batch served
   and the plain version never; then one served-size batch through the
   fused sampler agrees with the eager modules (cuBLAS) within rel 1e-4;
5. one BEAT batch (emotion conditioning) the same way;
6. the training kernels (forward with stash; per layer of the backward a
   block, a weight-gradient and a reduce kernel) against their plain
   versions at TED (S=35) and BEAT (S=36), D=512, L=8, silu, B in {64, 512}:
   forward and stash within rel 1e-5, every gradient within rel 1e-4 of its
   max|plain|, and the time per fwd+bwd call of both;
7. training: TrainLoop.run_loop() on RAGConfig.ted(fused_train_backbone=True)
   (its own seeded init), DDPM-1000 cosine, 30 steps at batch 512 on one
   fixed seeded batch, the default TrainConfig but lr 1e-3: every loss is
   finite, the mean of the last 5 is below that of the first 5, the forward
   kernel launched once a step and each backward kernel 8 times (once per
   layer) a step, the plain versions and K1 never; step ms, clips/s and
   peak memory;
8. the fused training loss against the eager one on a TED and a BEAT batch
   of 64 (BEAT with kld_weight 0), with the same t, noise, style and
   condition drop: loss within rel 1e-5, every parameter gradient within
   rel 1e-4 of its max (the three conv biases before an InstanceNorm, whose
   gradient is 0 in exact arithmetic, within 1e-4 of the largest gradient).

With ``--profile DIR`` it then profiles 3 training steps with torch.profiler
(a Chrome trace and a table of device time by kernel in DIR).

Exits non-zero at the first failure. The line before the last is the
kernels' JSON report; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

KERNEL_SOURCE = "livelyspeaker_tpu_torch/csrc/fused_transmlp.cu"
KERNEL_REPLACES = "livelyspeaker_tpu/ops/pallas/fused_mlp.py:215"
KERNEL_TOL = 1e-5  # f32 sums in another order than cuBLAS, over 8 blocks
SLICE_TOL = 1e-4  # 20 solver steps of the above, relative to max|x|
TRAIN_SOURCE = "livelyspeaker_tpu_torch/csrc/fused_transmlp_train.cu"
TRAIN_REPLACES = "livelyspeaker_tpu/ops/pallas/fused_mlp_train.py:257"
GRAD_TOL = 1e-4  # f32 sums over up to B*S = 18,432 rows in another order
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, LAYERS = 30, 512, 1e-3, 8
ZERO_GRAD = tuple(f"audio_encoder.conv{i}.bias" for i in range(3))


def check(ok, msg):
    if not ok:
        raise SystemExit(f"FAIL: {msg}")


def device_phase():
    check(torch.cuda.is_available(), "no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    from livelyspeaker_tpu_torch.ops._build import build_log, load_libraries

    names = ("fused_transmlp", "fused_transmlp_train")
    t0 = time.perf_counter()
    load_libraries(names)  # one nvcc per source, started together
    secs = time.perf_counter() - t0
    print(f"[build] {', '.join(names)} built and loaded in {secs:.2f} s")
    for name in names:
        for line in build_log(name).splitlines():
            if "Compiling" in line or "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")


def time_ms(fn, iters):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(card):
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
    from livelyspeaker_tpu_torch.ops import fused_mlp

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    worst_abs, main_ms, main_plain_ms = 0.0, None, None
    for name, seq, feats in (("TED", 35, 27), ("BEAT", 36, 282)):
        stack = random_normal_(TransMLP(seq, 8, 512, "silu"), g).to(dev)
        pose = random_normal_(torch.nn.Linear(512, feats), g).to(dev)
        for b2 in (16, 512):
            x = torch.randn(b2, seq, 512, generator=g).to(dev)
            emb = torch.randn(b2, 512, generator=g).to(dev)
            for fold in (False, True):
                packed = fused_mlp.pack_transmlp_params(stack, fold_ln2=fold)
                for op in (None, fused_mlp.pack_out_proj(pose)):
                    out = fused_mlp.fused_transmlp(x, emb, packed, out_proj=op)
                    ref = fused_mlp.fused_transmlp_reference(x, emb, packed, out_proj=op)
                    torch.cuda.synchronize()
                    err = (out - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    iters = 20 if b2 == 16 else 5
                    ms = time_ms(lambda: fused_mlp.fused_transmlp(x, emb, packed, out_proj=op), iters)
                    plain = time_ms(lambda: fused_mlp.fused_transmlp_reference(
                        x, emb, packed, out_proj=op), iters)
                    tag = (f"{name} 2B={b2} S={seq} D=512 L=8 ln2={'folded' if fold else 'affine'} "
                           f"out={'F=%d' % feats if op else 'D'}")
                    print(f"[kernel] {tag}: max_abs {err:.3e} max_rel {rel:.3e} "
                          f"kernel {ms:.4f} ms plain {plain:.4f} ms ({card})")
                    check(np.isfinite(rel) and rel <= KERNEL_TOL,
                          f"kernel disagrees with plain version at {tag}: rel {rel:.3e}")
                    worst_abs = max(worst_abs, err)
                    if name == "TED" and b2 == 16 and fold and op is not None:
                        main_ms, main_plain_ms = ms, plain  # the serving call
    return worst_abs, main_ms, main_plain_ms


def _random_model(cfg, seed):
    from livelyspeaker_tpu_torch.models import RAG
    from livelyspeaker_tpu_torch.models.initializers import random_normal_

    g = torch.Generator().manual_seed(seed)
    return random_normal_(RAG(cfg, generator=g), g).cuda().eval()


def _cond(cfg, rng, b):
    from livelyspeaker_tpu_torch.models import audio_samples_for_frames

    cond = {
        "audio": torch.from_numpy(
            (0.1 * rng.normal(size=(b, audio_samples_for_frames(cfg.nframes)))).astype(np.float32)),
        "vid": torch.from_numpy(rng.integers(0, cfg.n_speakers, size=(b,))),
        "origin_x": torch.from_numpy(
            rng.normal(size=(b, cfg.njoints, cfg.nfeats, cfg.nframes)).astype(np.float32)),
    }
    if cfg.num_emotions:
        cond["emo"] = torch.from_numpy(rng.integers(0, cfg.num_emotions, size=(b,)))
    return {k: v.cuda() for k, v in cond.items()}


def fused_vs_eager(model, cond, guidance, tag):
    """One batch through the fused sampler and the eager one, from the same
    seeded generator: same noise, same style draws."""
    from livelyspeaker_tpu_torch.ops import fused_mlp
    from livelyspeaker_tpu_torch.pipeline import RAGSampler
    from livelyspeaker_tpu_torch.serving import ServeConfig

    sc = ServeConfig()
    outs = []
    for use_fused in (True, False):
        sampler = RAGSampler(model, steps=sc.steps, timestep_respacing=sc.timestep_respacing,
                             method=sc.sampler, use_fused=use_fused)
        gen = torch.Generator(device="cuda").manual_seed(7)
        launches = fused_mlp.fused_transmlp.launches
        outs.append(sampler(cond, gen, guidance=guidance))
        torch.cuda.synchronize()
        check((fused_mlp.fused_transmlp.launches - launches) == (20 if use_fused else 0),
              f"{tag}: fused={use_fused} launched the kernel "
              f"{fused_mlp.fused_transmlp.launches - launches} times")
    fused, eager = outs
    c = model.cfg
    check(fused.shape == (cond["vid"].shape[0], c.njoints, c.nfeats, c.nframes), f"{tag}: shape")
    check(bool(torch.isfinite(fused).all()), f"{tag}: non-finite output")
    rel = ((fused - eager).abs().max() / eager.abs().max()).item()
    print(f"[{tag}] fused vs eager sampler, {tuple(fused.shape)}: rel {rel:.3e} (tol {SLICE_TOL})")
    check(rel <= SLICE_TOL, f"{tag}: fused path disagrees with the eager modules")


def serving_phase(card):
    from livelyspeaker_tpu_torch.models import RAGConfig
    from livelyspeaker_tpu_torch.ops import fused_mlp
    from livelyspeaker_tpu_torch.serving import ServeConfig, build_rag_server

    cfg = RAGConfig.ted()
    model = _random_model(cfg, seed=1)
    batcher = build_rag_server(model, ServeConfig())
    rng = np.random.default_rng(2)
    n_threads, per_thread = 3, 8
    audio = [(0.1 * rng.normal(size=batcher.n_samples)).astype(np.float32)
             for _ in range(n_threads * per_thread)]
    speakers = rng.integers(0, cfg.n_speakers, size=len(audio))
    guidances = rng.choice([1.0, 1.5, 2.0, 2.5], size=len(audio))
    results = [None] * len(audio)
    errors = []
    try:
        batcher.generate(audio[0], timeout=600)  # warm-up: cuBLAS, allocator
        batcher.reset_stats()
        fused_mlp.fused_transmlp.launches = 0
        fused_mlp.fused_transmlp_reference.calls = 0

        def client(k):
            try:
                reqs = []
                for j in range(per_thread):
                    i = k * per_thread + j
                    reqs.append((i, batcher.submit(audio[i], speaker=int(speakers[i]),
                                                   guidance=float(guidances[i]))))
                for i, r in reqs:
                    results[i] = r.wait(timeout=600)
            except BaseException as e:  # reported by the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = fused_mlp.fused_transmlp.launches
        plain_calls = fused_mlp.fused_transmlp_reference.calls
        stats = batcher.stats()
    finally:
        batcher.close()
    check(not errors, f"serving: a request failed: {errors[:1]}")
    check(all(not t.is_alive() for t in threads), "serving: a client thread hung")
    for r in results:
        check(r is not None and r.shape == (9, 3, 34) and np.isfinite(r).all(),
              "serving: a clip is missing, misshapen or non-finite")
    batches = stats["batches_served"]
    print(f"[serving] {len(audio)} requests from {n_threads} threads in {batches} batches "
          f"(occupancy {stats['mean_batch_occupancy']:.2f}): p50 {stats['latency_ms_p50']:.1f} ms "
          f"p95 {stats['latency_ms_p95']:.1f} ms, {len(audio) / wall:.2f} clips/s ({card})")
    print(f"[serving] fused_transmlp launches {launches}, plain version calls {plain_calls}")
    check(launches == 20 * batches, f"serving: {launches} launches for {batches} batches")
    check(plain_calls == 0, "serving: the plain version ran on the main path")

    guidance = torch.tensor([1.0, 1.5, 2.0, 2.5] * 2, device="cuda")
    fused_vs_eager(model, _cond(cfg, rng, 8), guidance, "serving-ted")
    return launches


def beat_phase():
    from livelyspeaker_tpu_torch.models import RAGConfig

    cfg = RAGConfig.beat()
    model = _random_model(cfg, seed=3)
    fused_vs_eager(model, _cond(cfg, np.random.default_rng(4), 8), 1.5, "beat")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def kernel_ms_by_name(fn, iters):
    """Device ms per call of ``fn`` for each training kernel it launches,
    from CUDA events recorded around every launch."""
    from livelyspeaker_tpu_torch.ops import fused_mlp_train

    launch, events = fused_mlp_train._launch, {}

    def timed(kernel, dev, *args, what):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(kernel, dev, *args, what=what)
        end.record()
        events.setdefault(kernel, []).append((start, end))

    fn()  # warm-up
    fused_mlp_train._launch = timed
    try:
        for _ in range(iters):
            fn()
    finally:
        fused_mlp_train._launch = launch
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in v) / iters for k, v in events.items()}


def train_kernel_phase(card):
    """The training kernels against their plain versions."""
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(10)
    worst = {"fwd": 0.0, "bwd": 0.0}
    report = {}
    for name, seq in (("TED", 35), ("BEAT", 36)):
        stack = random_normal_(TransMLP(seq, LAYERS, 512, "silu"), g).to(dev)
        with torch.no_grad():
            packed = {k: v.contiguous() for k, v in k2.pack_transmlp_train_params(stack).items()}
        for b in (64, 512):
            x = torch.randn(b, seq, 512, generator=g).to(dev)
            emb = torch.randn(b, 512, generator=g).to(dev)
            cot = torch.randn(b, seq, 512, generator=g).to(dev)
            out, stash = k2.fused_transmlp_train_forward(x, emb, packed)
            ref, ref_stash = k2.fused_transmlp_train_forward_reference(x, emb, packed)
            gx, gemb, grads = k2.fused_transmlp_train_backward(stash, emb, cot, packed)
            rgx, rgemb, rgrads = k2.fused_transmlp_train_backward_reference(
                ref_stash, emb, cot, packed)
            torch.cuda.synchronize()
            tag = f"{name} B={b} S={seq} D=512 L={LAYERS} silu"
            errs = {"out": (out, ref), "stash": (stash, ref_stash)}
            for k, (a, r) in errs.items():
                rel = _rel(a, r)
                worst["fwd"] = max(worst["fwd"], (a - r).abs().max().item())
                check(np.isfinite(rel) and rel <= KERNEL_TOL, f"train kernel {k} at {tag}: rel {rel:.3e}")
            rels = {"dx": _rel(gx, rgx), "d_emb": _rel(gemb, rgemb)}
            pairs = [(gx, rgx), (gemb, rgemb)] + [(grads[k], rgrads[k]) for k in k2.PACKED_KEYS]
            rels.update({k: _rel(grads[k], rgrads[k]) for k in k2.PACKED_KEYS})
            worst["bwd"] = max([worst["bwd"]] + [(a - r).abs().max().item() for a, r in pairs])
            for k, rel in rels.items():
                check(np.isfinite(rel) and rel <= GRAD_TOL, f"train kernel grad {k} at {tag}: rel {rel:.3e}")
            iters = 5 if b == 64 else 3
            fb = lambda: k2.fused_transmlp_train_backward(
                k2.fused_transmlp_train_forward(x, emb, packed)[1], emb, cot, packed)
            plain_f = lambda: k2.fused_transmlp_train_forward_reference(x, emb, packed)
            plain_fb = lambda: k2.fused_transmlp_train_backward_reference(
                plain_f()[1], emb, cot, packed)
            ms, plain_fwd, plain = time_ms(fb, iters), time_ms(plain_f, iters), time_ms(plain_fb, iters)
            per_kernel = kernel_ms_by_name(fb, iters)
            print(f"[train-kernel] {tag}: out rel {_rel(out, ref):.3e} stash rel "
                  f"{_rel(stash, ref_stash):.3e}; grad rel max {max(rels.values()):.3e} ("
                  + ", ".join(f"{k} {v:.1e}" for k, v in rels.items()) + ")")
            print(f"[train-kernel] {tag}: fwd+bwd kernels {ms:.3f} ms ("
                  + ", ".join(f"{k} {v:.3f}" for k, v in per_kernel.items())
                  + f"), plain {plain:.3f} ms (fwd {plain_fwd:.3f}) ({card})")
            if name == "TED" and b == TRAIN_BATCH:
                report = {"ms": per_kernel, "plain_fwd": plain_fwd, "plain_bwd": plain - plain_fwd}
    return worst, report


def _train_batch(cfg, rng, b):
    from livelyspeaker_tpu_torch.models import audio_samples_for_frames

    batch = {
        "motion": (0.3 * rng.normal(size=(b, cfg.njoints, cfg.nfeats, cfg.nframes))).astype(np.float32),
        "audio": (0.1 * rng.normal(size=(b, audio_samples_for_frames(cfg.nframes)))).astype(np.float32),
        "vid": rng.integers(0, cfg.n_speakers, size=(b,)),
    }
    if cfg.num_emotions:
        batch["emo"] = rng.integers(0, cfg.num_emotions, size=(b,))
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _reset_counts():
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2

    for k in k2.LAUNCHES:
        k2.LAUNCHES[k] = 0
    k2.fused_transmlp_train_forward_reference.calls = 0
    k2.fused_transmlp_train_backward_reference.calls = 0
    fused_mlp.fused_transmlp.launches = 0


def train_phase(card):
    """30 full-width TED steps at batch 512 through TrainLoop.run_loop()."""
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2
    from livelyspeaker_tpu_torch.training import TrainConfig
    from livelyspeaker_tpu_torch.training.loop import TrainLoop

    cfg = RAGConfig.ted(fused_train_backbone=True)
    model = RAG(cfg, generator=torch.Generator().manual_seed(5)).cuda()
    sched = DiffusionSchedule.create(steps=1000, schedule="cosine")
    batch = _train_batch(cfg, np.random.default_rng(6), TRAIN_BATCH)
    loop = TrainLoop(model, sched, None, [batch] * TRAIN_STEPS, cfg=TrainConfig(lr=TRAIN_LR),
                     num_epochs=1, log_interval=10, seed=7)
    losses, stamps = [], []
    step_fn = loop.step_fn

    def recorded(state, b, gen):  # the loss and the host clock after each step
        state, metrics = step_fn(state, b, gen)
        losses.append(metrics["loss"])
        stamps.append(time.perf_counter())
        return state, metrics

    loop.step_fn = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    loop.run_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k2.LAUNCHES)
    plain = (k2.fused_transmlp_train_forward_reference.calls,
             k2.fused_transmlp_train_backward_reference.calls)
    k1 = fused_mlp.fused_transmlp.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    check(len(losses) == TRAIN_STEPS, f"train: {len(losses)} steps ran, not {TRAIN_STEPS}")
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    steady = np.diff(stamps[4:]) * 1e3  # steps 6..30, after the warm-up
    print(f"[train] TED fused backbone, B={TRAIN_BATCH}, {TRAIN_STEPS} steps, lr {TRAIN_LR}: "
          f"loss first-5 mean {first:.5f} last-5 mean {last:.5f}; losses "
          + " ".join(f"{v:.4f}" for v in losses))
    print(f"[train] step {steady.mean():.2f} ms (median {np.median(steady):.2f}, steps 6-30), "
          f"{TRAIN_BATCH / steady.mean() * 1e3:.1f} clips/s, {wall:.2f} s for the whole run, "
          f"peak memory {peak_gib:.2f} GiB ({card})")
    print(f"[train] launches {launches} (per step: fwd 1, each backward kernel {LAYERS}); "
          f"plain versions {plain}; K1 {k1}")
    check(last < first, f"train: loss did not decrease ({first:.5f} -> {last:.5f})")
    check(launches["fwd"] == TRAIN_STEPS, f"train: forward kernel launched {launches['fwd']} times")
    for k in ("bwd_block", "wgrad", "reduce"):
        check(launches[k] == LAYERS * TRAIN_STEPS, f"train: {k} launched {launches[k]} times")
    check(plain == (0, 0) and k1 == 0, "train: a plain version or K1 ran on the training path")
    return launches, model, loop


def fused_vs_eager_train_phase():
    """The fused training loss and gradients against the eager modules."""
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2
    from livelyspeaker_tpu_torch.training import TrainConfig
    from livelyspeaker_tpu_torch.training.trainer import make_loss_fn

    sched = DiffusionSchedule.create(steps=1000, schedule="cosine").to("cuda")
    for tag, make_cfg, kld, seed in (("TED", RAGConfig.ted, 0.01, 11), ("BEAT", RAGConfig.beat, 0.0, 12)):
        g = torch.Generator().manual_seed(seed)
        eager = random_normal_(RAG(make_cfg(), generator=g), g).cuda()
        fused = RAG(make_cfg(fused_train_backbone=True)).cuda()
        fused.load_state_dict(eager.state_dict())
        cfg = eager.cfg
        rng = np.random.default_rng(seed)
        b = 64
        batch = _train_batch(cfg, rng, b)
        t = torch.from_numpy(rng.integers(0, 1000, size=(b,))).cuda()
        noise = torch.from_numpy(rng.normal(size=batch["motion"].shape).astype(np.float32)).cuda()
        style = torch.from_numpy(rng.normal(size=(b, 1, cfg.latent_dim)).astype(np.float32)).cuda()
        drop = torch.from_numpy((rng.random(b) < 0.1).astype(np.float32)).cuda()
        ones = torch.ones(b, device="cuda")
        out = []
        for m in (fused, eager):
            _reset_counts()
            params = dict(m.named_parameters())
            loss, _ = make_loss_fn(m, sched, TrainConfig(kld_weight=kld))(
                batch, t, ones, None, noise, style, drop)
            grads = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
            out.append((loss.item(), dict(zip(params, grads)), dict(k2.LAUNCHES)))
        (lf, gf, nf), (le, ge, ne) = out
        check(nf["fwd"] == 1 and nf["bwd_block"] == LAYERS and ne["fwd"] == 0,
              f"{tag} fused-vs-eager: launches fused {nf} eager {ne}")
        loss_rel = abs(lf - le) / abs(le)
        # a conv bias followed by InstanceNorm has gradient 0 in exact
        # arithmetic (the norm removes any per-channel constant): both
        # versions return round-off, held to GRAD_TOL of the largest gradient
        zero = [k for k in ge if k in ZERO_GRAD]
        top = max(v.abs().max().item() for v in ge.values())
        noise = max(max(gf[k].abs().max().item(), ge[k].abs().max().item()) for k in zero)
        grad_rel = {k: _rel(gf[k], ge[k]) for k in ge if k not in ZERO_GRAD}
        worst_k = max(grad_rel, key=grad_rel.get)
        print(f"[train-{tag.lower()}] fused vs eager, B={b}: loss {lf:.6f} vs {le:.6f} rel "
              f"{loss_rel:.3e} (tol 1e-5); worst gradient rel {grad_rel[worst_k]:.3e} at "
              f"{worst_k} (tol {GRAD_TOL}), over {len(grad_rel)} parameters; the "
              f"{len(zero)} zero-in-exact-arithmetic conv biases at most {noise:.3e} "
              f"(largest gradient {top:.3e})")
        check(loss_rel <= 1e-5, f"{tag}: fused loss disagrees with eager: rel {loss_rel:.3e}")
        check(grad_rel[worst_k] <= GRAD_TOL, f"{tag}: gradient of {worst_k} disagrees: "
              f"rel {grad_rel[worst_k]:.3e}")
        check(noise <= GRAD_TOL * top, f"{tag}: a conv bias before InstanceNorm has gradient "
              f"{noise:.3e}, not round-off of {top:.3e}")


def profile_phase(model, loop, out_dir, card):
    """torch.profiler over 3 training steps: device time by kernel class."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    batch = loop.data[0]
    loop.data = [batch] * 5
    loop.num_epochs = 1
    loop.run_loop()  # warm
    loop.data = [batch] * 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run_loop()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, "train_step_trace.json"))
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # ms
    classes = {"K2 forward": ("::fused_transmlp_train_fwd_kernel(",),
               "K2 backward block": ("::bwd_block_kernel(",),
               "K2 weight-gradient reductions": ("::wgrad_kernel(", "::reduce_kernel("),
               "cuDNN conv (WavEncoder)": ("conv", "cudnn", "xmma", "wgrad_alg", "dgrad_engine"),
               "AdamW and other foreach": ("foreach", "multi_tensor")}
    sums = {k: 0.0 for k in classes}
    sums["other"] = 0.0
    for e in kernels:
        key = next((c for c, pats in classes.items()
                    if any(p in e.key for p in pats)), "other")
        sums[key] += dev_time(e)
    busy = sum(sums.values())
    lines = [f"3 steps, B={TRAIN_BATCH}, wall {wall_ms:.2f} ms, device busy {busy:.2f} ms ({card})"]
    for k, v in sums.items():
        lines.append(f"{k}: {v / 3:.3f} ms/step, {100 * v / wall_ms:.1f}% of wall")
    lines.append(f"idle: {100 * (1 - busy / wall_ms):.1f}% of wall")
    lines.append("top kernels (ms over 3 steps):")
    for e in sorted(kernels, key=dev_time, reverse=True)[:25]:
        lines.append(f"  {dev_time(e):9.3f}  x{e.count:<5d} {e.key[:110]}")
    # the WavEncoder forward and backward alone, at the step's batch
    audio = batch["audio"]
    enc = lambda: model.audio_encoder(audio).sum().backward()
    lines.insert(len(sums) + 2, f"WavEncoder forward+backward alone: {time_ms(enc, 3):.3f} ms "
                 "(CUDA events, 3 calls)")
    model.zero_grad(set_to_none=True)
    text = "\n".join(lines)
    with open(os.path.join(out_dir, "train_step_profile.txt"), "w") as f:
        f.write(text + "\n")
    for line in lines[:len(sums) + 3]:
        print(f"[profile] {line}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile 3 training steps, writing the trace and a table to DIR")
    args = parser.parse_args()
    card = device_phase()
    build_phase()
    worst_abs, ms, plain_ms = kernel_phase(card)
    launches = serving_phase(card)
    beat_phase()
    train_worst, train_times = train_kernel_phase(card)
    train_launches, model, loop = train_phase(card)
    fused_vs_eager_train_phase()
    if args.profile:
        profile_phase(model, loop, args.profile, card)
    kernels = [{
        "name": "fused_transmlp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
    }]
    for k in ("fwd", "bwd_block", "wgrad", "reduce"):
        kernels.append({
            "name": f"fused_transmlp_train_{k}", "route": "cuda", "source": TRAIN_SOURCE,
            "replaces": TRAIN_REPLACES, "launches": train_launches[k],
            "max_abs_err": train_worst["fwd" if k == "fwd" else "bwd"],
            "ms": train_times["ms"][k],
            "plain_ms": train_times["plain_fwd" if k == "fwd" else "plain_bwd"],
        })
    print(json.dumps({"kernels": kernels}))
    print(f"[device] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
