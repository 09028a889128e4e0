"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Drives the port's paths at the full TED width (latent 512, 8 blocks,
1400 speakers) with seeded random weights: RAG sampling behind the serving
batcher, RAG training through TrainLoop with the fused backbone, and the
same training with the WavEncoder swapped for the fused WavEncoder stack
(K3). Checks:

1. device: a CUDA card is required (no CPU run); TF32 is off for matmul
   and cuDNN, so every comparison below is f32 against f32;
2. build: the three CUDA sources of csrc/ are compiled with nvcc, one
   process each, started together;
3. kernel against plain version: TED (S=35, F=27) and BEAT (S=36, F=282),
   D=512, L=8, 2B in {2, 16, 64, 512}, LN2 folded and not, with and
   without the pose projection; rel = max|kernel - plain| / max|plain| <=
   1e-5, the time per call of both, the bound (FLOPs at the f32 peak) and
   the share of it; at 2B in {2, 16, 512} the kernel at clusters of 8 and 4
   CTAs, timed in turns;
4. serving: build_rag_server with the default ServeConfig (DPM-Solver++ over
   ddim20, max_batch 8, guidance 1.5) answers 24 requests from 3 threads;
   every clip is finite [9, 3, 34], the kernel ran 20 times per batch served
   and the plain version never; then one served-size batch through the
   fused sampler agrees with the eager modules (cuBLAS) within rel 1e-4;
5. one BEAT batch (emotion conditioning) the same way;
6. the training kernels (the cluster kernel with a stash as the forward; per
   layer of the backward a cluster block kernel, a 3xTF32 tensor-core
   weight-gradient kernel and a reduce kernel) against their plain versions
   at TED (S=35) and BEAT (S=36), D=512, L=8, silu, B in {64, 512}: forward
   and stash within rel 1e-5, every gradient within rel 1e-4 of its
   max|plain|, a second run with the same bits, the time per fwd+bwd call of
   both, the forward and the block kernel at clusters of 8 and 4 CTAs in
   turns; then the weight-gradient and reduce kernels alone, 8 launches,
   against 8 calls of torch.matmul(h2.T, g_m2) and of part.sum(0), in turns;
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
   gradient is 0 in exact arithmetic, within 1e-4 of the largest gradient);
   then the model with K2 and the K3 drop-in against the same eager model:
   loss within rel 1e-5, every gradient outside the WavEncoder within rel
   1e-4, and the WavEncoder's against K3's plain backward on the eager
   model's feature cotangent (the eager encoder's own gradients are printed
   with the number of LeakyReLU inputs whose sign the two forwards round
   differently: the gradient jumps at the kink);
9. the K3 kernels (six forward launches, thirteen backward) against their
   plain versions at L = 36,267, B in {8, 512}: forward within rel 1e-5;
   backward on the same residuals, d_wav and every weight and conv3 bias
   gradient within rel 1e-4 of its max, the pre-IN biases within 1e-4 of
   the largest gradient; the time of both, and of each kernel;
10. training through K3 and K2: 7. with the WavEncoder swapped for
   FusedWavEncoder before the TrainLoop is built: finite, decreasing
   losses; each K3 kernel launched as often a step as one forward and one
   backward launch it; the K3 plain versions and F.conv1d never called;
11. one served-size TED batch (8) through RAGSampler with the K3 drop-in
   against the same sampler on the cuDNN encoder, within rel 1e-4.

With ``--profile DIR`` it also profiles a second burst of the 24 serving
requests and 3 steps of each training run with torch.profiler (Chrome
traces and tables of device time by kernel, and the idle share, in DIR),
and prints the kernels cuBLAS runs for the weight-gradient product.

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
TRAIN_FWD_SOURCE = KERNEL_SOURCE  # the cluster kernel, with a stash pointer
TRAIN_REPLACES = "livelyspeaker_tpu/ops/pallas/fused_mlp_train.py:257"
GRAD_TOL = 1e-4  # f32 sums over up to B*S = 18,432 rows in another order
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, LAYERS = 30, 512, 1e-3, 8
WAV_SOURCE = "livelyspeaker_tpu_torch/csrc/fused_wav.cu"
WAV_REPLACES = "livelyspeaker_tpu/ops/pallas/fused_wav.py:468"
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

    names = ("fused_transmlp", "fused_transmlp_train", "fused_wav")
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


PEAK_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM at 700 W (data sheet)
PEAK_TF32 = 495e12  # TF32 on the tensor cores, dense, H100 SXM at 700 W
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM


def bound(flop, nbytes, peak=PEAK_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for
    ``flop`` operations at ``peak`` (default f32 outside the tensor cores)
    and ``nbytes`` of device memory traffic."""
    t_ops, t_bytes = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_cost(x, emb, packed, op):
    """(FLOP, bytes) of one K1 call: the token mix, channel mix and pose
    products (the LayerNorms, activations and residuals, under 3% at D=512,
    are left out); every input read once, the output written once."""
    b, s, d = x.shape
    layers = packed["token_w"].shape[0]
    f = op["out_w"].shape[1] if op is not None else 0
    flop = b * (layers * (2 * s * d * d + 2 * s * s * d) + 2 * s * d * f)
    tensors = [x, emb, *packed.values(), *(op.values() if op is not None else ())]
    nbytes = 4 * (sum(t.numel() for t in tensors) + b * s * (f or d))
    return flop, nbytes


def time_turns(fns, iters, rounds=2):
    """ms per call of each of ``fns``, timed in turns (a b b a ...) inside
    one process; the mean of the rounds."""
    order = list(fns) + list(fns)[::-1]
    acc = {k: [] for k in fns}
    for _ in range(rounds // 2 or 1):
        for k in order:
            acc[k].append(time_ms(fns[k], iters))
    return {k: float(np.mean(v)) for k, v in acc.items()}


def kernel_phase(card):
    """K1 against its plain version at TED and BEAT, 2B in {2, 16, 64,
    512}, LN2 folded and affine, with and without the pose projection;
    then the cluster sizes the kernel takes at D=512, in turns."""
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
    from livelyspeaker_tpu_torch.ops import fused_mlp

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    worst_abs, main = 0.0, None
    for d in (512, 256, 128):  # every cluster size the kernel takes
        print(f"[kernel] clusters the card holds at once at D={d}, by cluster size: "
              f"{fused_mlp.resident_clusters(d, dev)} ({card})")
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2

    print(f"[kernel] clusters of the K2 weight-gradient kernel the card holds at once, by "
          f"cluster size: {k2.wgrad_resident_clusters(dev)} ({card})")
    resident = fused_mlp.resident_clusters(512, dev)
    for name, seq, feats in (("TED", 35, 27), ("BEAT", 36, 282)):
        stack = random_normal_(TransMLP(seq, 8, 512, "silu"), g).to(dev)
        pose = random_normal_(torch.nn.Linear(512, feats), g).to(dev)
        for b2 in (2, 16, 64, 512):
            x = torch.randn(b2, seq, 512, generator=g).to(dev)
            emb = torch.randn(b2, 512, generator=g).to(dev)
            geo = fused_mlp.transmlp_geometry(b2, seq, 512, resident)
            for fold in (False, True):
                packed = fused_mlp.pack_transmlp_params(stack, fold_ln2=fold)
                for op in (None, fused_mlp.pack_out_proj(pose)):
                    out = fused_mlp.fused_transmlp(x, emb, packed, out_proj=op)
                    ref = fused_mlp.fused_transmlp_reference(x, emb, packed, out_proj=op)
                    torch.cuda.synchronize()
                    err = (out - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    iters = 20 if b2 <= 64 else 5
                    ms = time_ms(lambda: fused_mlp.fused_transmlp(x, emb, packed, out_proj=op), iters)
                    plain = time_ms(lambda: fused_mlp.fused_transmlp_reference(
                        x, emb, packed, out_proj=op), iters)
                    flop, nbytes = k1_cost(x, emb, packed, op)
                    bound_ms, bound_by = bound(flop, nbytes)
                    tag = (f"{name} 2B={b2} S={seq} D=512 L=8 ln2={'folded' if fold else 'affine'} "
                           f"out={'F=%d' % feats if op else 'D'}")
                    print(f"[kernel] {tag}: max_abs {err:.3e} max_rel {rel:.3e} kernel {ms:.4f} ms "
                          f"plain {plain:.4f} ms bound {bound_ms:.4f} ms ({flop / 1e9:.3f} GFLOP, "
                          f"{bound_by}) share {bound_ms / ms:.1%}; cluster {geo.cluster} x "
                          f"{geo.cols} columns ({card})")
                    check(np.isfinite(rel) and rel <= KERNEL_TOL,
                          f"kernel disagrees with plain version at {tag}: rel {rel:.3e}")
                    worst_abs = max(worst_abs, err)
                    if name == "TED" and b2 == 16 and fold and op is not None:
                        main = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                                "bound_by": bound_by}  # the serving call
            # the cluster sizes D=512 allows (Dc <= 128), at the serving layout
            packed = fused_mlp.pack_transmlp_params(stack, fold_ln2=True)
            op = fused_mlp.pack_out_proj(pose)
            if b2 in (2, 16, 512):
                runs = {n: (lambda n=n: fused_mlp.launch_stack(x, emb, packed, 0, op, cluster=n))
                        for n in (8, 4)}
                times = time_turns(runs, 20 if b2 <= 16 else 5, rounds=4)
                print(f"[kernel] {name} 2B={b2} folded F={feats}, by cluster size (in turns): "
                      + ", ".join(f"{n} CTAs {t:.4f} ms" for n, t in times.items())
                      + f"; transmlp_geometry picks {geo.cluster} ({card})")
    return worst_abs, main


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


def _burst(batcher, audio, speakers, guidances, n_threads):
    """Every request of ``audio`` submitted from ``n_threads`` client
    threads at once; (results, errors, wall seconds, threads)."""
    per_thread = len(audio) // n_threads
    results, errors = [None] * len(audio), []

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
    return results, errors, time.perf_counter() - t0, threads


def serving_phase(card, profile_dir=None):
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
    try:
        batcher.generate(audio[0], timeout=600)  # warm-up: cuBLAS, allocator
        batcher.reset_stats()
        fused_mlp.fused_transmlp.launches = 0
        fused_mlp.fused_transmlp_reference.calls = 0
        results, errors, wall, threads = _burst(batcher, audio, speakers, guidances, n_threads)
        launches = fused_mlp.fused_transmlp.launches
        plain_calls = fused_mlp.fused_transmlp_reference.calls
        stats = batcher.stats()
        if profile_dir and not errors:
            serving_profile(batcher, audio, speakers, guidances, n_threads, profile_dir, card)
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


def _device_table(prof, classes, wall_ms, title, steps, unit):
    """Device time by kernel class from a torch.profiler run: lines of a
    table (ms per ``unit``, share of wall, launches), the idle share and
    the top kernels, and the launches of each class."""
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # ms
    sums = {k: 0.0 for k in classes}
    sums["other"] = 0.0
    counts = dict.fromkeys(sums, 0)
    for e in kernels:
        key = next((c for c, pats in classes.items() if any(p in e.key for p in pats)), "other")
        sums[key] += dev_time(e)
        counts[key] += e.count
    busy = sum(sums.values())
    lines = [f"{title}, wall {wall_ms:.2f} ms, device busy {busy:.2f} ms"]
    for k, v in sums.items():
        lines.append(f"{k}: {v / steps:.3f} ms/{unit}, {100 * v / wall_ms:.1f}% of wall, "
                     f"{counts[k]} launches")
    lines.append(f"idle: {100 * (1 - busy / wall_ms):.1f}% of wall")
    head = len(lines)
    lines.append(f"top kernels (ms over {steps} {unit}s):")
    for e in sorted(kernels, key=dev_time, reverse=True)[:25]:
        lines.append(f"  {dev_time(e):9.3f}  x{e.count:<5d} {e.key[:110]}")
    return lines, head, counts


def serving_profile(batcher, audio, speakers, guidances, n_threads, out_dir, card):
    """torch.profiler over one more burst of the same requests: device time
    by kernel class and the idle share, into DIR/serving_trace.json and
    DIR/serving_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    batches0 = batcher.stats()["batches_served"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results, errors, wall, _ = _burst(batcher, audio, speakers, guidances, n_threads)
        torch.cuda.synchronize()
    check(not errors and all(r is not None for r in results), "serving profile: a request failed")
    batches = batcher.stats()["batches_served"] - batches0
    prof.export_chrome_trace(os.path.join(out_dir, "serving_trace.json"))
    classes = {"K1 fused_transmlp": ("fused_transmlp_cluster_kernel",),
               "cuDNN conv (WavEncoder)": ("cudnn", "convolve", "fprop_implicit"),
               "cuBLAS GEMM": ("_gemm_", "cublas", "gemv", "gemmk")}
    lines, head, counts = _device_table(
        prof, classes, wall * 1e3, f"serving burst: {len(audio)} requests, {batches} batches "
        f"({card})", batches, "batch")
    lines.insert(1, f"{len(audio) / wall:.2f} clips/s under the profiler")
    with open(os.path.join(out_dir, "serving_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:head + 1]:
        print(f"[profile] {line}")
    k1 = counts["K1 fused_transmlp"]
    check(k1 == 20 * batches, f"serving profile: {k1} K1 kernels for {batches} batches")


def beat_phase():
    from livelyspeaker_tpu_torch.models import RAGConfig

    cfg = RAGConfig.beat()
    model = _random_model(cfg, seed=3)
    fused_vs_eager(model, _cond(cfg, np.random.default_rng(4), 8), 1.5, "beat")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def kernel_ms_by_name(fn, iters, module=None):
    """Device ms per call of ``fn`` for each kernel of ``module`` (default
    the training kernels' ``fused_mlp_train``) it launches, from CUDA events
    recorded around every launch."""
    from livelyspeaker_tpu_torch.ops import fused_mlp_train

    module = module or fused_mlp_train
    launch, events = module._launch, {}

    def timed(kernel, dev, *args, what):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(kernel, dev, *args, what=what)
        end.record()
        events.setdefault(kernel, []).append((start, end))

    fn()  # warm-up
    module._launch = timed
    try:
        for _ in range(iters):
            fn()
    finally:
        module._launch = launch
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in v) / iters for k, v in events.items()}


def k2_cost(b, s, d, layers):
    """(operations, bytes, peak) of each K2 kernel over one forward and one
    backward call (all its launches), from the shapes: the products' FLOPs
    (the LayerNorms and activations left out) at the f32 peak, except the
    weight-gradient kernel's three TF32 products (3xTF32) at the TF32 peak;
    each kernel's inputs read once, its outputs written once."""
    act = b * s * d  # one [B, S, D] tensor, in floats
    weights = layers * (d * d + 5 * d + s * s + s)
    part = b * (5 * d + s + s * s)
    fwd = (b * layers * (2 * s * d * d + 2 * s * s * d), 4 * (2 * act + b * d + weights + layers * act))
    # per layer: the channel mix recomputed and g_m2 @ ch_w^T (two D x D
    # products), the token mix, its data and weight gradients (three S x S);
    # it reads the stash, g and emb and writes g_a, h2 and g_m2 (its two
    # scratch tensors, read by the weight-gradient kernel), d emb and part
    blk = (b * (4 * s * d * d + 6 * s * s * d),
           4 * (5 * act + 2 * b * d + weights // layers + part))
    wgr = (3 * 2 * b * s * d * d, 4 * (2 * act + d * d))  # reads h2, g_m2; writes d ch_w
    red = (part, 4 * (part + 5 * d + s + s * s))  # reads part; writes 7 gradients
    cost = {"fwd": fwd + (PEAK_FLOPS,)}
    for k, (f, n), peak in (("bwd_block", blk, PEAK_FLOPS), ("wgrad", wgr, PEAK_TF32),
                            ("reduce", red, PEAK_FLOPS)):
        cost[k] = (layers * f, layers * n, peak)
    return cost


def graphed(fn):
    """``fn``'s launches captured once in a CUDA graph; the returned
    function replays them, so that CUDA events around it time the device
    and not the host's Python between the launches."""
    fn()  # warm-up: builds, binds, allocates outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def wgrad_reduce_turns(card, name, seq, b):
    """The weight-gradient and reduce kernels alone, LAYERS launches each,
    against one PyTorch call that computes the same function, LAYERS times:
    torch.matmul(h2.T, g_m2) (cuBLAS, f32, TF32 off) and part.sum(0); each
    sequence of launches replayed from a CUDA graph, timed in turns
    (kernel, library, library, kernel). Each result is checked first.
    Returns {kernel: (kernel ms, library ms)}."""
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2

    g = torch.Generator().manual_seed(40 + b + seq)
    d, rows = 512, b * seq
    h2 = torch.randn(rows, d, generator=g).cuda()
    gm2 = torch.randn(rows, d, generator=g).cuda()
    part = torch.randn(b, 5 * d + seq + seq * seq, generator=g).cuda()
    dcw = k2.channel_mix_wgrad(h2, gm2)
    sums = k2.reduce_partials(part, seq, d)
    wrel = _rel(dcw.double(), h2.double().t() @ gm2.double())
    want = k2.reduce_partials(part.double().cpu(), seq, d)
    rrel = max(_rel(sums[k].double().cpu(), want[k]) for k in want)
    check(wrel <= GRAD_TOL and rrel <= GRAD_TOL,
          f"{name} B={b}: wgrad rel {wrel:.3e}, reduce rel {rrel:.3e} against f64")
    times = {
        "wgrad": time_turns({
            "kernel": graphed(lambda: [k2.channel_mix_wgrad(h2, gm2, out=dcw)
                                       for _ in range(LAYERS)]),
            "library": graphed(lambda: [torch.matmul(h2.t(), gm2) for _ in range(LAYERS)])}, 10),
        "reduce": time_turns({
            "kernel": graphed(lambda: [k2.reduce_partials(part, seq, d, sums)
                                       for _ in range(LAYERS)]),
            "library": graphed(lambda: [part.sum(0) for _ in range(LAYERS)])}, 20),
    }
    geo = k2.wgrad_geometry(rows, d, k2.wgrad_resident_clusters(torch.device("cuda")))
    print(f"[train-kernel] {name} B={b} S={seq} D={d}, {LAYERS} launches in turns: wgrad "
          f"{times['wgrad']['kernel']:.4f} ms (rel {wrel:.1e} against f64; {geo.tiles} tiles x "
          f"clusters of {geo.cluster}) against torch.matmul(h2.T, g_m2) "
          f"{times['wgrad']['library']:.4f} ms; reduce {times['reduce']['kernel']:.4f} ms (rel "
          f"{rrel:.1e}) against part.sum(0) {times['reduce']['library']:.4f} ms; CUDA graphs "
          f"({card})")
    return {k: (v["kernel"], v["library"]) for k, v in times.items()}


def wgrad_library_probe(card, out_dir):
    """What cuBLAS runs for the weight-gradient product at TED B=512
    (torch.matmul(h2.T, g_m2), [17920, 512] each, f32, TF32 off): its time
    per call (CUDA events) and, from a torch.profiler trace of three calls,
    each kernel's name, grid, block and device time. Then the library time
    of the sums the reduce kernel computed: part.sum(0) on [B, 5D + S + S^2]
    and, for the weight-gradient partials of the design before this one,
    wpart.sum(0) on [min(16, ceil(B*S / 1024)), D, D], at TED and BEAT, B in
    {64, 512}. The trace goes to DIR/cublas_wgrad_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    g = torch.Generator().manual_seed(30)
    rows, d = TRAIN_BATCH * 35, 512
    h2 = torch.randn(rows, d, generator=g).cuda()
    gm2 = torch.randn(rows, d, generator=g).cuda()
    mm = lambda: torch.matmul(h2.t(), gm2)
    ms = time_ms(mm, 20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            mm()
        torch.cuda.synchronize()
    path = os.path.join(out_dir, "cublas_wgrad_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print(f"[cublas] torch.matmul(h2.T, g_m2) at [{rows}, {d}] f32, TF32 off: {ms:.4f} ms a "
          f"call ({card}); {len(kernels)} kernels in 3 calls:")
    for e in kernels:
        args = e.get("args", {})
        print(f"[cublas]   {e['name']} grid {args.get('grid')} block {args.get('block')} "
              f"smem {args.get('shared memory')} regs {args.get('registers per thread')} "
              f"{e.get('dur')} us")
    for name, s in (("TED", 35), ("BEAT", 36)):
        for b in (64, TRAIN_BATCH):
            part = torch.randn(b, 5 * d + s + s * s, generator=g).cuda()
            nsplit = min(16, -(-b * s // 1024))
            wpart = torch.randn(nsplit, d, d, generator=g).cuda()
            t = time_turns({"part": lambda: part.sum(0), "wpart": lambda: wpart.sum(0)}, 50)
            print(f"[cublas] {name} B={b}: part.sum(0) on {list(part.shape)} {t['part']:.4f} ms, "
                  f"wpart.sum(0) on {list(wpart.shape)} {t['wpart']:.4f} ms a call ({card})")


def k3_cost(b, length):
    """(FLOP, bytes) of each K3 kernel over one forward and one backward
    call without d_wav (all its launches), from the shapes: the convs'
    FLOPs, conv0 counted once wherever a kernel recomputes it; each
    kernel's inputs read once, its outputs written once."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    ch = k3.CHANNELS
    conv = [2 * b * t[i] * ch[i + 1] * ch[i] * 15 for i in range(4)]  # FLOP of conv i
    size = [b * t[i] * ch[i + 1] for i in range(4)]  # floats of conv i's output
    wts = [ch[i + 1] * ch[i] * 15 + ch[i + 1] for i in range(4)]
    wav = b * length
    cost = {
        "stats0": (conv[0], 4 * (wav + wts[0] + 2 * b * 32)),
        "conv_fwd": (sum(conv), 4 * (wav + wts[0] + sum(wts[1:]) + sum(size[1:]) + size[1] + size[2])),
        "stats": (3 * (size[1] + size[2]), 4 * (size[1] + size[2])),
        "in_bwd": (6 * (size[1] + size[2]), 4 * 3 * (size[1] + size[2])),
    }
    # weight and data gradients of conv1..3 (conv0 recomputed for conv1);
    # the row-chunk partials of the weight gradients, as the wrapper splits
    nparts = [b] + [k3._wgrad_split(b * t[i], ch[i] // 8 * -(-ch[i + 1] // 64))[0]
                    for i in (1, 2, 3)]
    parts = sum(n * w for n, w in zip(nparts, wts))
    inputs, cots = wav + size[1] + size[2], size[1] + size[2] + size[3]
    cost["wgrad"] = (sum(conv), 4 * (inputs + cots + parts - nparts[0] * wts[0]))
    cost["bwd_data"] = (sum(conv), 4 * (inputs + cots + sum(wts[1:]) + size[0] + size[1] + size[2]))
    cost["wgrad0"] = (2 * conv[0], 4 * (wav + size[0] + nparts[0] * wts[0]))
    cost["reduce"] = (parts, 4 * (parts + sum(wts)))
    return cost


def train_kernel_phase(card):
    """The training kernels against their plain versions."""
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2

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
            again = k2.fused_transmlp_train_backward(
                k2.fused_transmlp_train_forward(x, emb, packed)[1], emb, cot, packed)
            torch.cuda.synchronize()
            tag = f"{name} B={b} S={seq} D=512 L={LAYERS} silu"
            same = (torch.equal(gx, again[0]) and torch.equal(gemb, again[1])
                    and all(torch.equal(grads[k], again[2][k]) for k in k2.PACKED_KEYS))
            check(same, f"train kernels at {tag}: a second run gave other bits")
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
            by_cluster = {}
            picks = (fused_mlp.transmlp_geometry(
                         b, seq, 512, fused_mlp.resident_clusters(512, dev)).cluster,
                     k2.backward_geometry(
                         b, seq, 512, k2.backward_resident_clusters(512, dev)).cluster)
            for n in (8, 4):
                run = lambda n=n: k2.fused_transmlp_train_backward(
                    k2.fused_transmlp_train_forward(x, emb, packed, cluster=n)[1], emb, cot,
                    packed, cluster=n)
                by_cluster[n] = kernel_ms_by_name(run, iters)
            print(f"[train-kernel] {tag}, by cluster size: " + ", ".join(
                f"{n} CTAs fwd {v['fwd']:.3f} bwd_block {v['bwd_block']:.3f} ms"
                for n, v in by_cluster.items())
                + f"; the geometry picks {picks[0]} and {picks[1]} ({card})")
            turns = wgrad_reduce_turns(card, name, seq, b)
            if name == "TED" and b == TRAIN_BATCH:
                # wgrad and reduce: device time of their launches alone, from
                # the same graph replays as the library calls they are held to
                report = {"ms": {**per_kernel, **{k: v[0] for k, v in turns.items()}},
                          "plain_fwd": plain_fwd, "plain_bwd": plain - plain_fwd,
                          "library": {k: v[1] for k, v in turns.items()},
                          "bound": {k: bound(*c) for k, c in k2_cost(b, seq, 512, LAYERS).items()}}
                print("[train-kernel] " + tag + ": bound by kernel, ms per fwd+bwd call (wgrad: "
                      "its three TF32 products at 495 TFLOP/s): " + ", ".join(
                          f"{k} {v[0]:.3f} ({v[1]}, share {v[0] / report['ms'][k]:.1%})"
                          for k, v in report["bound"].items()) + f" ({card})")
    return worst, report


def wav_kernel_phase(card):
    """The K3 kernels against their plain versions at TED's and BEAT's
    waveform length. The backwards run on the same residuals (the kernels'):
    the gradient jumps at each LeakyReLU's kink, so two forwards that round
    a pre-activation near 0 differently may take different branches."""
    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(20)
    enc = random_normal_(WavEncoder(), g).to(dev)
    packed = k3.pack_wav_params(enc, differentiable=False)
    length = audio_samples_for_frames(34)
    worst, report = {"fwd": 0.0, "bwd": 0.0}, {}
    for b in (8, TRAIN_BATCH):
        wav = (0.1 * torch.randn(b, length, generator=g)).to(dev)
        cot = torch.randn(b, k3.WavDims(length).T4, 256, generator=g).to(dev)
        out, res = k3.fused_wav_forward(wav, packed)
        ref, ref_res = k3.fused_wav_forward_reference(wav, packed)
        d_wav, grads = k3.fused_wav_backward(res, cot, packed)
        rd, rgrads = k3.fused_wav_backward_reference(res, cot, packed)
        torch.cuda.synchronize()
        tag = f"B={b} L={length}"
        fwd_rel = {"out": _rel(out, ref)}
        fwd_rel.update({k: _rel(a, r) for k, a, r in zip(res._fields, res, ref_res) if k != "wav"})
        worst["fwd"] = max(worst["fwd"], (out - ref).abs().max().item())
        for k, rel in fwd_rel.items():
            check(np.isfinite(rel) and rel <= KERNEL_TOL, f"K3 forward {k} at {tag}: rel {rel:.3e}")
        top = max(v.abs().max().item() for v in rgrads.values())
        rels = {"d_wav": _rel(d_wav, rd)}
        rels.update({k: _rel(grads[k], rgrads[k]) for k in k3.PACKED_KEYS if k not in ("b0", "b1", "b2")})
        zero = {k: (grads[k] - rgrads[k]).abs().max().item() / top for k in ("b0", "b1", "b2")}
        worst["bwd"] = max([worst["bwd"], (d_wav - rd).abs().max().item()]
                           + [(grads[k] - rgrads[k]).abs().max().item() for k in k3.PACKED_KEYS])
        print(f"[wav-kernel] {tag}: forward rel " + ", ".join(f"{k} {v:.1e}" for k, v in fwd_rel.items())
              + "; gradient rel " + ", ".join(f"{k} {v:.1e}" for k, v in rels.items())
              + "; pre-IN biases / largest gradient " + ", ".join(f"{k} {v:.1e}" for k, v in zero.items()))
        for k, rel in rels.items():
            check(np.isfinite(rel) and rel <= GRAD_TOL, f"K3 gradient {k} at {tag}: rel {rel:.3e}")
        for k, v in zero.items():
            check(np.isfinite(v) and v <= GRAD_TOL, f"K3 gradient {k} at {tag}: {v:.3e} of the largest")
        iters = 5 if b == 8 else 3
        fwd = lambda: k3.fused_wav_forward(wav, packed)
        bwd = lambda: k3.fused_wav_backward(res, cot, packed, need_wav_grad=False)
        bwd_wav = lambda: k3.fused_wav_backward(res, cot, packed)
        plain_f = lambda: k3.fused_wav_forward_reference(wav, packed)
        plain_b = lambda: k3.fused_wav_backward_reference(res, cot, packed, need_wav_grad=False)
        ms = {"fwd": time_ms(fwd, iters), "bwd": time_ms(bwd, iters), "bwd+d_wav": time_ms(bwd_wav, iters)}
        plain = {"fwd": time_ms(plain_f, iters), "bwd": time_ms(plain_b, iters)}
        per_kernel = kernel_ms_by_name(fwd, iters, k3)
        per_kernel.update(kernel_ms_by_name(bwd, iters, k3))
        print(f"[wav-kernel] {tag}: kernels fwd {ms['fwd']:.3f} ms, bwd {ms['bwd']:.3f} ms "
              f"(with d_wav {ms['bwd+d_wav']:.3f}); by kernel, ms per call: "
              + ", ".join(f"{k} {v:.3f}" for k, v in per_kernel.items())
              + f"; plain fwd {plain['fwd']:.3f} ms, bwd {plain['bwd']:.3f} ms ({card})")
        if b == TRAIN_BATCH:
            report = {"ms": per_kernel, "plain_fwd": plain["fwd"], "plain_bwd": plain["bwd"],
                      "bound": {k: bound(*c) for k, c in k3_cost(b, length).items()}}
            print(f"[wav-kernel] {tag}: bound by kernel, ms per call: " + ", ".join(
                f"{k} {v[0]:.3f} ({v[1]}, share {v[0] / per_kernel[k]:.1%})"
                for k, v in report["bound"].items()) + f" ({card})")
    return worst, report


def wav_sampler_phase():
    """One served-size TED batch through RAGSampler with the K3 drop-in,
    against the same sampler on the cuDNN encoder."""
    from livelyspeaker_tpu_torch.models import RAGConfig
    from livelyspeaker_tpu_torch.ops import fused_wav as k3
    from livelyspeaker_tpu_torch.pipeline import RAGSampler
    from livelyspeaker_tpu_torch.serving import ServeConfig

    cfg = RAGConfig.ted()
    model = _random_model(cfg, seed=13)
    cond = _cond(cfg, np.random.default_rng(14), 8)
    sc = ServeConfig()
    outs = []
    for swap in (False, True):
        if swap:
            model.audio_encoder = k3.FusedWavEncoder(model.audio_encoder)
        sampler = RAGSampler(model, steps=sc.steps, timestep_respacing=sc.timestep_respacing,
                             method=sc.sampler, use_fused=True)
        _reset_counts()
        outs.append(sampler(cond, torch.Generator(device="cuda").manual_seed(7), guidance=1.5))
        torch.cuda.synchronize()
        want = _expected_k3(int(swap), 0)
        check(k3.LAUNCHES == want and _k3_plain_calls() == (0, 0),
              f"wav-sampler: swap={swap} K3 launches {k3.LAUNCHES}, plain {_k3_plain_calls()}")
    k3_out, cudnn = outs
    check(k3_out.shape == (8, cfg.njoints, cfg.nfeats, cfg.nframes), "wav-sampler: shape")
    check(bool(torch.isfinite(k3_out).all()), "wav-sampler: non-finite output")
    rel = _rel(k3_out, cudnn)
    print(f"[wav-sampler] K3 drop-in vs cuDNN encoder, one served TED batch "
          f"{tuple(k3_out.shape)}: rel {rel:.3e} (tol {SLICE_TOL}); K3 launches {_expected_k3(1, 0)}")
    check(rel <= SLICE_TOL, "wav-sampler: the K3 encoder's batch disagrees with the cuDNN one")


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
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2, fused_wav as k3

    for launches in (k2.LAUNCHES, k3.LAUNCHES):
        for k in launches:
            launches[k] = 0
    k2.fused_transmlp_train_forward_reference.calls = 0
    k2.fused_transmlp_train_backward_reference.calls = 0
    k3.fused_wav_forward_reference.calls = 0
    k3.fused_wav_backward_reference.calls = 0
    fused_mlp.fused_transmlp.launches = 0


def _k3_plain_calls():
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    return (k3.fused_wav_forward_reference.calls, k3.fused_wav_backward_reference.calls)


def _expected_k3(forwards, backwards):
    """K3's launch counts for that many forward and backward calls."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    return {k: forwards * k3.FORWARD_LAUNCHES.get(k, 0) + backwards * k3.BACKWARD_LAUNCHES.get(k, 0)
            for k in k3.LAUNCHES}


def train_phase(card, wav_kernels=False, beside=None):
    """30 full-width TED steps at batch 512 through TrainLoop.run_loop();
    with ``wav_kernels`` the WavEncoder is first swapped for the K3 drop-in.
    ``beside``: the step numbers of the run without it, printed alongside."""
    import torch.nn.functional as F

    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2, fused_wav as k3
    from livelyspeaker_tpu_torch.training import TrainConfig
    from livelyspeaker_tpu_torch.training.loop import TrainLoop

    tag = "train-k3" if wav_kernels else "train"
    cfg = RAGConfig.ted(fused_train_backbone=True)
    model = RAG(cfg, generator=torch.Generator().manual_seed(5)).cuda()
    if wav_kernels:
        model.audio_encoder = k3.FusedWavEncoder(model.audio_encoder)
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
    conv1d, conv_calls = F.conv1d, []

    def counted_conv1d(*args, **kw):  # the eager WavEncoder's cuDNN convs
        conv_calls.append(1)
        return conv1d(*args, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    F.conv1d = counted_conv1d
    try:
        t0 = time.perf_counter()
        loop.run_loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        F.conv1d = conv1d
    launches = dict(k2.LAUNCHES)
    wav_launches = dict(k3.LAUNCHES)
    plain = (k2.fused_transmlp_train_forward_reference.calls,
             k2.fused_transmlp_train_backward_reference.calls)
    wav_plain = _k3_plain_calls()
    k1 = fused_mlp.fused_transmlp.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    check(len(losses) == TRAIN_STEPS, f"{tag}: {len(losses)} steps ran, not {TRAIN_STEPS}")
    check(all(np.isfinite(losses)), f"{tag}: a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    steady = np.diff(stamps[4:]) * 1e3  # steps 6..30, after the warm-up
    stats = {"step_ms": float(steady.mean()), "clips_s": TRAIN_BATCH / steady.mean() * 1e3,
             "peak_gib": peak_gib}
    encoder = "K3 fused WavEncoder" if wav_kernels else "cuDNN WavEncoder"
    print(f"[{tag}] TED fused backbone, {encoder}, B={TRAIN_BATCH}, {TRAIN_STEPS} steps, "
          f"lr {TRAIN_LR}: loss first-5 mean {first:.5f} last-5 mean {last:.5f}; losses "
          + " ".join(f"{v:.4f}" for v in losses))
    print(f"[{tag}] step {steady.mean():.2f} ms (median {np.median(steady):.2f}, steps 6-30), "
          f"{stats['clips_s']:.1f} clips/s, {wall:.2f} s for the whole run, "
          f"peak memory {peak_gib:.2f} GiB ({card})")
    if beside is not None:
        print(f"[{tag}] beside the cuDNN encoder's run: step {beside['step_ms']:.2f} -> "
              f"{stats['step_ms']:.2f} ms, {beside['clips_s']:.1f} -> {stats['clips_s']:.1f} "
              f"clips/s, peak {beside['peak_gib']:.2f} -> {peak_gib:.2f} GiB")
    print(f"[{tag}] launches {launches} (per step: fwd 1, each backward kernel {LAYERS}); "
          f"plain versions {plain}; K1 {k1}; K3 {wav_launches}, K3 plain versions "
          f"{wav_plain}; F.conv1d calls {len(conv_calls)}")
    check(last < first, f"{tag}: loss did not decrease ({first:.5f} -> {last:.5f})")
    check(launches["fwd"] == TRAIN_STEPS, f"{tag}: forward kernel launched {launches['fwd']} times")
    for k in ("bwd_block", "wgrad", "reduce"):
        check(launches[k] == LAYERS * TRAIN_STEPS, f"{tag}: {k} launched {launches[k]} times")
    check(plain == (0, 0) and k1 == 0, f"{tag}: a plain version or K1 ran on the training path")
    want = _expected_k3(TRAIN_STEPS, TRAIN_STEPS) if wav_kernels else _expected_k3(0, 0)
    check(wav_launches == want, f"{tag}: K3 launches {wav_launches}, expected {want}")
    check(wav_plain == (0, 0), f"{tag}: a K3 plain version ran on the training path")
    if wav_kernels:
        check(not conv_calls, f"{tag}: F.conv1d ran {len(conv_calls)} times on the K3 path")
    return launches, wav_launches, model, loop, stats


def _kink_flips(enc, audio, res):
    """(n, total): the inputs of the WavEncoder's three LeakyReLUs whose sign
    differs between the eager encoder's forward (cuDNN convs) and K3's
    (residuals ``res``), out of all of them."""
    import torch.nn.functional as F

    from livelyspeaker_tpu_torch.models.audio_encoder import _instance_norm
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    with torch.no_grad():
        kernel = k3.lrelu_inputs(res, k3.pack_wav_params(enc, differentiable=False))
        x, flips, total = audio[:, None], 0, 0
        for i in range(3):
            conv = getattr(enc, f"conv{i}")
            x = _instance_norm(F.conv1d(x, conv.weight, conv.bias, stride=conv.stride,
                                        padding=conv.padding))
            flips += int(((x > 0) != (kernel[i] > 0)).sum())
            total += x.numel()
            x = F.leaky_relu(x, enc.leak)
    return flips, total


def fused_vs_eager_train_phase():
    """The fused training loss and gradients against the eager modules: K2
    alone, then K2 with the K3 drop-in."""
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2, fused_wav as k3
    from livelyspeaker_tpu_torch.training import TrainConfig
    from livelyspeaker_tpu_torch.training.trainer import make_loss_fn

    sched = DiffusionSchedule.create(steps=1000, schedule="cosine").to("cuda")
    for tag, make_cfg, kld, seed in (("TED", RAGConfig.ted, 0.01, 11), ("BEAT", RAGConfig.beat, 0.0, 12)):
        g = torch.Generator().manual_seed(seed)
        eager = random_normal_(RAG(make_cfg(), generator=g), g).cuda()
        fused = RAG(make_cfg(fused_train_backbone=True)).cuda()
        fused.load_state_dict(eager.state_dict())
        wav3 = RAG(make_cfg(fused_train_backbone=True)).cuda()
        wav3.load_state_dict(eager.state_dict())
        wav3.audio_encoder = k3.FusedWavEncoder(wav3.audio_encoder)
        cfg = eager.cfg
        rng = np.random.default_rng(seed)
        b = 64
        batch = _train_batch(cfg, rng, b)
        t = torch.from_numpy(rng.integers(0, 1000, size=(b,))).cuda()
        noise = torch.from_numpy(rng.normal(size=batch["motion"].shape).astype(np.float32)).cuda()
        style = torch.from_numpy(rng.normal(size=(b, 1, cfg.latent_dim)).astype(np.float32)).cuda()
        drop = torch.from_numpy((rng.random(b) < 0.1).astype(np.float32)).cuda()
        ones = torch.ones(b, device="cuda")
        out, feats = [], []
        hook = eager.audio_encoder.register_forward_hook(lambda mod, inp, y: feats.append(y))
        for m in (fused, eager, wav3):
            _reset_counts()
            params = dict(m.named_parameters())
            loss, _ = make_loss_fn(m, sched, TrainConfig(kld_weight=kld))(
                batch, t, ones, None, noise, style, drop)
            grads = torch.autograd.grad(loss, list(params.values()) + (feats if m is eager else []))
            torch.cuda.synchronize()
            out.append((loss.item(), dict(zip(params, grads)), dict(k2.LAUNCHES),
                        (dict(k3.LAUNCHES), _k3_plain_calls())))
            if m is eager:
                g_feats = grads[-1]  # the eager encoder's output cotangent
        hook.remove()
        (lf, gf, nf, _), (le, ge, ne, _), (lw, gw, nw, (kw, pw)) = out
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
        _k3_vs_eager(tag, b, wav3, batch["audio"], (lw, gw, nw, kw, pw), (le, ge), g_feats, top)


def _k3_vs_eager(tag, b, wav3, audio, k3_run, eager_run, g_feats, top):
    """The K2 + K3 model's loss and gradients against the eager model's."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    (lw, gw, nw, kw, pw), (le, ge) = k3_run, eager_run
    check(nw["fwd"] == 1 and nw["bwd_block"] == LAYERS and kw == _expected_k3(1, 1) and pw == (0, 0),
          f"{tag} K3-vs-eager: launches K2 {nw} K3 {kw}, K3 plain versions {pw}")
    loss_rel = abs(lw - le) / abs(le)
    enc = [k for k in ge if k.startswith("audio_encoder.")]
    rest = {k: _rel(gw[k], ge[k]) for k in ge if k not in enc}
    worst_k = max(rest, key=rest.get)
    # the encoder's gradients against K3's plain backward on the kernels'
    # residuals, for the eager model's cotangent of the audio features
    packed = k3.pack_wav_params(wav3.audio_encoder, differentiable=False)
    _, res = k3.fused_wav_forward(audio, packed)
    _, ref = k3.fused_wav_backward_reference(res, g_feats, packed, wav3.audio_encoder.leak,
                                             need_wav_grad=False)
    ref = {f"audio_encoder.conv{k[1]}.{'weight' if k[0] == 'w' else 'bias'}": v
           for k, v in ref.items()}
    vs_plain = {k: (gw[k] - ref[k]).abs().max().item() / (top if k in ZERO_GRAD else
                                                          ref[k].abs().max().item())
                for k in enc}
    vs_eager = {k: _rel(gw[k], ge[k]) for k in enc if k not in ZERO_GRAD}
    flips, total = _kink_flips(wav3.audio_encoder, audio, res)
    print(f"[train-{tag.lower()}] K2+K3 vs eager, B={b}: loss {lw:.6f} vs {le:.6f} rel "
          f"{loss_rel:.3e} (tol 1e-5); worst gradient rel outside the WavEncoder "
          f"{rest[worst_k]:.3e} at {worst_k} (tol {GRAD_TOL}), over {len(rest)} parameters")
    print(f"[train-{tag.lower()}] WavEncoder gradients against K3's plain backward on the "
          f"eager feature cotangent: worst {max(vs_plain.values()):.3e} (tol {GRAD_TOL}); "
          f"against the eager encoder: " + ", ".join(f"{k.split('.', 1)[1]} {v:.1e}"
                                                     for k, v in vs_eager.items())
          + f"; LeakyReLU inputs of another sign in the two forwards: {flips} of {total}")
    check(loss_rel <= 1e-5, f"{tag}: K2+K3 loss disagrees with eager: rel {loss_rel:.3e}")
    check(rest[worst_k] <= GRAD_TOL, f"{tag}: K2+K3 gradient of {worst_k} disagrees: "
          f"rel {rest[worst_k]:.3e}")
    check(max(vs_plain.values()) <= GRAD_TOL, f"{tag}: K3 encoder gradients disagree with "
          f"the plain backward: {vs_plain}")
    if flips == 0:  # the same LeakyReLU branches everywhere: hold the eager ones too
        check(max(vs_eager.values()) <= GRAD_TOL, f"{tag}: K3 encoder gradients disagree "
              f"with the eager encoder's: {vs_eager}")


def profile_phase(model, loop, out_dir, card, name="train_step"):
    """torch.profiler over 3 training steps: device time by kernel class,
    into DIR/<name>_trace.json and DIR/<name>_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    from livelyspeaker_tpu_torch.ops import fused_wav as k3

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
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    classes = {"K3 WavEncoder kernels": ("::wav_",),  # before "conv", which they contain
               "K2 forward": ("fused_transmlp_cluster_kernel",),
               "K2 backward block": ("bwd_block_kernel",),
               "K2 weight-gradient reductions": ("::wgrad_kernel(", "::reduce_kernel("),
               "cuDNN conv (WavEncoder)": ("cudnn", "convolve", "fprop_implicit", "wgrad_alg",
                                           "dgrad_engine"),
               "cuBLAS GEMM (the other layers)": ("_gemm_", "cublas"),
               "AdamW and other foreach": ("foreach", "multi_tensor")}
    lines, head, counts = _device_table(
        prof, classes, wall_ms, f"{name}: 3 steps, B={TRAIN_BATCH} ({card})", 3, "step")
    # the WavEncoder forward and backward alone, at the step's batch
    audio = batch["audio"]
    enc = lambda: model.audio_encoder(audio).sum().backward()
    lines.insert(head, f"WavEncoder forward+backward alone: {time_ms(enc, 3):.3f} ms "
                 "(CUDA events, 3 calls)")
    model.zero_grad(set_to_none=True)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:head + 1]:
        print(f"[profile] {line}")
    if isinstance(model.audio_encoder, k3.FusedWavEncoder):
        n = counts["cuDNN conv (WavEncoder)"]
        check(n == 0, f"profile {name}: {n} cuDNN convolution kernels on the K3 path")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile a serving burst and 3 steps of each training run, "
                             "writing the traces and tables to DIR")
    args = parser.parse_args()
    card = device_phase()
    build_phase()
    worst_abs, k1 = kernel_phase(card)
    launches = serving_phase(card, args.profile)
    beat_phase()
    train_worst, train_times = train_kernel_phase(card)
    train_launches, _, model, loop, train_stats = train_phase(card)
    wav_worst, wav_times = wav_kernel_phase(card)
    _, wav_launches, wav_model, wav_loop, _ = train_phase(card, wav_kernels=True, beside=train_stats)
    fused_vs_eager_train_phase()
    wav_sampler_phase()
    if args.profile:
        wgrad_library_probe(card, args.profile)
        profile_phase(model, loop, args.profile, card)
        profile_phase(wav_model, wav_loop, args.profile, card, name="train_step_k3")
    # library_ms: one torch.matmul computes the K2 weight-gradient kernel's
    # product and one torch.sum the reduce kernel's sums; no single PyTorch
    # call computes any other of these functions (8-block mixer stacks and
    # their backward, a conv/InstanceNorm/LeakyReLU chain)
    kernels = [{
        "name": "fused_transmlp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst_abs, **k1, "library_ms": None,
    }]
    for k in ("fwd", "bwd_block", "wgrad", "reduce"):
        kernels.append({
            "name": f"fused_transmlp_train_{k}", "route": "cuda",
            "source": TRAIN_FWD_SOURCE if k == "fwd" else TRAIN_SOURCE,
            "replaces": TRAIN_REPLACES, "launches": train_launches[k],
            "max_abs_err": train_worst["fwd" if k == "fwd" else "bwd"],
            "ms": train_times["ms"][k],
            "plain_ms": train_times["plain_fwd" if k == "fwd" else "plain_bwd"],
            "bound_ms": train_times["bound"][k][0], "bound_by": train_times["bound"][k][1],
            "library_ms": train_times["library"].get(k),
        })
    for k in wav_launches:
        fwd = k in ("stats0", "conv_fwd", "stats")
        kernels.append({
            "name": f"fused_wav_{k}", "route": "cuda", "source": WAV_SOURCE,
            "replaces": WAV_REPLACES, "launches": wav_launches[k],
            "max_abs_err": wav_worst["fwd" if fwd else "bwd"], "ms": wav_times["ms"][k],
            "plain_ms": wav_times["plain_fwd" if fwd else "plain_bwd"],
            "bound_ms": wav_times["bound"][k][0], "bound_by": wav_times["bound"][k][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(f"[device] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
