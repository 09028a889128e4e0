"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, RAG sampling behind the serving batcher, at
the full TED width (latent 512, 8 blocks, 1400 speakers) with seeded random
weights, and checks it:

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
5. one BEAT batch (emotion conditioning) the same way.

Exits non-zero at the first failure. The line before the last is the
kernels' JSON report; the last line is {"ok": true, "device": {...}}.
"""

import json
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
    from livelyspeaker_tpu_torch.ops._build import build_log, load_library

    t0 = time.perf_counter()
    load_library("fused_transmlp")
    secs = time.perf_counter() - t0
    print(f"[build] fused_transmlp built and loaded in {secs:.2f} s")
    for line in build_log("fused_transmlp").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")


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


def main():
    card = device_phase()
    build_phase()
    worst_abs, ms, plain_ms = kernel_phase(card)
    launches = serving_phase(card)
    beat_phase()
    print(json.dumps({"kernels": [{
        "name": "fused_transmlp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(f"[device] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
