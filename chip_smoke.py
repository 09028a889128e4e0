"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Drives the port's paths at the full TED width (latent 512, 8 blocks,
1400 speakers) with seeded random weights: RAG sampling behind the serving
batcher, the two-stage composition (CLIP text tower, SAG sketch, RAG
refinement) through LivelySpeakerPipeline, the HTTP front end with text and
long-form requests, RAG training through TrainLoop
with the fused backbone, training from TED and BEAT records through the
train_rag and train_sag entry points, records built from raw TED clips and
a raw BEAT directory and trained through K2 and the gesture autoencoder,
K1's bf16 option, and the same training with the WavEncoder swapped for
the fused WavEncoder stack (K3). Checks:

1. device: a CUDA card is required (no CPU run); TF32 is off for matmul
   and cuDNN, so every comparison below is f32 against f32;
2. build: the three CUDA sources of csrc/ are compiled with nvcc, one
   process each, started together;
3. kernel against plain version: TED (S=35, F=27) and BEAT (S=36, F=282),
   D=512, L=8, 2B in {2, 16, 64, 128, 512, 1024} (128: the composition's
   batch of 64 under CFG; 1,024: the eval scripts' batch of 512 under
   CFG), LN2 folded and not, with and
   without the pose projection; rel = max|kernel - plain| / max|plain| <=
   1e-5, the time per call of both, the bound (the channel mix and the pose
   projection as three TF32 passes at the TF32 peak, the token mix at the
   f32 peak outside the tensor cores) and the share of it; at 2B in {2, 16,
   512} the kernel at every cluster size the forward takes at D=512, timed
   in turns; then the bf16 kernel (``bf16_kernel_phase``,
   csrc/fused_transmlp_bf16.cu) against its plain bf16 version at TED and
   BEAT, 2B in {16, 512}, LN2 folded and not, with and without the pose
   projection: max|kernel - plain| <= 2^-6 max|plain| (printed in bf16
   ulps of max|y|), both within rel 0.05 of the f32 kernel on the same
   weights, a second call's bits equal to the first's, the geometry it
   picked, the time of the three and the bound at the bf16 tensor-core
   peak; at 2B in {16, 512} every (cluster, group) the geometry can pick
   at D=512, timed in turns; then 20 calls of the bf16 stack through
   fused_transmlp at the serving shape, the counts set to 0 before: 20
   bf16 launches, no f32 launch and no plain call;
4. serving: build_rag_server with the default ServeConfig (DPM-Solver++ over
   ddim20, max_batch 8, guidance 1.5) answers 24 requests from 3 threads;
   every clip is finite [9, 3, 34], the kernel ran 20 times per batch served
   and the plain version never; then one served-size batch through the
   fused sampler agrees with the eager modules (cuBLAS) within rel 1e-4;
5. one BEAT batch (emotion conditioning) the same way;
6. the composition: LivelySpeakerPipeline (ddim100, skip 80, guidance 1.5)
   on a batch of 8 sentences (HashTokenizer), at TED (RAGConfig.ted(),
   SAG 9x3 at latent 512, ff 1024, 3 layers, 4 heads, ViT-B/32's text
   tower: vocab 49,408, context 77, width 512, 12 layers, 8 heads) and
   BEAT (RAGConfig.beat(), SAG 47x6, emotions): every clip finite [8, J,
   F, 34], K1 launched 20 times for the batch and its plain version never,
   and the same batch through the eager modules (use_fused=False) from the
   same seeded generator within rel 1e-4; the ms of the CLIP encode, the
   SAG decode and the 20-step refinement of a batch, and clips/s;
   then the HTTP front end (``livelyspeaker_tpu_torch.scripts.serve``) on
   seeded TED and SAG checkpoints written as the JAX package's npz, at its
   defaults: 16 plain requests from 4 threads, 8 text requests beside 4
   plain, one long request over 10 s of audio (5 windows, [9, 3, 150]) and
   the same streamed as NDJSON (its chunks within rel 1e-4 of the blocking
   answer from the same seed), /stats, /metrics and a reload; K1 launched
   20 times a batch served and its plain version never, no batch mixing
   text and plain; the p50 and p95 of the plain requests, the ms a window,
   the ms to the first NDJSON line and clips/s; then a PLMS batcher (K1 21
   times a batch), and PLMS, inpainting (the held frames equal to the
   constraint) and generate_long_form, fused against eager within rel
   1e-4; then the grouped SwiGLU (``grouped_swiglu_phase``,
   csrc/grouped_swiglu.cu) at the Moonlight tower's shapes: a routed layer
   of 41,400 rows over 64 experts of width 1,408 (skew 1.7, an empty and a
   one-row expert), the shared group (6,900 rows, 2,816) and the dense group
   (6,900, 11,264) at hidden 2,048, each within rel 2e-5 of its plain
   version with a second call's bits equal, and the time of the kernels,
   the plain version and the per-expert cuBLAS loop, in turns, beside the
   bound at three TF32 passes; then one call of the whole tower at its
   widths (``tower_phase``, 62.5 GB of seeded weights, 64 sentences) with
   the kernels' launches counted from 0: 106 (two for the dense layer, two
   for each of 26 routed layers' experts and shared experts), and its
   ``ffn_tile_rows`` against its ``expert_load``;
7. the training kernels (the cluster kernel with a stash as the forward; per
   layer of the backward a cluster block kernel, a 3xTF32 tensor-core
   weight-gradient kernel and a reduce kernel) against their plain versions
   at TED (S=35) and BEAT (S=36), D=512, L=8, silu, B in {64, 512}: forward
   and stash within rel 1e-5, every gradient within rel 1e-4 of its
   max|plain|, a second run with the same bits, the time per fwd+bwd call of
   both, the forward and the block kernel at clusters of 8 and 4 CTAs in
   turns; then the weight-gradient and reduce kernels alone, 8 launches,
   against 8 calls of torch.matmul(h2.T, g_m2) and of part.sum(0), in turns;
8. training: TrainLoop.run_loop() on RAGConfig.ted(fused_train_backbone=True)
   (its own seeded init), DDPM-1000 cosine, 30 steps at batch 512 on one
   fixed seeded batch, the default TrainConfig but lr 1e-3: every loss is
   finite, the mean of the last 5 is below that of the first 5, the forward
   kernel launched once a step and each backward kernel 8 times (once per
   layer) a step, the plain versions and K1 never; step ms, clips/s and
   peak memory; then training from records (``records_train_phase``):
   synthetic TED (1,040 windows) and BEAT (273 windows) records built
   here, ``scripts.train_rag.main`` with --fused_train at B=512 for 10
   epochs, once with the streaming DataLoader and once with
   --device_resident 1 (K2's launches as above for every step, no plain
   version, finite losses whose last-5 mean is below the first-5 mean, the
   two loaders' first batches identical), on BEAT at B=128 (47x6, S=36),
   ``scripts.train_sag.main`` at latent 512 with the 12-layer text tower,
   B=512, 3 epochs and the FGD hook each epoch ("new best FGD" printed,
   sag_best.npz written), then one batch of 8 sentences composed from the
   trained RAG and sag_best.npz, K1 20 launches, fused against eager
   within rel 1e-4; the loader's host ms a batch and the step ms of each
   route beside the fixed batch's; then evaluation (``eval_phase``) on
   those records and checkpoints: a seeded RAG checkpoint with the
   released layout's keys (tests/manifests/rag_ted.json) through
   ``scripts.convert_checkpoint rag``, loaded strict, bit-exact; the four
   eval scripts with --fused on seeded evaluator, BEAT SAG and CLIP
   checkpoints in the released layouts: eval_rag_ted at batch 512 (K1 at
   2B=1,024, guidances x batches x 100 launches), eval_rag_beat at the
   records' one batch (x 100), eval_livelyspeaker_ted and _beat (20 a
   batch), every number finite, the plain version never; the TED eval's
   first batch fused against eager within rel 1e-4; each script's wall
   time split into sampling and scoring (host clock, synchronised); then
   records from raw files (``records_build_phase``): 40 raw TED clips of
   20 s (npz) through scripts.build_ted_records in f32 and PCM16 (1,040
   windows each), 6 raw BEAT recordings of 40 s of two speakers (BVH at
   120 fps, WAV, TextGrid, csv, txt, json; BEAT's train split) through
   scripts.build_beat_records (342 windows), the seconds of each build;
   the loaders' first batches on the card (f32 and PCM16 motion equal,
   PCM16 audio within 2^-15 of f32); train_rag --fused_train from the TED
   records at B=512 (5 epochs) and the BEAT records at B=128 (K2's
   launches as above, finite and falling losses);
   scripts.train_gesture_autoencoder on the TED records at batch 512, base
   32, 10 epochs: finite, falling reconstruction MSE, the npz exactly the
   Flax module's keys and shapes (tests/manifests/gesture_ae_ted.json),
   loaded into the port's model; each run's step ms;
9. the fused training loss against the eager one on a TED and a BEAT batch
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
10. the K3 kernels (nine forward launches, sixteen backward) against their
   plain versions at L = 36,267, B in {8, 512}: forward within rel 1e-5;
   backward on the same residuals, d_wav and every weight and conv3 bias
   gradient within rel 1e-4 of its max, the pre-IN biases within 1e-4 of
   the largest gradient; the time of both, and of each kernel; then the
   forward conv kernel (its weight split, then 3xTF32 on the tensor cores)
   conv by conv against the f64 conv within rel 1e-5 and timed against
   cuDNN's forward conv of the same conv on the materialised input, in
   turns, with its bound; the weight-gradient kernel (3xTF32 on the tensor cores) conv by conv against
   the f64 weight gradient and timed against cuDNN's weight gradient of the
   same conv on the materialised activation, in turns, with its bound;
   and the data-gradient kernel (its weight split, then 3xTF32 on the
   tensor cores) conv by conv against the f64 data gradient and its
   InstanceNorm sums, timed against cuDNN's data gradient of the same conv
   on the same cotangent, in turns, with its bound; the statistics kernel
   (one pass, split over a cluster) on a forward's m1 and m2 against the
   two-pass statistics in f64 and a second launch's bits, timed against
   torch.var_mean then rsqrt; each of the four reduce launches of a
   backward against f64, the CPU plain version's bits and a second
   launch's, timed against part.sum(0) on the same partials; and the two
   conv0 kernels (IN0's statistics over conv0 recomputed, one pass split
   over a cluster; conv0's backward through IN0 split over warps, with
   and without d_wav) against the plain versions in f64 and a second
   call's bits, timed beside cuDNN on materialised conv0 and g_m0, the
   bound and the rounding rule's instruction floor;
11. training through K3 and K2: 8. with the WavEncoder swapped for
   FusedWavEncoder before the TrainLoop is built: finite, decreasing
   losses; each K3 kernel launched as often a step as one forward and one
   backward launch it; the K3 plain versions and F.conv1d never called;
12. one served-size TED batch (8) through RAGSampler with the K3 drop-in
   against the same sampler on the cuDNN encoder, within rel 1e-4;
13. the measurement scripts (``measure_phase``), each through its
   ``main(argv)`` at full width with the kernel counts set to 0 just before
   and read just after: bench_serve (TED, max_batch 16, a burst of 256 at
   pipeline depth 0 and 1; BEAT, a burst of 64 with 8 single requests, and
   one with a quarter of the requests carrying text): K1 20 times a served
   batch, its plain version never; bench_train --fused_train (10 steps at
   B=512 after the first) twice, around bench_train --loaders (the eager
   backbone's step, then both loaders), so that the fused and the eager
   step run in turns: K2's forward once and each backward kernel 8 times a
   fused step, the plain versions and K1 never; bench_data (one epoch, f32 and PCM16
   records); profile of the sampler (batch 256, ddim100, two batches: K1's
   kernel 200 times in the trace) and of the train step (batch 512, three
   steps), with each trace's span, busy time, idle share and top kernels;
   and soak_serve for 20 s against a server process with the composition
   (reloads every 5 s): its own asserts, no transport error, exit 0 on
   SIGTERM;
14. generation (``generate_phase``): scripts.generate with --fused on the
   front end's seeded TED and SAG checkpoints, RAG-only (K1 100 launches),
   with --sag_path (20) and --long over 10 s (100 a window, [150, 27]),
   then main at BEAT (100; the npz's motion [34, 282]); the plain version
   never; the RAG-only clip against the eager modules from the same seeded
   generator within rel 1e-4;
15. data parallelism (``data_parallel_phase``, run after the first training
   run of 8.), on a mesh that names the one card twice
   (``parallel.create_mesh(devices=["cuda:0", "cuda:0"])``, the same code
   a mesh of two cards runs), at TED full width: the data-parallel step
   with fused_train_backbone at a global batch of 512 (two shards of 256)
   against the single-device step, identical shards with
   fold_shard_rng=False against the step at 256 and different shards with
   injected t, noise, style and drop against the step at 512 (loss within
   rel 1e-5, parameters within 1e-4; AdamW eps 1e-3, as the CPU parity
   tests take it); TrainLoop(mesh=) for 3 steps: K2 twice the
   single-device launches, the two replicas bit-identical, moments
   included; the 24-request burst through build_rag_server on the mesh
   (K1 2 x 20 a batch); the sharded sampler against the single-device one
   (DDIM-20 at eta 0, noise and style injected) within rel 1e-4, K1 40
   launches against 20; one composed batch of 8 through
   LivelySpeakerPipeline(mesh=) (K1 2 x 20); train_rag --device
   cuda:0,cuda:0 --fused_train at B=512 from synthetic records (K2 twice
   the launches, falling losses); on a one-card machine
   serving_mesh(ServeConfig(data_parallel=2)) and eval_rag_ted
   --data_parallel 2 raise; a step's and a burst's wall with one shard and
   with two on the card, in turns;
16. several processes, FSDP and pipeline stages (``multihost_phase``,
   ``fsdp_phase``, ``pipeline_phase``, after 15.): two processes join a
   gloo group on cuda:0 (``parallel.init_distributed``; NCCL refuses two
   ranks on one card) and each trains 3 steps of the fused TED model on
   its 256 rows of a global batch of 512 with injected draws: K2 in each
   process (forward 3, each backward kernel 24, plain versions 0), both
   ranks' params the same bits, rank 0's loss and params against the
   in-process [cuda:0, cuda:0] step within rel 1e-5 and 1e-4; a one-rank
   NCCL group trains the same 3 steps (NCCL's all-reduce on the card), and
   the demo script runs on two gloo processes (--platform cuda, equal
   losses); each timed run alone on the card; then train_rag on the eager backbone at TED B=512 for 3 steps:
   --fsdp on [cuda:0, cuda:0] against the replicated run (losses within
   rel 1e-5, each shard's persistent state about half), --pipeline_parallel
   2 on [cuda:0, cuda:0] against the plain step on cuda:0, and
   --pipeline_parallel 2 --fsdp on cuda:0 named four times (2 rows of 2
   stages) against the replicated two-shard run; each run's step ms;
17. the native record gather (``native_gather_check``, first in the
   records phase): the library must be loaded; on the streaming run's
   first TED batch of 512 the motion transpose-crop, the audio prefix (f32
   and int16) and the vec_seq prefix give numpy indexing's bytes, and
   both are timed in turns (host ms a batch);
18. tensor parallelism (``tensor_parallel_phase``, on cuda:0 named four
   and eight times): the eager sampler, 3 FSDP steps at B=512 over data 2 x
   model 2 and a pipeline of 2 stages x model 2 against one device, each
   device's persistent state bytes, and the fused kernels' refusals in the
   JAX package's words;
19. the studies (``studies_phase``, after 14.), each through its
   ``main(argv)`` at full width and a reduced length: soak_flagship
   --fused_train at B=512 (40 clips, 4 epochs of 2 steps, split at 2; its
   three train_rag processes first without the cuDNN pin, read, then as
   the script runs them, pinned: the resume bit-exact, fgd_ema within its
   bound), measure_ema_warmup and measure_audio_bf16 (2 epochs each, fused),
   K2's launches in every train_rag process (1 forward and 8 of each
   backward kernel a step, against the steps taken); measure_long_form_seams
   --fused over 10 s at ddim20 on the soak's checkpoint (K1 20 a window, the
   random baseline too); both semantic-payoff studies (20 RAG and 20 SAG
   steps, clip_layers 4, unfused); distill_rag (one round of 3 steps from
   the soak's checkpoint) and measure_distill_quality (latent 256); every
   FGD, recall and seam ratio finite; each study's wall seconds. The
   multi-process comparison of 16. also runs once more with cuDNN pinned
   in all three runs (the gap reported, the 1e-4 gate kept).

With ``--profile DIR`` it also profiles a second burst of the 24 serving
requests, 3 composed TED batches and 3 steps of each training run with
torch.profiler (Chrome
traces and tables of device time by kernel, and the idle share, in DIR),
and prints the kernels cuBLAS runs for the weight-gradient product.

Exits non-zero at the first failure. The line before the last is the
kernels' JSON report; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
BF16_SOURCE = "livelyspeaker_tpu_torch/csrc/fused_transmlp_bf16.cu"
BF16_REPLACES = "livelyspeaker_tpu/ops/pallas/fused_mlp.py:215"  # its bf16 option, :49 and :202
BF16_TOL = 2.0 ** -6  # bf16 kernel vs plain, of max|plain|: a few bf16 ulps of max|y|
BF16_F32_TOL = 0.05  # either bf16 stack vs the f32 kernel, of max|f32| (the JAX test's 0.05)
BF16_PATH_STEPS = 20  # the bf16 path: calls of the stack, one a solver step
WAV_SOURCE = "livelyspeaker_tpu_torch/csrc/fused_wav.cu"
GROUPED_SOURCE = "livelyspeaker_tpu_torch/csrc/grouped_swiglu.cu"
GROUPED_TOL = 2e-5  # 3xTF32 against cuBLAS f32: sums of 2,048 then 1,408-11,264 products
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

    names = ("fused_transmlp", "fused_transmlp_train", "fused_wav", "fused_transmlp_bf16",
             "grouped_swiglu")
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
PEAK_BF16 = 989e12  # bf16 on the tensor cores, dense, H100 SXM at 700 W


def bound(flop, nbytes, peak=PEAK_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for
    ``flop`` operations at ``peak`` (default f32 outside the tensor cores)
    and ``nbytes`` of device memory traffic."""
    t_ops, t_bytes = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_3xtf32(products, fma):
    """The FLOP/s at which the card could do ``products`` FLOPs in 3xTF32
    (three TF32 passes at the TF32 peak) and ``fma`` FLOPs on the FP32
    pipe, one after the other."""
    return (products + fma) / (3 * products / PEAK_TF32 + fma / PEAK_FLOPS)


def k1_cost(x, emb, packed, op):
    """(FLOP, bytes, peak) of one K1 call, f32 or bf16: the token mix,
    channel mix and pose products (the LayerNorms, activations and
    residuals, under 3% at D=512, are left out); every input read once at
    its own element size, the output (of x's type) written once. The peak:
    bf16's for the bf16 kernel; for f32, the channel mix and the pose
    projection in 3xTF32 beside the token mix on the FP32 pipe
    (``peak_3xtf32``). The FLOPs and bytes are what benchmark/arith.py's
    frozen copy counts."""
    b, s, d = x.shape
    layers = packed["token_w"].shape[0]
    f = op["out_b"].shape[0] if op is not None else 0
    token, products = b * layers * 2 * s * s * d, b * (layers * 2 * s * d * d + 2 * s * d * f)
    tensors = [x, emb, *packed.values(), *(op.values() if op is not None else ())]
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + b * s * (f or d) * x.element_size())
    peak = PEAK_BF16 if x.dtype == torch.bfloat16 else peak_3xtf32(products, token)
    return token + products, nbytes, peak


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
    128, 512, 1024}, LN2 folded and affine, with and without the pose
    projection; then the cluster sizes the kernel takes at D=512, in
    turns."""
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
        for b2 in (2, 16, 64, 128, 512, 1024):
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
                    iters = 20 if b2 <= 64 else 5 if b2 <= 512 else 3
                    ms = time_ms(lambda: fused_mlp.fused_transmlp(x, emb, packed, out_proj=op), iters)
                    plain = time_ms(lambda: fused_mlp.fused_transmlp_reference(
                        x, emb, packed, out_proj=op), iters)
                    flop, nbytes, peak = k1_cost(x, emb, packed, op)
                    bound_ms, bound_by = bound(flop, nbytes, peak)
                    tag = (f"{name} 2B={b2} S={seq} D=512 L=8 ln2={'folded' if fold else 'affine'} "
                           f"out={'F=%d' % feats if op else 'D'}")
                    print(f"[kernel] {tag}: max_abs {err:.3e} max_rel {rel:.3e} kernel {ms:.4f} ms "
                          f"plain {plain:.4f} ms bound {bound_ms:.4f} ms ({flop / 1e9:.3f} GFLOP at "
                          f"{peak / 1e12:.0f} TFLOP/s, {bound_by}) share {bound_ms / ms:.1%}; "
                          f"cluster {geo.cluster} x {geo.cols} columns ({card})")
                    check(np.isfinite(rel) and rel <= KERNEL_TOL,
                          f"kernel disagrees with plain version at {tag}: rel {rel:.3e}")
                    worst_abs = max(worst_abs, err)
                    if name == "TED" and b2 == 16 and fold and op is not None:
                        main = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                                "bound_by": bound_by}  # the serving call
            # the cluster sizes D=512 allows (Dc <= 256), at the serving layout
            packed = fused_mlp.pack_transmlp_params(stack, fold_ln2=True)
            op = fused_mlp.pack_out_proj(pose)
            if b2 in (2, 16, 512):
                runs = {n: (lambda n=n: fused_mlp.launch_stack(x, emb, packed, 0, op, cluster=n))
                        for n in fused_mlp.forward_cluster_sizes(512)}
                times = time_turns(runs, 20 if b2 <= 16 else 5, rounds=4)
                print(f"[kernel] {name} 2B={b2} folded F={feats}, by cluster size (in turns): "
                      + ", ".join(f"{n} CTAs {t:.4f} ms" for n, t in times.items())
                      + f"; transmlp_geometry picks {geo.cluster} ({card})")
    return worst_abs, main


def skewed_counts(total, groups, skew, seed, first=()):
    """Rows a group, ``total`` in all: the first groups' counts ``first``,
    then the other groups' share of the rest, the busiest ``skew`` times
    their mean (shares spread evenly from 2 - skew to skew), in a seeded
    order, the last of them taking the rounding. Every count is at least
    0. The grouped SwiGLU's routed cases here and in
    ``tests/test_torch_cuda.py``."""
    rest = total - sum(first)
    share = torch.linspace(2.0 - skew, skew, groups - len(first))
    counts = (share / share.sum() * rest).long()
    counts = counts[torch.randperm(counts.numel(), generator=torch.Generator().manual_seed(seed))]
    counts[-1] += rest - counts.sum()
    return torch.cat([torch.tensor(first, dtype=torch.long), counts])


def grouped_swiglu_phase(card, tokens=6_900, pairs=41_400, experts=64, hidden=2048,
                         width=1408, shared=2816, dense=11264):
    """The grouped SwiGLU (csrc/grouped_swiglu.cu) at the Moonlight cell's
    shapes: a routed layer (``pairs`` rows over ``experts`` groups, the
    busiest 1.7 times the mean, an empty and a one-row expert among them),
    the shared group and the dense group (``tokens`` rows). Each against
    its plain version (rel <= GROUPED_TOL), a second call's bits, the time
    of the kernels (gate-up and down, two launches), the plain version and
    the library yardstick (the per-expert cuBLAS loop the tower ran before:
    the sizes read back, three F.linear an expert; for one group the plain
    version's three products), in turns; the bound: the products as three
    TF32 passes at the TF32 peak, or the rows, weights and output once at
    3.35 TB/s."""
    import torch.nn.functional as F

    from livelyspeaker_tpu_torch.ops import grouped_swiglu as gs
    from livelyspeaker_tpu_torch.ops._build import build_log

    for line in build_log("grouped_swiglu").splitlines():
        if "serialized" in line or "Potential Performance Loss" in line:
            print(f"[grouped] ptxas: {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    counts = skewed_counts(pairs, experts, 1.7, seed=32, first=(0, 1))
    out, worst = {}, 0.0
    for name, n, cnt in (("routed", width, counts), ("shared", shared, None),
                         ("dense", dense, None)):
        rows = pairs if cnt is not None else tokens
        groups = experts if cnt is not None else 1
        x = torch.randn(rows, hidden, device=dev, generator=g)
        wg = torch.randn(groups, n, hidden, device=dev, generator=g) * hidden ** -0.5
        wu = torch.randn(groups, n, hidden, device=dev, generator=g) * hidden ** -0.5
        wd = torch.randn(groups, hidden, n, device=dev, generator=g) * n ** -0.5
        kw = {}
        if cnt is not None:
            kw["offsets"] = F.pad(cnt.to(dev).cumsum(0), (1, 0))
            kw["dest"] = torch.randperm(rows, device=dev, generator=g)
            kw["scale"] = torch.rand(rows, device=dev, generator=g) + 0.5
        got = gs.grouped_swiglu(x, wg, wu, wd, **kw)
        again = gs.grouped_swiglu(x, wg, wu, wd, **kw)
        ref = gs.grouped_swiglu_reference(x, wg, wu, wd, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        check(np.isfinite(rel) and rel <= GROUPED_TOL,
              f"grouped_swiglu disagrees with its plain version ({name}): rel {rel:.3e}")
        check(torch.equal(got, again), f"grouped_swiglu: a second call's bits differ ({name})")
        worst = max(worst, err)
        del again, ref

        def library():  # the per-expert loop: sizes on the host, cuBLAS an expert
            sizes = cnt.tolist() if cnt is not None else [rows]
            y = torch.cat([F.linear(F.silu(F.linear(r, wg[e])) * F.linear(r, wu[e]), wd[e])
                           for e, r in enumerate(x.split(sizes)) if r.shape[0]])
            if cnt is not None:
                dest = kw["dest"]
                y = torch.empty_like(y).index_copy_(0, dest, y * kw["scale"][dest, None])
            return y

        iters = 5 if name != "dense" else 3
        times = time_turns({"kernel": lambda: gs.grouped_swiglu(x, wg, wu, wd, **kw),
                            "plain": lambda: gs.grouped_swiglu_reference(x, wg, wu, wd, **kw),
                            "library": library}, iters)
        flop = 2.0 * rows * 3 * hidden * n
        nbytes = 4.0 * (2 * x.numel() + wg.numel() + wu.numel() + wd.numel())
        bound_ms, bound_by = bound(3 * flop, nbytes, PEAK_TF32)
        ms = times["kernel"]
        print(f"[grouped] {name}: {rows} rows, {groups} group(s), K={hidden}, N={n}: max_abs "
              f"{err:.3e} max_rel {rel:.3e}; kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s "
              f"of f32 work), plain {times['plain']:.4f} ms, library {times['library']:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({3 * flop / 1e12:.3f} TFLOP of TF32 passes, {bound_by}) "
              f"share {bound_ms / ms:.1%}; rows computed "
              f"{int(gs.padded_rows(cnt)) if cnt is not None else rows} ({card})")
        out[name] = {"ms": ms, "plain_ms": times["plain"], "library_ms": times["library"],
                     "bound_ms": bound_ms, "bound_by": bound_by}
        del x, wg, wu, wd, got, kw
        torch.cuda.empty_cache()
    return worst, out


def tower_phase(card, sentences=64, seed=41):
    """One call of the language-model text tower (``models/moe_text.py``,
    Moonlight-16B-A3B's widths and 27 layers, 62.5 GB of seeded f32
    weights) on ``sentences`` sentences of 32-256 seeded ids, log-uniform
    as the Moonlight cell's, after a first call. The grouped SwiGLU's
    ``launches`` is set to 0 before the second call and read after it: two
    for the dense layer and two for each routed layer's experts and its
    shared experts, none on cuBLAS. ``ffn_tile_rows`` must gain each
    expert's pairs rounded up to whole row tiles."""
    from livelyspeaker_tpu_torch.models import MoETextEncoder
    from livelyspeaker_tpu_torch.ops import grouped_swiglu as gs

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    with torch.device("meta"):
        tower = MoETextEncoder()
    tower.to_empty(device=dev).eval()
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, w in tower.named_parameters():  # fan-in scaled, as benchmark/weights_lm.py
            if w.dim() > 1:
                w.normal_(0.0, w.shape[-1] ** -0.5, generator=g)
            else:
                w.normal_(0.0, 0.02, generator=g).add_(0.0 if "bias" in name else 1.0)
    rng = np.random.default_rng(seed)
    lengths = np.exp(rng.uniform(np.log(32), np.log(257), sentences)).astype(int).tolist()
    ids = torch.randint(0, tower.cfg.vocab_size, (sentences, max(lengths)),
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        tower(ids, lengths)  # RoPE's table, the counters
        torch.cuda.synchronize()
        load0, rows0 = tower.load.clone(), tower.tile_rows.clone()
        gs.grouped_swiglu.launches = 0
        t0 = time.perf_counter()
        z = tower(ids, lengths)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches, want = gs.grouped_swiglu.launches, 2 * (1 + 2 * tower.cfg.n_moe_layers)
    check(launches == want, f"tower: {launches} grouped SwiGLU launches a call, expected {want}")
    check(bool(torch.isfinite(z).all()), "tower: features not finite")
    load, rows = tower.load - load0, tower.tile_rows - rows0
    padded = [int(gs.padded_rows(layer)) for layer in load]
    check(rows.tolist() == padded, f"tower: ffn_tile_rows {rows.tolist()} is not each "
                                   f"expert's pairs in whole row tiles {padded}")
    pad = 100.0 * (1.0 - float(load.sum()) / float(rows.sum()))
    skew = float((load.max(1).values * load.shape[1] / load.sum(1)).max())
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[tower] one call of the Moonlight tower, {sum(lengths)} real tokens in "
          f"{sentences} sentences: {launches} grouped SwiGLU launches (2 x (1 dense + 2 x "
          f"{tower.cfg.n_moe_layers} routed layers)); {ms:.1f} ms; padding of the routed rows "
          f"{pad:.2f}%; worst layer's skew {skew:.2f}; peak {peak:.1f} GB ({card})")
    del tower, z
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens": sum(lengths), "ms": ms, "pad_pct": pad}


def bf16_kernel_phase(card):
    """K1's bf16 kernel against its plain bf16 version at TED (S=35, F=27)
    and BEAT (S=36, F=282), D=512, L=8, 2B in {16, 512}, LN2 folded and
    affine, with and without the pose projection; both against the f32
    kernel on the same weights; a second call's bits against the first's;
    the geometry transmlp_bf16_geometry picked; the time of the three and
    the bound at the bf16 tensor-core peak; at each batch every (cluster,
    group) the kernel takes at D=512, timed in turns. Then the bf16 path:
    no path of the package uses bf16 (f32 is the default, as in the JAX
    package), so the option is
    driven through its entry point, ``fused_transmlp``, as its user calls
    it: BF16_PATH_STEPS calls at the serving shape (TED, 2B = 16, LN2
    folded), each on the previous call's output with a step's embedding,
    the counts set to 0 before and read after. Returns (worst abs error,
    the serving call's numbers, the path's launches)."""
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
    from livelyspeaker_tpu_torch.ops import fused_mlp

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    bf16 = torch.bfloat16
    worst_abs, main = 0.0, None
    resident = fused_mlp.bf16_resident_clusters(512, dev)
    print(f"[bf16] clusters of the bf16 kernel the card holds at once at D=512, by (cluster, "
          f"group): {resident} ({card})")
    for name, seq, feats in (("TED", 35, 27), ("BEAT", 36, 282)):
        stack = random_normal_(TransMLP(seq, 8, 512, "silu"), g).to(dev)
        pose = random_normal_(torch.nn.Linear(512, feats), g).to(dev)
        for b2 in (16, 512):
            x = torch.randn(b2, seq, 512, generator=g).to(dev)
            emb = torch.randn(b2, 512, generator=g).to(dev)
            xb, eb = x.to(bf16), emb.to(bf16)
            geo = fused_mlp.transmlp_bf16_geometry(b2, seq, 512, resident)
            for fold in (False, True):
                p16 = fused_mlp.pack_transmlp_params(stack, fold_ln2=fold, dtype=bf16)
                p32 = fused_mlp.pack_transmlp_params(stack, fold_ln2=fold)
                for proj in (None, pose):
                    o16 = fused_mlp.pack_out_proj(proj, dtype=bf16) if proj is not None else None
                    o32 = fused_mlp.pack_out_proj(proj) if proj is not None else None
                    out = fused_mlp.fused_transmlp(xb, eb, p16, out_proj=o16)
                    again = fused_mlp.fused_transmlp(xb, eb, p16, out_proj=o16)
                    ref = fused_mlp.fused_transmlp_reference(xb, eb, p16, out_proj=o16)
                    f32 = fused_mlp.fused_transmlp(x, emb, p32, out_proj=o32)
                    torch.cuda.synchronize()
                    check(out.dtype == bf16 and out.shape == ref.shape, "bf16 kernel: bad output")
                    same = torch.equal(out, again)
                    err = (out.float() - ref.float()).abs().max().item()
                    top = ref.float().abs().max().item()
                    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
                    f32_top = f32.abs().max().item()
                    vs_f32 = (out.float() - f32).abs().max().item() / f32_top
                    plain_vs_f32 = (ref.float() - f32).abs().max().item() / f32_top
                    iters = 20 if b2 <= 16 else 5
                    ms = time_ms(lambda: fused_mlp.fused_transmlp(xb, eb, p16, out_proj=o16), iters)
                    plain = time_ms(lambda: fused_mlp.fused_transmlp_reference(
                        xb, eb, p16, out_proj=o16), iters)
                    f32_ms = time_ms(lambda: fused_mlp.fused_transmlp(x, emb, p32, out_proj=o32),
                                     iters)
                    flop, nbytes, peak = k1_cost(xb, eb, p16, o16)
                    bound_ms, bound_by = bound(flop, nbytes, peak)
                    tag = (f"{name} 2B={b2} S={seq} D=512 L=8 ln2={'folded' if fold else 'affine'} "
                           f"out={'F=%d' % feats if proj is not None else 'D'}")
                    print(f"[bf16] {tag}: max_abs {err:.4g} = {err / ulp:.2f} bf16 ulps of "
                          f"max|y| {top:.4g} (rel {err / top:.3e}, tol {BF16_TOL:.3e}), "
                          f"{(out != ref).sum().item()}/{out.numel()} elements differ; against "
                          f"the f32 kernel: kernel rel {vs_f32:.3e}, plain rel {plain_vs_f32:.3e}; "
                          f"bf16 kernel {ms:.4f} ms, plain {plain:.4f} ms, f32 kernel {f32_ms:.4f} "
                          f"ms; bound {bound_ms:.4f} ms ({flop / 1e9:.3f} GFLOP at the bf16 peak, "
                          f"{nbytes / 1e6:.2f} MB, {bound_by}) share {bound_ms / ms:.1%}; cluster "
                          f"{geo.cluster} x {geo.cols} columns, {geo.group} sequence(s) a "
                          f"cluster, wgmma N={geo.wgmma_n}, {geo.clusters} clusters; a second "
                          f"call's bits {'equal' if same else 'DIFFER'} ({card})")
                    check(np.isfinite(err) and err <= BF16_TOL * top,
                          f"bf16 kernel disagrees with its plain version at {tag}")
                    check(same, f"bf16 kernel: two calls give other bits at {tag}")
                    check(vs_f32 <= BF16_F32_TOL and plain_vs_f32 <= BF16_F32_TOL,
                          f"a bf16 stack is off the f32 kernel at {tag}")
                    worst_abs = max(worst_abs, err)
                    if name == "TED" and b2 == 16 and fold and proj is not None:
                        main = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                                "bound_by": bound_by}  # the serving call
            # every (cluster, group) the geometry can pick at D=512, serving layout
            p16 = fused_mlp.pack_transmlp_params(stack, fold_ln2=True, dtype=bf16)
            o16 = fused_mlp.pack_out_proj(pose, dtype=bf16)
            runs = {(n, gr): (lambda n=n, gr=gr: fused_mlp.launch_stack(xb, eb, p16, 0, o16,
                                                                      cluster=n, group=gr))
                    for n in fused_mlp.bf16_cluster_sizes(512) for gr in fused_mlp.BF16_GROUPS}
            times = time_turns(runs, 20 if b2 <= 16 else 5, rounds=4)
            print(f"[bf16] {name} 2B={b2} folded F={feats}, by (cluster, group) (in turns): "
                  + ", ".join(f"{n} CTAs x {gr} seq {t:.4f} ms" for (n, gr), t in times.items())
                  + f"; transmlp_bf16_geometry picks ({geo.cluster}, {geo.group}) ({card})")

    stack = random_normal_(TransMLP(35, 8, 512, "silu"), g).to(dev)
    packed = fused_mlp.pack_transmlp_params(stack, fold_ln2=True, dtype=bf16)
    x = torch.randn(16, 35, 512, generator=g).to(dev).to(bf16)
    embs = torch.randn(BF16_PATH_STEPS, 16, 512, generator=g).to(dev).to(bf16)
    torch.cuda.synchronize()
    fused_mlp.fused_transmlp.bf16_launches = fused_mlp.fused_transmlp.launches = 0
    fused_mlp.fused_transmlp_reference.calls = 0
    t0 = time.perf_counter()
    for k in range(BF16_PATH_STEPS):
        x = fused_mlp.fused_transmlp(x, embs[k], packed)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = fused_mlp.fused_transmlp.bf16_launches
    other = (fused_mlp.fused_transmlp.launches, fused_mlp.fused_transmlp_reference.calls)
    print(f"[bf16] path: {BF16_PATH_STEPS} calls of the bf16 stack at TED 2B=16 through "
          f"fused_transmlp: bf16 kernel launches {launches}, f32 kernel launches and plain calls "
          f"{other}, {wall:.2f} ms host clock, out {tuple(x.shape)} {x.dtype} finite "
          f"{bool(torch.isfinite(x).all())} ({card})")
    check(launches == BF16_PATH_STEPS and other == (0, 0),
          f"bf16 path: {launches} bf16 launches, f32 launches and plain calls {other}")
    check(x.dtype == bf16 and bool(torch.isfinite(x).all()), "bf16 path: output not finite bf16")
    print(f"[bf16] phase: {time.perf_counter() - t_phase:.1f} s")
    return worst_abs, main, launches


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


def fused_vs_eager(model, cond, guidance, tag, method=None, launches=20, **call_kw):
    """One batch through the fused sampler and the eager one (the serving
    default's respacing; ``method`` defaults to its sampler), from the same
    seeded generator: same noise, same style draws. The fused run launches
    K1 ``launches`` times. Returns the fused batch."""
    from livelyspeaker_tpu_torch.ops import fused_mlp
    from livelyspeaker_tpu_torch.pipeline import RAGSampler
    from livelyspeaker_tpu_torch.serving import ServeConfig

    sc = ServeConfig()
    outs = []
    for use_fused in (True, False):
        sampler = RAGSampler(model, steps=sc.steps, timestep_respacing=sc.timestep_respacing,
                             method=method or sc.sampler, use_fused=use_fused)
        gen = torch.Generator(device="cuda").manual_seed(7)
        n0, plain0 = fused_mlp.fused_transmlp.launches, fused_mlp.fused_transmlp_reference.calls
        outs.append(sampler(cond, gen, guidance=guidance, **call_kw))
        torch.cuda.synchronize()
        n = fused_mlp.fused_transmlp.launches - n0
        check(n == (launches if use_fused else 0),
              f"{tag}: fused={use_fused} launched the kernel {n} times")
        check(fused_mlp.fused_transmlp_reference.calls == plain0,
              f"{tag}: the plain version ran")
    fused, eager = outs
    c = model.cfg
    check(fused.shape == (cond["vid"].shape[0], c.njoints, c.nfeats, c.nframes), f"{tag}: shape")
    check(bool(torch.isfinite(fused).all()), f"{tag}: non-finite output")
    rel = ((fused - eager).abs().max() / eager.abs().max()).item()
    print(f"[{tag}] fused vs eager sampler, {tuple(fused.shape)}: rel {rel:.3e} (tol {SLICE_TOL})")
    check(rel <= SLICE_TOL, f"{tag}: fused path disagrees with the eager modules")
    return fused


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


def _device_table(prof, classes, wall_ms, title, steps, unit, labels=()):
    """Device time by kernel class from a torch.profiler run: lines of a
    table (ms per ``unit``, share of wall, launches), the idle share and
    the top kernels, and the launches of each class. ``labels``: the
    record_function names, whose spans on the device are not kernels."""
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.key not in labels]
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


COMPOSED_STEPS = 20  # ddim100 with skip_timesteps 80: the refinement's steps
SENTENCES = [
    "so we went down to the river that morning",
    "I never expected that, honestly",
    "the thing about cities is that they never sleep",
    "look at this, it is enormous",
    "we kept going, up and up, until the very top",
    "no",
    "people tend to forget how small the world has become over the last fifty years",
    "and then, all of a sudden, everyone started clapping",
]


def wall_ms(fn, reps=10):
    """Median host ms of ``fn()`` from a synchronised start to a
    synchronised end, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@torch.no_grad()
def composition_phase(card, profile_dir=None):
    """LivelySpeakerPipeline at full width (the configuration of the JAX
    package's eval scripts: SAG at latent 512, ViT-B/32's text tower,
    ddim100, skip 80, guidance 1.5), one batch of 8 at TED and one at BEAT:
    K1 on the fused run's main path, the eager run beside it; per-stage
    times at TED (and a profile of three batches with ``profile_dir``).
    Returns K1's launches over the two fused runs."""
    from livelyspeaker_tpu_torch.data import HashTokenizer
    from livelyspeaker_tpu_torch.models import SAG, CLIPTextEncoder, RAGConfig
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_mlp
    from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline

    launches = 0
    for tag, cfg, seed in (("composition-ted", RAGConfig.ted(), 15),
                           ("composition-beat", RAGConfig.beat(), 17)):
        rag = _random_model(cfg, seed)
        g = torch.Generator().manual_seed(seed + 1)
        sag = random_normal_(SAG(njoints=cfg.njoints, nfeats=cfg.nfeats, latent_dim=512,
                                 generator=g), g)
        clip = random_normal_(CLIPTextEncoder(generator=g), g)
        cond = _cond(cfg, np.random.default_rng(seed + 2), len(SENTENCES))
        pipes = {fused: LivelySpeakerPipeline(rag, sag, clip, HashTokenizer(), use_fused=fused)
                 for fused in (True, False)}
        check(pipes[True].device.type == "cuda", f"{tag}: the pipeline is not on the card")
        gen = lambda: torch.Generator(device="cuda").manual_seed(7)

        fused_mlp.fused_transmlp.launches = 0
        fused_mlp.fused_transmlp_reference.calls = 0
        out = pipes[True](SENTENCES, cond, gen(), guidance=1.5)
        torch.cuda.synchronize()
        n, plain = fused_mlp.fused_transmlp.launches, fused_mlp.fused_transmlp_reference.calls
        launches += n
        shape = (len(SENTENCES), cfg.njoints, cfg.nfeats, cfg.nframes)
        check(tuple(out.shape) == shape, f"{tag}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite clip")
        print(f"[{tag}] fused_transmlp launches {n} for a batch of {len(SENTENCES)}, "
              f"plain version calls {plain}")
        check(n == COMPOSED_STEPS and plain == 0,
              f"{tag}: K1 launched {n} times (want {COMPOSED_STEPS}), plain version {plain}")

        eager = pipes[False](SENTENCES, cond, gen(), guidance=1.5)
        rel = _rel(out, eager)
        print(f"[{tag}] fused vs eager composition, {tuple(out.shape)}: rel {rel:.3e} "
              f"(tol {SLICE_TOL})")
        check(rel <= SLICE_TOL, f"{tag}: fused composition disagrees with the eager modules")
        if tag != "composition-ted":
            continue
        pipe = pipes[True]
        tokens = torch.from_numpy(pipe.tokenizer(SENTENCES)).cuda()
        z = pipe.clip_text(tokens)
        sketch = pipe.sag.decode(z, cond["origin_x"])
        clip_ms = wall_ms(lambda: pipe.clip_text(tokens))
        sag_ms = wall_ms(lambda: pipe.sag.decode(z, cond["origin_x"]))
        refine_ms = wall_ms(lambda: pipe.rag_sampler(
            cond, gen(), guidance=1.5, skip_timesteps=pipe.skip_timesteps, init_image=sketch))
        batch_ms = wall_ms(lambda: pipe(SENTENCES, cond, gen(), guidance=1.5))
        per = f"a batch of {len(SENTENCES)}, host ms, synchronised, median of 10"
        print(f"[{tag}] CLIP encode: {clip_ms:.3f} ms ({per})")
        print(f"[{tag}] SAG decode: {sag_ms:.3f} ms ({per})")
        print(f"[{tag}] {COMPOSED_STEPS}-step refinement: {refine_ms:.3f} ms ({per})")
        print(f"[{tag}] whole pipeline: {batch_ms:.3f} ms, "
              f"{len(SENTENCES) / batch_ms * 1e3:.2f} clips/s ({per})")
        print(f"[{tag}] card: {card}")
        if profile_dir:
            composition_profile(pipe, cond, gen, profile_dir, card)
    return launches


def composition_profile(pipe, cond, gen, out_dir, card, batches=3):
    """torch.profiler over ``batches`` composed batches, the stages of
    ``LivelySpeakerPipeline.__call__`` under record_function labels: host
    and device ms a batch by stage, device time by kernel class and the
    idle share, into DIR/composition_trace.json and
    DIR/composition_profile.txt."""
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            with record_function("clip_encode"):
                z = pipe.clip_text(torch.from_numpy(pipe.tokenizer(SENTENCES)).cuda())
            with record_function("sag_decode"):
                sketch = pipe.sag.decode(z, cond["origin_x"])
            with record_function("refinement"):
                pipe.rag_sampler(cond, gen(), guidance=1.5, skip_timesteps=pipe.skip_timesteps,
                                 init_image=sketch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, "composition_trace.json"))
    classes = {"K1 fused_transmlp": ("fused_transmlp_cluster_kernel",),
               "cuDNN conv (WavEncoder)": ("cudnn", "convolve", "fprop_implicit"),
               "cuBLAS GEMM (CLIP, SAG, per-batch set-up)": ("_gemm_", "cublas", "gemv",
                                                              "gemmk")}
    stages = ("clip_encode", "sag_decode", "refinement")
    lines, head, counts = _device_table(
        prof, classes, wall_ms, f"composition: {batches} TED batches of {len(SENTENCES)} "
        f"({card})", batches, "batch", labels=stages)
    # a stage's device span is its record_function range on the device (its
    # first kernel's start to its last kernel's end); busy, the kernels
    # that start inside it
    events = prof.events()
    dev = [e for e in events if e.device_type.name == "CUDA"]
    kernels = [e for e in dev if e.name not in stages]
    for i, k in enumerate(stages):
        spans = [e.time_range for e in dev if e.name == k]
        span = sum(r.elapsed_us() for r in spans) / 1e3
        busy = sum(e.time_range.elapsed_us() for e in kernels
                   if any(r.start <= e.time_range.start < r.end for r in spans)) / 1e3
        host = sum(e.time_range.elapsed_us() for e in events
                   if e.name == k and e.device_type.name == "CPU") / 1e3
        lines.insert(1 + i, f"{k}: host {host / batches:.3f} ms a batch, device span "
                     f"{span / batches:.3f} ms, busy {busy / batches:.3f} ms "
                     f"({100 * (1 - busy / span) if span else 100:.1f}% idle)")
        head += 1
    with open(os.path.join(out_dir, "composition_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:head + 1]:
        print(f"[profile] {line}")
    k1 = counts["K1 fused_transmlp"]
    check(k1 == COMPOSED_STEPS * batches,
          f"composition profile: {k1} K1 kernels for {batches} batches")


LONG_SECONDS = 10  # 150 frames at 15 fps: 5 windows of long_form_window_grid
LONG_WINDOWS = 5
RELOAD_TOKEN = "chip-smoke"


def _write_checkpoints(out_dir):
    """Seeded random TED weights (RAGConfig.ted(), full width) with their
    args.json, a second version of them for the reload, and a SAG (latent
    512, ff 1024, 3 layers, 4 heads), each as the JAX package's npz. Returns
    the RAG (on the card) and the paths."""
    from livelyspeaker_tpu_torch.models import SAG, RAGConfig
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz

    cfg = RAGConfig.ted()
    model = _random_model(cfg, seed=21)
    paths = {k: os.path.join(out_dir, f"{k}.npz") for k in ("rag", "rag_v2", "sag")}
    save_params_npz(paths["rag"], model.state_dict(), model)
    save_params_npz(paths["rag_v2"], {k: 1.01 * v for k, v in model.state_dict().items()},
                    model)
    save_args(out_dir, {"njoints": cfg.njoints, "nfeats": cfg.nfeats, "n_poses": cfg.nframes,
                        "latent_dim": cfg.latent_dim, "layers": cfg.num_layers,
                        "mlpact": cfg.mlpact, "n_speakers": cfg.n_speakers,
                        "num_emotions": cfg.num_emotions, "cond_mask_prob": cfg.cond_mask_prob})
    g = torch.Generator().manual_seed(22)
    sag = random_normal_(SAG(njoints=cfg.njoints, nfeats=cfg.nfeats, latent_dim=512,
                             ff_size=1024, num_layers=3, num_heads=4, generator=g), g)
    save_params_npz(paths["sag"], sag.state_dict(), sag)
    return model, paths


class _Client:
    """JSON over HTTP/1.1 to the front end, a connection a request."""

    def __init__(self, address):
        self.host, self.port = address[:2]

    def _conn(self):
        import http.client

        return http.client.HTTPConnection(self.host, self.port, timeout=600)

    def get(self, path):
        conn = self._conn()
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            body = r.read()
        finally:
            conn.close()
        check(r.status == 200, f"front end: GET {path} answered {r.status}")
        return r.headers, body

    def post(self, path, obj):
        """(answer, client ms)."""
        conn = self._conn()
        try:
            t0 = time.perf_counter()
            conn.request("POST", path, body=json.dumps(obj),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            body = r.read()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            conn.close()
        check(r.status == 200, f"front end: POST {path} answered {r.status}: {body[:200]}")
        return json.loads(body), ms

    def stream(self, obj):
        """The NDJSON lines of a streamed answer and the client ms to the
        first line."""
        conn = self._conn()
        try:
            t0 = time.perf_counter()
            conn.request("POST", "/v1/generate", body=json.dumps(obj),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            check(r.status == 200, f"front end: streamed request answered {r.status}")
            check(r.headers["Content-Type"] == "application/x-ndjson",
                  "front end: a streamed answer is not NDJSON")
            lines, first_ms = [], None
            while True:
                line = r.readline()
                if not line:
                    break
                if first_ms is None:
                    first_ms = (time.perf_counter() - t0) * 1e3
                if line.strip():
                    lines.append(json.loads(line))
        finally:
            conn.close()
        return lines, first_ms


def _in_threads(n_threads, work):
    """``work(k)`` in ``n_threads`` threads at once; their results in order,
    the errors and the wall seconds."""
    results, errors = [None] * n_threads, []

    def run(k):
        try:
            results[k] = work(k)
        except BaseException as e:  # reported by the caller
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(all(not t.is_alive() for t in threads), "front end: a client thread hung")
    return results, errors, time.perf_counter() - t0


def _audio_b64(audio):
    import base64

    return base64.b64encode(np.ascontiguousarray(audio, np.float32).tobytes()).decode()


def _clip(answer, shape, what):
    m = np.asarray(answer["motion"], np.float32)
    check(m.shape == shape and list(shape) == answer.get("shape", list(shape)),
          f"front end: {what} has shape {m.shape}, want {shape}")
    check(np.isfinite(m).all(), f"front end: {what} is not finite")
    return m


def front_end_phase(card):
    """The HTTP front end (``livelyspeaker_tpu_torch.scripts.serve``) on
    checkpoints written here, at its defaults (dpmpp over ddim20, max_batch
    8, text through the composition over ddim100 with skip 80): plain, text,
    long and streamed long requests, /stats and /metrics, a reload; K1 20
    times a batch served, its plain version never, text and plain never in
    one batch. Then a PLMS batcher (21 launches a batch), and PLMS,
    inpainting and long form fused against eager. Returns K1's launches on
    the main paths (the front end and the PLMS batcher)."""
    import tempfile

    from livelyspeaker_tpu_torch.diffusion import Inpainting
    from livelyspeaker_tpu_torch.ops import fused_mlp
    from livelyspeaker_tpu_torch.pipeline import (
        RAGSampler,
        generate_long_form,
        long_form_window_grid,
    )
    from livelyspeaker_tpu_torch.scripts import serve
    from livelyspeaker_tpu_torch.serving import ServeConfig, build_rag_server

    rng = np.random.default_rng(23)
    with tempfile.TemporaryDirectory() as tmp:
        model, paths = _write_checkpoints(tmp)
        t0 = time.perf_counter()
        srv, batcher = serve.build_server([
            "--model_path", paths["rag"], "--sag_path", paths["sag"], "--host", "127.0.0.1",
            "--port", "0", "--reload_token", RELOAD_TOKEN])
        print(f"[front-end] build_server (checkpoints loaded, plain and text routes warmed) "
              f"{time.perf_counter() - t0:.2f} s")
        check(batcher.device.type == "cuda", "front end: the batcher is not on the card")
        batches = []  # (texts, plains, K1 launches) a dispatched batch
        dispatch = batcher._dispatch

        def counted(batch):
            n0 = fused_mlp.fused_transmlp.launches
            out = dispatch(batch)
            n_text = sum(1 for r in batch if r.text)
            batches.append((n_text, len(batch) - n_text, fused_mlp.fused_transmlp.launches - n0))
            return out

        batcher._dispatch = counted
        server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
        server_thread.start()
        client = _Client(srv.server_address)
        n = batcher.n_samples
        try:
            fused_mlp.fused_transmlp.launches = 0
            fused_mlp.fused_transmlp_reference.calls = 0
            batcher.reset_stats()

            # 1. 16 plain requests from 4 threads
            plain_audio = [(0.1 * rng.normal(size=n)).astype(np.float32) for _ in range(16)]
            speakers = rng.integers(0, 1400, size=16)

            def plain(k):
                return [client.post("/v1/generate", {"audio_b64": _audio_b64(plain_audio[i]),
                                                     "speaker": int(speakers[i])})
                        for i in range(4 * k, 4 * k + 4)]

            res, errors, wall = _in_threads(4, plain)
            check(not errors, f"front end: a plain request failed: {errors[:1]}")
            plain_ms = [ms for r in res for _, ms in r]
            for r in res:
                for answer, _ in r:
                    _clip(answer, (9, 3, 34), "a plain clip")
            p50, p95 = np.percentile(plain_ms, 50), np.percentile(plain_ms, 95)
            print(f"[front-end] 16 plain requests from 4 threads over HTTP: p50 {p50:.2f} ms "
                  f"p95 {p95:.2f} ms (client clock), {16 / wall:.2f} clips/s ({card})")

            # 2. 8 text requests from 4 threads, beside 4 plain from 2 more
            def mixed(k):
                if k < 4:
                    return [client.post("/v1/generate", {
                        "audio_b64": _audio_b64(plain_audio[2 * k + j]),
                        "text": SENTENCES[2 * k + j]}) for j in range(2)]
                return [client.post("/v1/generate", {"audio_b64": _audio_b64(plain_audio[k])})
                        for _ in range(2)]

            res, errors, wall = _in_threads(6, mixed)
            check(not errors, f"front end: a text request failed: {errors[:1]}")
            for r in res:
                for answer, _ in r:
                    _clip(answer, (9, 3, 34), "a text or plain clip")
            text_ms = [ms for r in res[:4] for _, ms in r]
            print(f"[front-end] 8 text requests beside 4 plain: text p50 "
                  f"{np.percentile(text_ms, 50):.2f} ms, the 12 in {wall * 1e3:.2f} ms ({card})")

            # 3. one long request over 10 s of audio, 4. the same streamed
            long_audio = (0.1 * rng.normal(size=LONG_SECONDS * 16000)).astype(np.float32)
            grid = long_form_window_grid(len(long_audio), 34, 4)
            check(grid[0] == LONG_WINDOWS and grid[3] == 15 * LONG_SECONDS,
                  f"front end: the window grid is {grid[:4]}")
            request = {"audio_b64": _audio_b64(long_audio), "speaker": 5, "long": True}
            batcher._generator.manual_seed(31)  # the worker is idle: no other draw
            answer, long_ms = client.post("/v1/generate", request)
            long_clip = _clip(answer, (9, 3, 15 * LONG_SECONDS), "the long clip")
            batcher._generator.manual_seed(31)
            lines, first_ms = client.stream(dict(request, stream=True))
            check([ln.get("window") for ln in lines] == list(range(LONG_WINDOWS)),
                  f"front end: streamed windows {[ln.get('window') for ln in lines]}")
            streamed = np.concatenate([np.asarray(ln["motion"], np.float32) for ln in lines], -1)
            check(streamed.shape == long_clip.shape, "front end: the streamed clip's shape")
            rel = float(np.abs(streamed - long_clip).max() / np.abs(long_clip).max())
            print(f"[front-end] long request, 10 s of audio: {long_ms:.2f} ms, "
                  f"{long_ms / LONG_WINDOWS:.2f} ms a window; streamed: first NDJSON line "
                  f"after {first_ms:.2f} ms, chunks against the blocking answer rel {rel:.3e} "
                  f"(tol {SLICE_TOL}) ({card})")
            check(rel <= SLICE_TOL, "front end: the streamed chunks differ from the long answer")

            # 5. /stats and /metrics
            stats = json.loads(client.get("/stats")[1])
            _, metrics = client.get("/metrics")
            check(stats["requests_served"] == 16 + 12 + 2 * LONG_WINDOWS,
                  f"front end: /stats counts {stats['requests_served']} requests")
            check(b"livelyspeaker_requests_served" in metrics, "front end: /metrics")
            print(f"[front-end] /stats: {stats}")

            # 6. a reload, then one request
            answer, _ = client.post("/v1/reload", {"model_path": paths["rag_v2"],
                                                    "token": RELOAD_TOKEN})
            check(answer.get("param_version") == 1, f"front end: reload answered {answer}")
            _clip(client.post("/v1/generate", {"audio_b64": _audio_b64(plain_audio[0])})[0],
                  (9, 3, 34), "the clip after the reload")
            launches = fused_mlp.fused_transmlp.launches
            plain_calls = fused_mlp.fused_transmlp_reference.calls
        finally:
            srv.shutdown()
            srv.server_close()
            batcher.close()
            server_thread.join(timeout=60)
    check(all(t == 0 or p == 0 for t, p, _ in batches),
          f"front end: text and plain requests shared a batch: {batches}")
    check(all(k == 20 for _, _, k in batches),
          f"front end: K1 launches a batch {[k for _, _, k in batches]}, want 20 each")
    check(launches == 20 * len(batches) and plain_calls == 0,
          f"front end: {launches} K1 launches for {len(batches)} batches, plain {plain_calls}")
    print(f"[front-end] {len(batches)} batches ({sum(1 for t, _, _ in batches if t)} of text), "
          f"sizes {[t + p for t, p, _ in batches]}, fused_transmlp launches {launches}, "
          f"plain version calls {plain_calls}")

    # PLMS (order 2) behind the batcher: 21 launches a batch
    plms = build_rag_server(model, ServeConfig(sampler="plms"))
    try:
        plms.generate(plain_audio[0], timeout=600)  # warm-up
        plms.reset_stats()
        fused_mlp.fused_transmlp.launches = 0
        reqs = [plms.submit(a, speaker=int(s)) for a, s in zip(plain_audio[:8], speakers)]
        for r in reqs:
            c = r.wait(timeout=600)
            check(c.shape == (9, 3, 34) and np.isfinite(c).all(), "plms: a clip")
        torch.cuda.synchronize()
        plms_launches = fused_mlp.fused_transmlp.launches
        plms_batches = plms.stats()["batches_served"]
    finally:
        plms.close()
    print(f"[plms] 8 requests in {plms_batches} batches, fused_transmlp launches {plms_launches}")
    check(plms_launches == 21 * plms_batches, "plms: K1 did not launch 21 times a batch")
    check(fused_mlp.fused_transmlp_reference.calls == 0, "plms: the plain version ran")

    cfg = model.cfg
    fused_vs_eager(model, _cond(cfg, rng, 8), 1.5, "plms", method="plms", launches=21)
    cond = _cond(cfg, rng, 8)
    mask = torch.zeros(8, 9, 3, 34, dtype=torch.bool, device="cuda")
    mask[..., :4] = True
    motion = torch.randn(8, 9, 3, 34, generator=torch.Generator().manual_seed(24)).cuda()
    fused = fused_vs_eager(model, cond, 1.5, "inpainting",
                           inpainting=Inpainting(mask, motion, noised=True))
    check(torch.equal(fused[mask], motion[mask]),
          "inpainting: the first 4 frames are not the constraint")

    outs = []
    for use_fused in (True, False):
        sampler = RAGSampler(model, timestep_respacing="ddim20", method="dpmpp",
                             use_fused=use_fused)
        n0 = fused_mlp.fused_transmlp.launches
        outs.append(generate_long_form(sampler, long_audio, 5,
                                       torch.Generator(device="cuda").manual_seed(7)))
        k = fused_mlp.fused_transmlp.launches - n0
        check(k == (20 * LONG_WINDOWS if use_fused else 0), f"long form: {k} K1 launches")
    rel = float(np.abs(outs[0] - outs[1]).max() / np.abs(outs[1]).max())
    check(outs[0].shape == (9, 3, 15 * LONG_SECONDS) and np.isfinite(outs[0]).all(),
          "long form: the clip")
    print(f"[long-form] fused vs eager generate_long_form, {LONG_WINDOWS} windows "
          f"{outs[0].shape}: rel {rel:.3e} (tol {SLICE_TOL})")
    check(rel <= SLICE_TOL, "long form: the fused chain disagrees with the eager one")
    return launches + plms_launches


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
    3xTF32 products on the tensor cores: the weight-gradient kernel's three
    TF32 products at the TF32 peak, and the forward's channel mix beside its
    token mix at ``peak_3xtf32``, as k1_cost; each kernel's inputs read
    once, its outputs written once."""
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
    cost = {"fwd": fwd + (peak_3xtf32(b * layers * 2 * s * d * d, b * layers * 2 * s * s * d),)}
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


def conv0_taps(b, length):
    """The taps of conv0 that b waveforms of ``length`` samples need: those
    of the times whose window reaches a sample (``conv0_live``). Conv0 at
    every other time is b0 exactly and needs none."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    lo, hi = k3.conv0_live(length)
    return b * (hi - lo) * 32 * 15


def k3_wgrad_cost(b, length, i):
    """(operations, bytes, peak) of conv i's weight-gradient launch: the
    [15 C_in, B T_i] x [B T_i, C_out] product as 3xTF32, three TF32
    products at the TF32 peak, and for conv1 conv0's recompute as f32
    outside the tensor cores (counted in TF32-peak time); it reads its
    input and statistics and the cotangent once, and writes its partials."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
    flop = 3 * 2 * b * t[i] * 15 * cin * cout
    if i == 1:
        flop += 2 * conv0_taps(b, length) * PEAK_TF32 / PEAK_FLOPS
    nsplit = k3.wgrad_geometry(b, t[i], cin, cout).nsplit
    inputs = b * length if i == 1 else b * t[i - 1] * cin
    nbytes = 4 * (inputs + 2 * b * cin + b * t[i] * cout + nsplit * (cout * cin * 15 + cout))
    return flop, nbytes, PEAK_TF32


def k3_bwd_data_cost(b, length, i):
    """(operations, bytes, peak) of conv i's data-gradient launches: the
    [B T_in, 3 C_out] x [3 C_out, 6 C_in] product by residue of the stride
    (the useful 2 B T_i C_out C_in 15 FLOP) as 3xTF32, three TF32 products
    at the TF32 peak, and for conv1 conv0's recompute as f32 outside the
    tensor cores (counted in TF32-peak time); it reads the cotangent, its
    input, statistics and split weights once, and writes gy and the tile
    sums."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
    flop = 3 * 2 * b * t[i] * 15 * cin * cout
    if i == 1:
        flop += 2 * conv0_taps(b, length) * PEAK_TF32 / PEAK_FLOPS
    inputs = b * length if i == 1 else b * t[i - 1] * cin
    ntq = k3._bwd_data_tiles(t[i - 1], i == 1)
    nbytes = 4 * (b * t[i] * cout + inputs + 2 * b * cin + 2 * cout * cin * 15
                  + b * t[i - 1] * cin + b * ntq * 2 * cin)
    return flop, nbytes, PEAK_TF32


def k3_conv_fwd_cost(b, length, i):
    """(operations, bytes, peak) of conv i's forward conv launch: the
    2 B T_i 15 C_in C_out FLOP product as 3xTF32, three TF32 products at the
    TF32 peak, and for conv1 conv0's recompute as f32 outside the tensor
    cores (counted in TF32-peak time); it reads its input and statistics,
    the split weights and the bias once, and writes its output."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
    flop = 3 * 2 * b * t[i] * 15 * cin * cout
    if i == 1:
        flop += 2 * conv0_taps(b, length) * PEAK_TF32 / PEAK_FLOPS
    inputs = b * length + 32 * 16 if i == 1 else b * t[i - 1] * cin
    nbytes = 4 * (inputs + 2 * b * cin + 2 * cout * cin * 15 + cout + b * t[i] * cout)
    return flop, nbytes, PEAK_TF32


def k3_cost(b, length):
    """(FLOP, bytes[, peak]) of each K3 kernel over one forward and one
    backward call without d_wav (all its launches), from the shapes: the
    convs' FLOPs at the f32 peak, conv0 counted once over the times that
    need it (``conv0_taps``) wherever a kernel recomputes it, but the
    forward convs', weight and data gradients' as
    k3_conv_fwd_cost, k3_wgrad_cost and k3_bwd_data_cost count them; each
    kernel's inputs read once, its outputs written once."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    ch = k3.CHANNELS
    size = [b * t[i] * ch[i + 1] for i in range(4)]  # floats of conv i's output
    wts = [ch[i + 1] * ch[i] * 15 + ch[i + 1] for i in range(4)]
    wav = b * length
    cost = {
        "stats0": (2 * conv0_taps(b, length), 4 * (wav + wts[0] + 2 * b * 32)),
        "stats": (3 * (size[1] + size[2]), 4 * (size[1] + size[2] + 2 * b * (64 + 128))),
        "in_bwd": (6 * (size[1] + size[2]), 4 * 3 * (size[1] + size[2])),
    }
    conv_fwd = [k3_conv_fwd_cost(b, length, i) for i in (1, 2, 3)]
    cost["conv_fwd"] = (sum(c[0] for c in conv_fwd), sum(c[1] for c in conv_fwd), PEAK_TF32)
    # weight and data gradients of conv1..3 (conv0 recomputed for conv1);
    # the row-chunk partials of the weight gradients, as the wrapper splits;
    # the three TF32 products of each at the TF32 peak, conv1's conv0
    # recompute at the f32 one (k3_wgrad_cost, k3_bwd_data_cost)
    nparts = [k3.wgrad0_geometry(b, length).ctas] + [
        k3.wgrad_geometry(b, t[i], ch[i], ch[i + 1]).nsplit for i in (1, 2, 3)]
    parts = sum(n * w for n, w in zip(nparts, wts))
    wgrad = [k3_wgrad_cost(b, length, i) for i in (1, 2, 3)]
    cost["wgrad"] = (sum(c[0] for c in wgrad), sum(c[1] for c in wgrad), PEAK_TF32)
    bwd_data = [k3_bwd_data_cost(b, length, i) for i in (1, 2, 3)]
    cost["bwd_data"] = (sum(c[0] for c in bwd_data), sum(c[1] for c in bwd_data), PEAK_TF32)
    cost["wgrad0"] = (4 * conv0_taps(b, length), 4 * (wav + size[0] + nparts[0] * wts[0]))
    # the weight splits, forward and backward: each reads w_i once and
    # writes its two TF32 halves
    split = sum(ch[i + 1] * ch[i] * 15 for i in (1, 2, 3))
    cost["wsplit"] = (4 * split, 4 * 3 * split)
    cost["wsplit_fwd"] = cost["wsplit"]
    cost["reduce"] = (parts, 4 * (parts + sum(wts)))
    return cost


def wav_conv_fwd_turns(card, b, iters=10):
    """K3's forward conv kernel alone, conv by conv, at TED's waveform
    length: conv i's launches of ``conv_forward`` (the weights split into
    TF32 halves, then the conv over lrelu(IN(pre))), against cuDNN's forward
    conv of the same conv on the materialised input a = lrelu(IN(pre)) laid
    out [B, C_in, T_in] (F.conv1d, f32, TF32 off), which does no
    InstanceNorm, LeakyReLU or conv0 recompute. Each is replayed from a CUDA
    graph, timed in turns (kernel, cuDNN, cuDNN, kernel). The kernel's
    output is held first against the plain conv in f64 and a second launch
    against the first's bits. Returns {i: (kernel ms, cuDNN ms)}."""
    import torch.nn.functional as F

    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    g = torch.Generator().manual_seed(60 + b)
    enc = random_normal_(WavEncoder(), g).cuda()
    packed = k3.pack_wav_params(enc, differentiable=False)
    length = audio_samples_for_frames(34)
    wav = (0.1 * torch.randn(b, length, generator=g)).cuda()
    _, res = k3.fused_wav_forward(wav, packed)
    xh = k3.lrelu_inputs(res, packed)
    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    out = {}
    for i in (1, 2, 3):
        a = F.leaky_relu(xh[i - 1], 0.3).contiguous()  # [B, C_in, T_in]
        w, bias = packed[f"w{i}"], packed[f"b{i}"]
        y = k3.conv_forward(i, res, packed)
        same = torch.equal(y, k3.conv_forward(i, res, packed))
        ref = F.conv1d(a.double(), w.double(), bias.double(), stride=6).transpose(1, 2)
        rel = _rel(y.double(), ref)
        cudnn = lambda: F.conv1d(a, w, bias, stride=6)
        crel = _rel(cudnn().double().transpose(1, 2), ref)
        del ref
        check(same and rel <= KERNEL_TOL, f"K3 conv_fwd conv{i} B={b}: rel {rel:.3e} against "
              f"f64, same bits on a second launch: {same}")
        times = time_turns({"kernel": graphed(lambda: k3.conv_forward(i, res, packed)),
                            "cudnn": graphed(cudnn)}, iters)
        flop, nbytes, peak = k3_conv_fwd_cost(b, length, i)
        bound_ms = bound(flop, nbytes, peak)[0]
        out[i] = (times["kernel"], times["cudnn"])
        print(f"[wav-conv-fwd] conv{i} B={b} T_out {t[i]}, {k3.conv_fwd_tiles(b, t[i])[0]} tiles: "
              f"kernel {times['kernel']:.4f} ms (rel {rel:.1e} against f64), bound "
              f"{bound_ms:.4f} ms (share {bound_ms / times['kernel']:.1%}); cuDNN forward conv "
              f"{times['cudnn']:.4f} ms (rel {crel:.1e}, without IN, LeakyReLU or conv0); "
              f"CUDA graphs, in turns ({card})")
    print(f"[wav-conv-fwd] B={b}: the three convs {sum(v[0] for v in out.values()):.4f} ms, "
          f"cuDNN {sum(v[1] for v in out.values()):.4f} ms ({card})")
    return out


def graphed_reps(fn, reps):
    """``graphed`` over ``reps`` calls of ``fn`` in one graph: replays
    that keep the card busy between a short function's calls. Time it and
    divide by ``reps``."""
    return graphed(lambda: [fn() for _ in range(reps)])


def stats_errors(st, m):
    """(mean error in units of the std, relative 1/std error) of the
    statistics st [B, 2, C] of m [B, T, C] against the two-pass ones in
    f64: what an error does to xhat = (m - mean) / std."""
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    ref = k3._norm_stats(m.double().transpose(1, 2))
    st = st.double()
    return (((st[:, 0] - ref[:, 0]) * ref[:, 1]).abs().max().item(),
            ((st[:, 1] - ref[:, 1]) / ref[:, 1]).abs().max().item())


def wav_stats_turns(card, b, others=None, iters=10, reps=10):
    """K3's statistics kernel alone, at TED's waveform length: the two
    launches of a forward (``norm_stats`` of the m1 [B, T2, 64] and m2
    [B, T3, 128] that a forward produced) against the library's
    torch.var_mean(m, dim=1, correction=0) then (var + 1e-5).rsqrt() on the
    same tensors, and var_mean alone. Each is held first against the
    two-pass statistics in f64 (the mean within KERNEL_TOL of the std,
    1/std within KERNEL_TOL relative) and a second call against the first's
    bits; then each tensor's call is replayed from a CUDA graph of ``reps``
    calls and all are timed in turns. ``others``: more {name: stats
    function} (another build's), checked and timed in the same turns.
    Returns {name: ms of the two calls}."""
    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    g = torch.Generator().manual_seed(90 + b)
    enc = random_normal_(WavEncoder(), g).cuda()
    packed = k3.pack_wav_params(enc, differentiable=False)
    wav = (0.1 * torch.randn(b, audio_samples_for_frames(34), generator=g)).cuda()
    _, res = k3.fused_wav_forward(wav, packed)
    ms = {"m1": res.m1, "m2": res.m2}

    def library(m):
        var, _ = torch.var_mean(m, dim=1, correction=0)
        return (var + k3.EPS).rsqrt()

    fns = {"kernel": k3.norm_stats, **(others or {})}
    notes, runs = [], {}
    for name, fn in fns.items():
        for key, m in ms.items():
            st = fn(m)
            same = torch.equal(st, fn(m))
            err = stats_errors(st, m)
            notes.append(f"{name} {key} errors {err[0]:.1e} / {err[1]:.1e}")
            check(same and max(err) <= KERNEL_TOL, f"K3 stats {name} {key} B={b}: errors "
                  f"{err[0]:.3e} (mean, of the std) {err[1]:.3e} (1/std) against f64, same "
                  f"bits on a second call: {same}")
            runs[f"{name} {key}"] = graphed_reps(lambda fn=fn, m=m: fn(m), reps)
    for key, m in ms.items():
        ref = k3._norm_stats(m.double().transpose(1, 2))[:, 1]
        notes.append(f"library {key} 1/std rel {_rel(library(m).double(), ref):.1e}")
        runs[f"library {key}"] = graphed_reps(lambda m=m: library(m), reps)
        runs[f"var_mean {key}"] = graphed_reps(
            lambda m=m: torch.var_mean(m, dim=1, correction=0), reps)
    times = {k: v / reps for k, v in time_turns(runs, iters).items()}
    names = list(fns) + ["library", "var_mean"]
    out = {n: times[f"{n} m1"] + times[f"{n} m2"] for n in names}
    nbytes = 4 * (res.m1.numel() + res.m2.numel() + 2 * b * (64 + 128))
    bound_ms = bound(0, nbytes)[0]
    print(f"[wav-stats] B={b} m1 {list(res.m1.shape)} m2 {list(res.m2.shape)}, ms a forward's "
          f"two calls (m1 + m2): " + ", ".join(
              f"{n} {out[n]:.4f} ({times[f'{n} m1']:.4f} + {times[f'{n} m2']:.4f})"
              for n in names)
          + f"; bound {bound_ms:.4f} ms (bytes; kernel share {bound_ms / out['kernel']:.1%}); "
          f"{'; '.join(notes)}; CUDA graphs of {reps} calls, in turns ({card})")
    return out


def wav_reduce_turns(card, b, others=None, iters=20, reps=10):
    """K3's reduce kernel alone: one backward's four launches (the weight-
    gradient partials of conv3, conv2 and conv1 in ``wgrad_geometry``'s
    chunks, and conv0's in ``wgrad0_geometry``'s rows), each against
    part.sum(0) on the same partials. Each sum is held first against f64
    and a second launch against the first's bits, and the kernel's against
    the CPU plain version's bit for bit; then each launch is replayed from
    a CUDA graph of ``reps`` launches, one graph a conv, and all are timed
    in turns.
    ``others``: more {name: reduce function} with ``reduce_partials``'
    signature (another build's), checked and timed in the same turns.
    Returns {name: {conv i: ms}}, with the four summed under "sum"."""
    from livelyspeaker_tpu_torch.models import audio_samples_for_frames
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    g = torch.Generator().manual_seed(70 + b)
    dims = k3.WavDims(audio_samples_for_frames(34))
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    ch = k3.CHANNELS
    parts = {i: torch.randn(k3.wgrad_geometry(b, t[i], ch[i], ch[i + 1]).nsplit,
                            ch[i + 1] * ch[i] * 15 + ch[i + 1], generator=g).cuda()
             for i in (3, 2, 1)}
    parts[0] = torch.randn(k3.wgrad0_geometry(b, dims.L).ctas, 32 * 15 + 32, generator=g).cuda()
    flat = lambda out: torch.cat([out[0].reshape(-1), out[1]])
    fns = {"kernel": k3.reduce_partials, **(others or {})}
    rel, runs = 0.0, {}
    for name, fn in fns.items():
        for i, part in parts.items():
            got = flat(fn(part, i))
            same = torch.equal(got, flat(fn(part, i)))
            if name == "kernel":
                same = same and torch.equal(got.cpu(), flat(k3.reduce_partials(part.cpu(), i)))
            rel = max(rel, _rel(got.double(), part.double().sum(0)))
            check(same and rel <= GRAD_TOL, f"K3 reduce {name} conv{i} B={b}: rel {rel:.3e} "
                  f"against f64, same bits twice (and as the CPU's): {same}")
            runs[f"{name} {i}"] = graphed_reps(lambda fn=fn, p=part, i=i: fn(p, i), reps)
    for i, part in parts.items():
        runs[f"library {i}"] = graphed_reps(lambda p=part: p.sum(0), reps)
    times = {k: v / reps for k, v in time_turns(runs, iters).items()}
    out = {}
    for name in list(fns) + ["library"]:
        out[name] = {i: times[f"{name} {i}"] for i in parts}
        out[name]["sum"] = sum(out[name][i] for i in parts)
    shapes = ", ".join(f"conv{i} {list(p.shape)}" for i, p in parts.items())
    print(f"[wav-reduce] B={b} ({shapes}), ms a launch by conv 3 / 2 / 1 / 0 and their sum: "
          + "; ".join(f"{n} " + " / ".join(f"{v[i]:.4f}" for i in parts) + f" = {v['sum']:.4f}"
                      for n, v in out.items())
          + f" (rel {rel:.1e} against f64; the kernel's bits as the CPU's); CUDA graphs of "
          f"{reps} launches, in turns ({card})")
    return out


SMS, FP32_LANES = 132, 128  # H100 SXM: SMs, and FP32 lanes an SM


def max_sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi clocks.max.sm failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def conv0_floor_ms(b, length, clock_hz, kernel, need_wav_grad=False):
    """The instruction floor of K3's conv0 kernels under the rounding rule
    (every tap of conv0 a rounded product and a rounded sum, no FMA: two
    FP32 instructions), ms: conv0 over the times whose window reaches a
    sample, and for wgrad0 one FMA for each product of dW0 (and of d_wav),
    at one instruction a lane a clock on 132 SMs of 128 FP32 lanes."""
    taps = conv0_taps(b, length)
    instr = 2 * taps
    if kernel == "wgrad0":
        instr += taps * (2 if need_wav_grad else 1)
    return instr / (SMS * FP32_LANES * clock_hz) * 1e3


def wav_conv0_turns(card, b, others=None, unchecked=(), iters=10, reps=5):
    """K3's two conv0 kernels alone, at TED's waveform length: the
    statistics kernel (``conv0_stats``: IN0's mean and 1/std, conv0
    recomputed from the waveform) and the conv0 backward kernel
    (``conv0_partials``: g_m0 through IN0, the dW0 and db0 partials, and
    d_wav or not) on the gy1 and sums that a backward's conv1 data
    gradient produced. Each result is held first against the plain version
    in f64 and a second call against the first's bits; then each call is
    replayed from a CUDA graph of ``reps`` calls and all are timed in
    turns. ``others``: more {name: (stats0, partials)} with those two
    functions' signatures (another build's), checked (unless in
    ``unchecked``) and timed in the same turns. Printed for information
    only, cuDNN doing the same work on materialised tensors: F.conv1d for
    conv0 then torch.var_mean; and, on g_m0, conv0's weight and bias
    gradient (aten.convolution_backward), with the data gradient for d_wav.
    Returns {name: {"stats0", "wgrad0", "wgrad0+d_wav": ms a call}}."""
    import torch.nn.functional as F

    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    g = torch.Generator().manual_seed(110 + b)
    enc = random_normal_(WavEncoder(), g).cuda()
    packed = k3.pack_wav_params(enc, differentiable=False)
    length = audio_samples_for_frames(34)
    d = k3.WavDims(length)
    wav = (0.1 * torch.randn(b, length, generator=g)).cuda()
    _, res = k3.fused_wav_forward(wav, packed)
    cot = torch.randn(b, d.T4, 256, generator=g).cuda()
    _, gy1, sums = k3._stack_backward(res, cot, packed, 0.3, d)
    # the plain versions in f64, on the kernels' st0, gy1 and sums
    p64 = {k: v.double() for k, v in packed.items()}
    st64 = res.st0.double()
    ref_st = k3._norm_stats(k3._conv0(wav.double(), p64))
    xh = k3._xhat(k3._conv0(wav.double(), p64), st64)
    tot = sums.double().sum(1) / d.T1
    g_m0 = k3._in_backward(gy1.double().transpose(1, 2), xh, st64, tot[:, 0], tot[:, 1])
    del xh
    ref_dwav, ref_dw, ref_db = k3._conv0_grads(wav.double(), g_m0, p64, True)
    top = ref_dw.abs().max().item()

    fns = {"kernel": (k3.conv0_stats, k3.conv0_partials), **(others or {})}
    notes, runs = [], {}
    for name, (stats0, partials) in fns.items():
        st = stats0(wav, packed)
        same = torch.equal(st, stats0(wav, packed))
        mean_err = ((st[:, 0].double() - ref_st[:, 0]) * ref_st[:, 1]).abs().max().item()
        inv_err = _rel(st[:, 1].double(), ref_st[:, 1])
        errs = {"stats0 mean (of the std)": mean_err, "stats0 1/std": inv_err}
        for need in (False, True):
            dw_, part = partials(res, gy1, sums, packed, need)
            dw2, part2 = partials(res, gy1, sums, packed, need)
            same = same and torch.equal(part, part2) and (not need or torch.equal(dw_, dw2))
            dw0, db0 = k3.reduce_partials(part, 0)
            errs[f"dW0{' (d_wav)' if need else ''}"] = _rel(dw0.double(), ref_dw)
            errs[f"db0{' (d_wav)' if need else ''} / max|dW0|"] = (
                (db0.double() - ref_db).abs().max().item() / top)
            if need:
                errs["d_wav"] = _rel(dw_.double(), ref_dwav)
        notes.append(f"{name}: " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                     + ("" if same else ", OTHER BITS TWICE"))
        if name not in unchecked:
            tol = {k: KERNEL_TOL if k.startswith("stats0") else GRAD_TOL for k in errs}
            bad = {k: v for k, v in errs.items() if not v <= tol[k]}
            check(same and not bad, f"K3 conv0 kernels {name} B={b}: {bad} over tolerance, "
                  f"same bits on a second call: {same}")
        runs[f"{name} stats0"] = graphed_reps(lambda f=stats0: f(wav, packed), reps)
        for need, key in ((False, "wgrad0"), (True, "wgrad0+d_wav")):
            runs[f"{name} {key}"] = graphed_reps(
                lambda f=partials, n=need: f(res, gy1, sums, packed, n), reps)
    del ref_st, ref_dwav, ref_dw, ref_db
    # cuDNN on materialised tensors, for information
    w0, b0 = packed["w0"], packed["b0"]
    x = wav[:, None]
    g32 = g_m0.float().contiguous()
    del g_m0
    runs["cuDNN stats0"] = graphed_reps(lambda: torch.var_mean(
        F.conv1d(x, w0, b0, stride=5, padding=1600), dim=2, correction=0), reps)
    for mask, key in (([False, True, True], "wgrad0"), ([True, True, True], "wgrad0+d_wav")):
        runs[f"cuDNN {key}"] = graphed_reps(lambda m=mask: torch.ops.aten.convolution_backward(
            g32, x, w0, [32], [5], [1600], [1], False, [0], 1, m), reps)
    times = {k: v / reps for k, v in time_turns(runs, iters).items()}
    keys = ("stats0", "wgrad0", "wgrad0+d_wav")
    out = {n: {k: times[f"{n} {k}"] for k in keys} for n in list(fns) + ["cuDNN"]}
    clock = max_sm_clock_hz()
    cost = k3_cost(b, length)
    bounds = {"stats0": bound(*cost["stats0"])[0], "wgrad0": bound(*cost["wgrad0"])[0]}
    floors = {"stats0": conv0_floor_ms(b, length, clock, "stats0"),
              "wgrad0": conv0_floor_ms(b, length, clock, "wgrad0"),
              "wgrad0+d_wav": conv0_floor_ms(b, length, clock, "wgrad0", True)}
    print(f"[wav-conv0] B={b} L={length}, ms a call: " + "; ".join(
        f"{n} " + ", ".join(f"{k} {v[k]:.4f}" for k in keys) for n, v in out.items())
        + f"; table bound stats0 {bounds['stats0']:.4f}, wgrad0 {bounds['wgrad0']:.4f}; "
        f"rounding-rule floor at {clock / 1e9:.3f} GHz: " + ", ".join(
            f"{k} {v:.4f}" for k, v in floors.items())
        + f" (cuDNN on materialised conv0 / g_m0, for information; {'; '.join(notes)}); CUDA "
        f"graphs of {reps} calls, in turns ({card})")
    return out


def wav_wgrad_turns(card, b, iters=10):
    """K3's weight-gradient kernel alone, conv by conv, at TED's waveform
    length: one launch over conv i's B*T_i rows (``wgrad_partials``),
    against cuDNN's weight gradient of the same conv on the materialised
    activation a = lrelu(IN(pre)) laid out [B, C, T]
    (aten.convolution_backward, f32, TF32 off), which does no InstanceNorm,
    LeakyReLU or conv0 recompute. Each is replayed from a CUDA graph, timed
    in turns (kernel, cuDNN, cuDNN, kernel). The kernel's partials, summed,
    are held first against the plain weight gradient in f64 and a second
    launch against the first's bits. Returns {i: (kernel ms, cuDNN ms)}."""
    import torch.nn.functional as F

    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    g = torch.Generator().manual_seed(50 + b)
    enc = random_normal_(WavEncoder(), g).cuda()
    packed = k3.pack_wav_params(enc, differentiable=False)
    length = audio_samples_for_frames(34)
    wav = (0.1 * torch.randn(b, length, generator=g)).cuda()
    _, res = k3.fused_wav_forward(wav, packed)
    xh = k3.lrelu_inputs(res, packed)
    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    out = {}
    for i in (1, 2, 3):
        cout = k3.CHANNELS[i + 1]
        cot = torch.randn(b, t[i], cout, generator=g).cuda()
        a = F.leaky_relu(xh[i - 1], 0.3).contiguous()  # [B, C_in, T_in]
        gt = cot.transpose(1, 2).contiguous()  # [B, C_out, T_out]
        w = packed[f"w{i}"]
        part = k3.wgrad_partials(i, res, cot, packed)
        dw, db = k3.reduce_partials(part, i)
        same = torch.equal(part, k3.wgrad_partials(i, res, cot, packed))
        rw, rb = k3._conv_weight_grad(a.double(), gt.double(), 6)
        rel = max(_rel(dw.double(), rw), _rel(db.double(), rb))
        cudnn = lambda: torch.ops.aten.convolution_backward(
            gt, a, w, [cout], [6], [0], [1], False, [0], 1, [False, True, True])
        crel = _rel(cudnn()[1].double(), rw)
        del rw, rb
        check(same and rel <= GRAD_TOL, f"K3 wgrad conv{i} B={b}: rel {rel:.3e} against f64, "
              f"same bits on a second launch: {same}")
        times = time_turns({"kernel": graphed(lambda: k3.wgrad_partials(i, res, cot, packed)),
                            "cudnn": graphed(cudnn)}, iters)
        flop, nbytes, peak = k3_wgrad_cost(b, length, i)
        bound_ms = bound(flop, nbytes, peak)[0]
        out[i] = (times["kernel"], times["cudnn"])
        print(f"[wav-wgrad] conv{i} B={b} rows {b * t[i]}, {part.shape[0]} splits: kernel "
              f"{times['kernel']:.4f} ms (rel {rel:.1e} against f64), bound {bound_ms:.4f} ms "
              f"(share {bound_ms / times['kernel']:.1%}); cuDNN weight gradient "
              f"{times['cudnn']:.4f} ms (rel {crel:.1e}); CUDA graphs, in turns ({card})")
    print(f"[wav-wgrad] B={b}: the three convs {sum(v[0] for v in out.values()):.4f} ms, cuDNN "
          f"{sum(v[1] for v in out.values()):.4f} ms ({card})")
    return out


def wav_bwd_data_turns(card, b, iters=10):
    """K3's data-gradient kernel alone, conv by conv, at TED's waveform
    length: conv i's launches of ``data_grad`` (gy = lrelu'(xhat) conv_i^T g
    and the tiles' InstanceNorm sums), against cuDNN's data gradient of the
    same conv on the same cotangent (aten.convolution_backward, f32, TF32
    off), which does no LeakyReLU derivative, no InstanceNorm sums and no
    conv0 recompute. Each is replayed from a CUDA graph, timed in turns
    (kernel, cuDNN, cuDNN, kernel). The kernel's gy and its sums (over the
    tiles) are held first against the plain data gradient in f64 and a
    second launch against the first's bits. Returns {i: (kernel ms, cuDNN
    ms)}."""
    import torch.nn.functional as F

    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    g = torch.Generator().manual_seed(80 + b)
    enc = random_normal_(WavEncoder(), g).cuda()
    packed = k3.pack_wav_params(enc, differentiable=False)
    length = audio_samples_for_frames(34)
    wav = (0.1 * torch.randn(b, length, generator=g)).cuda()
    _, res = k3.fused_wav_forward(wav, packed)
    xh = k3.lrelu_inputs(res, packed)
    dims = k3.WavDims(length)
    t = (dims.T1, dims.T2, dims.T3, dims.T4)
    out = {}
    for i in (1, 2, 3):
        cout = k3.CHANNELS[i + 1]
        cot = torch.randn(b, t[i], cout, generator=g).cuda()
        a = F.leaky_relu(xh[i - 1], 0.3).contiguous()  # [B, C_in, T_in]
        gt = cot.transpose(1, 2).contiguous()  # [B, C_out, T_out]
        w = packed[f"w{i}"]
        gy, sums = k3.data_grad(i, res, cot, packed)
        gy2, sums2 = k3.data_grad(i, res, cot, packed)
        same = torch.equal(gy, gy2) and torch.equal(sums, sums2)
        rgy, rsums = k3._plain_data_grad(cot.double(), w.double(), xh[i - 1].double(), t[i - 1],
                                         0.3)
        rel = max(_rel(gy.double(), rgy), _rel(sums.double().sum(1), rsums[:, 0]))
        cudnn = lambda: torch.ops.aten.convolution_backward(
            gt, a, w, [cout], [6], [0], [1], False, [0], 1, [True, False, False])
        slope = torch.where(xh[i - 1] > 0, 1.0, 0.3).double()
        crel = _rel((cudnn()[0].double() * slope).transpose(1, 2), rgy)
        del rgy, rsums, gy2, sums2, slope
        check(same and rel <= GRAD_TOL, f"K3 bwd_data conv{i} B={b}: rel {rel:.3e} against "
              f"f64, same bits on a second launch: {same}")
        times = time_turns({"kernel": graphed(lambda: k3.data_grad(i, res, cot, packed)),
                            "cudnn": graphed(cudnn)}, iters)
        flop, nbytes, peak = k3_bwd_data_cost(b, length, i)
        bound_ms = bound(flop, nbytes, peak)[0]
        out[i] = (times["kernel"], times["cudnn"])
        print(f"[wav-bwd-data] conv{i} B={b} T_in {t[i - 1]}, {sums.shape[1]} tiles a sequence: "
              f"kernel {times['kernel']:.4f} ms (rel {rel:.1e} against f64), bound "
              f"{bound_ms:.4f} ms (share {bound_ms / times['kernel']:.1%}); cuDNN data gradient "
              f"{times['cudnn']:.4f} ms (rel {crel:.1e}, without lrelu', IN sums or conv0); "
              f"CUDA graphs, in turns ({card})")
    print(f"[wav-bwd-data] B={b}: the three convs {sum(v[0] for v in out.values()):.4f} ms, "
          f"cuDNN {sum(v[1] for v in out.values()):.4f} ms ({card})")
    return out


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
                print("[train-kernel] " + tag + ": bound by kernel, ms per fwd+bwd call (fwd and "
                      "wgrad: their 3xTF32 products as three TF32 passes at 495 TFLOP/s): " + ", ".join(
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
        wav_conv_fwd_turns(card, b)
        wav_wgrad_turns(card, b)
        wav_bwd_data_turns(card, b)
        stats_ms = wav_stats_turns(card, b)
        reduce_ms = wav_reduce_turns(card, b)
        conv0_ms = wav_conv0_turns(card, b)
        if b == TRAIN_BATCH:
            # stats, reduce, stats0 and wgrad0 (without d_wav, as a training
            # step runs it): device time of their launches alone, from graph
            # replays in turns with the calls they are held to
            report = {"ms": {**per_kernel, "stats": stats_ms["kernel"],
                             "reduce": reduce_ms["kernel"]["sum"],
                             "stats0": conv0_ms["kernel"]["stats0"],
                             "wgrad0": conv0_ms["kernel"]["wgrad0"]},
                      "plain_fwd": plain["fwd"], "plain_bwd": plain["bwd"],
                      "library": {"stats": stats_ms["library"],
                                  "reduce": reduce_ms["library"]["sum"]},
                      "bound": {k: bound(*c) for k, c in k3_cost(b, length).items()}}
            print(f"[wav-kernel] {tag}: bound by kernel, ms per call (conv_fwd, wgrad, bwd_data: "
                  "their three TF32 products at 495 TFLOP/s and conv0's recompute at 67): "
                  + ", ".join(
                f"{k} {v[0]:.3f} ({v[1]}, share {v[0] / report['ms'][k]:.1%})"
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
    fused_mlp.fused_transmlp.bf16_launches = 0


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


RECORD_CLIPS, RECORD_SECONDS = 40, 20  # 26 windows a clip: 1,040 TED windows
BEAT_CLIPS, BEAT_SECONDS, BEAT_BATCH = 13, 16, 128  # 21 windows a clip: 273 BEAT windows
RECORD_EPOCHS, BEAT_EPOCHS, SAG_EPOCHS = 10, 3, 3


def _dir_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root) for f in files)


def _progress_rows(save_dir, key):
    with open(os.path.join(save_dir, "progress.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if key in r]


class _Tee:
    """Writes to stdout and keeps a copy."""

    def __init__(self):
        self.out, self.parts = sys.stdout, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _records_rag_run(tag, argv, save_dir, card, want_decrease, shards=1):
    """train_rag.main(argv) with every step logged: checks K2's launches
    (forward 1 a step, each backward kernel LAYERS a step, times
    ``shards`` on a data-parallel mesh), no plain version and no K1, finite
    losses (falling with ``want_decrease``); returns the loop and its
    numbers."""
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2
    from livelyspeaker_tpu_torch.scripts import train_rag

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    fused_mlp.fused_transmlp_reference.calls = 0
    t0 = time.perf_counter()
    loop = train_rag.main(argv + ["--save_dir", save_dir, "--log_interval", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k2.LAUNCHES)
    plain = (k2.fused_transmlp_train_forward_reference.calls,
             k2.fused_transmlp_train_backward_reference.calls)
    k1 = (fused_mlp.fused_transmlp.launches, fused_mlp.fused_transmlp_reference.calls)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = _progress_rows(save_dir, "loss")
    losses = [r["loss"] for r in rows]
    steps, per_epoch = loop.step, len(loop.data)
    check(len(losses) == steps > 0, f"{tag}: {len(losses)} losses logged for {steps} steps")
    check(all(np.isfinite(losses)), f"{tag}: a loss is not finite: {losses}")
    # step ms from the log's clock (each line follows the step's host sync),
    # after two warm-up steps; the first step of each epoch waits for its
    # loader's first batch, and epoch 1's also for epoch 0's checkpoint
    ms = np.diff([0.0] + [r["elapsed_s"] for r in rows]) * 1e3
    step_no = np.arange(steps)
    first_of_epoch = step_no % per_epoch == 0
    kept = (step_no >= 2) & (step_no != per_epoch)
    steady = ms[kept & ~first_of_epoch]
    firsts = ms[kept & first_of_epoch]
    stats = {"step_ms": float(np.median(steady)), "mean_ms": float(steady.mean()),
             "epoch_first_ms": float(np.median(firsts)) if firsts.size else float("nan"),
             "peak_gib": peak_gib, "wall_s": wall, "steps": steps, "losses": losses}
    stats["clips_s"] = loop.data.batch_size / stats["step_ms"] * 1e3
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"[{tag}] {steps} steps ({per_epoch} a epoch) at B={loop.data.batch_size}: loss first-5 "
          f"mean {first:.5f} last-5 mean {last:.5f}; losses " + " ".join(f"{v:.4f}" for v in losses))
    print(f"[{tag}] step {stats['step_ms']:.2f} ms median ({stats['mean_ms']:.2f} mean) over the "
          f"steps after the second that start no epoch, {stats['epoch_first_ms']:.2f} ms median "
          f"for an epoch's first step (not epoch 1's, which follows epoch 0's checkpoint); "
          f"{stats['clips_s']:.1f} clips/s; {wall:.2f} s for the whole "
          f"run; peak memory {peak_gib:.2f} GiB ({card})")
    print(f"[{tag}] K2 launches {launches} (per step: fwd {shards}, each backward kernel "
          f"{shards * LAYERS}); plain versions {plain}; K1 launches and plain calls {k1}")
    check(launches["fwd"] == shards * steps,
          f"{tag}: forward kernel launched {launches['fwd']} times")
    for k in ("bwd_block", "wgrad", "reduce"):
        check(launches[k] == shards * LAYERS * steps, f"{tag}: {k} launched {launches[k]} times")
    check(plain == (0, 0) and k1 == (0, 0), f"{tag}: a plain version or K1 ran on the training path")
    stats["launches"] = launches
    if want_decrease:
        check(last < first, f"{tag}: loss did not decrease ({first:.5f} -> {last:.5f})")
    return loop, stats


def native_gather_check(ds, card, turns=5):
    """The native record gather (``data/native.py``) on the streaming loader's
    first TED batch of 512 (epoch 0 of the records runs' seed): the library
    must be loaded (no numpy fallback on the card); the motion
    (transpose-crop 42 -> 34 frames, [T, 27] -> [27, T]), the audio (prefix,
    as f32 records hold it and as int16 PCM made from it) and vec_seq
    (prefix) gathered natively give numpy indexing's bytes; both timed in
    turns over the same indices (host ms a batch, medians). Returns the
    native and numpy ms a batch of each field."""
    from livelyspeaker_tpu_torch.data import native
    from livelyspeaker_tpu_torch.data.loader import epoch_indices

    check(native.available(), "native gather: the library is not loaded (g++ output: "
          f"{native.build_log()[-2000:]!r})")
    t_phase = time.perf_counter()
    rec = ds.records
    whole = lambda f: np.concatenate([rec._shard(i)[f] for i in range(len(rec.shard_names))])
    vec, audio = whole("vec_seq"), whole("audio")
    vec = vec.reshape(len(vec), vec.shape[1], -1)  # [N, 42, 27]: gather_field's view
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int16)
    idx = epoch_indices(len(ds), 10, 0)[:TRAIN_BATCH]
    n, t_audio = ds.cfg.n_poses, ds.cfg.audio_length
    cases = {
        "motion": (lambda: native.gather_rows_transpose_crop(vec, idx, n),
                   lambda: np.ascontiguousarray(vec[idx, :n].transpose(0, 2, 1))),
        "audio_f32": (lambda: native.gather_rows_prefix(audio, idx, t_audio),
                      lambda: np.ascontiguousarray(audio[idx, :t_audio])),
        "audio_int16": (lambda: native.gather_rows_prefix(pcm, idx, t_audio),
                        lambda: np.ascontiguousarray(pcm[idx, :t_audio])),
        "vec_seq": (lambda: native.gather_rows_prefix(vec, idx, n),
                    lambda: np.ascontiguousarray(vec[idx, :n])),
    }
    ms = {}
    for name, (nat, ref) in cases.items():
        a, b = nat(), ref()
        check(a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b),
              f"native gather: {name} differs from numpy indexing")
        times = {"native": [], "numpy": []}
        for _ in range(turns):
            for which, fn in (("native", nat), ("numpy", ref)):
                t0 = time.perf_counter()
                fn()
                times[which].append((time.perf_counter() - t0) * 1e3)
        ms[name] = {k: float(np.median(v)) for k, v in times.items()}
        print(f"[native-gather] {name} {tuple(a.shape)} {a.dtype} ({a.nbytes / 1e6:.1f} MB): "
              f"same bytes as numpy indexing; {ms[name]['native']:.3f} ms native, "
              f"{ms[name]['numpy']:.3f} ms numpy (host ms a batch of {TRAIN_BATCH}, median of "
              f"{turns} turns; {card})")
    print(f"[native-gather] library {native._paths()[0].name}, check wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ms


def records_train_phase(card, beside):
    """Training from records through the port's entry points at full width:
    synthetic TED and BEAT records built here; train_rag --fused_train on
    TED at batch 512 with the streaming loader and with --device_resident 1
    (K2's launches counted, losses finite and falling, the two loaders'
    first batches identical); train_rag on BEAT at batch 128; train_sag at
    latent 512 with the 12-layer CLIP text tower and the FGD hook each
    epoch; then one composed batch of 8 from the trained RAG and
    sag_best.npz through K1, fused against eager; then :func:`eval_phase`
    on those records and checkpoints, before they are removed. ``beside``:
    train_phase's fixed-batch numbers, printed alongside."""
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from livelyspeaker_tpu_torch.data import (DataLoader, DeviceDataLoader, HashTokenizer,
                                              TedWindowDataset)
    from livelyspeaker_tpu_torch.data.loader import _PinnedSlots
    from livelyspeaker_tpu_torch.data.synthetic import (build_synthetic_beat_records,
                                                        build_synthetic_ted_records)
    from livelyspeaker_tpu_torch.models import SAG, CLIPTextConfig, CLIPTextEncoder, RAG, RAGConfig
    from livelyspeaker_tpu_torch.ops import fused_mlp
    from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline
    from livelyspeaker_tpu_torch.scripts import train_rag, train_sag
    from livelyspeaker_tpu_torch.scripts.eval_common import final_npz
    from livelyspeaker_tpu_torch.training.checkpoints import load_args
    from livelyspeaker_tpu_torch.utils.checkpoints import load_params_npz
    from livelyspeaker_tpu_torch.utils import convert

    work = tempfile.mkdtemp(prefix="chip_smoke_records.")
    try:
        ted_dir, beat_dir = os.path.join(work, "ted"), os.path.join(work, "beat")
        t0 = time.perf_counter()
        n_ted, _ = build_synthetic_ted_records(ted_dir, n_clips=RECORD_CLIPS,
                                               clip_seconds=RECORD_SECONDS, seed=41)
        t1 = time.perf_counter()
        n_beat = build_synthetic_beat_records(beat_dir, n_clips=BEAT_CLIPS,
                                              clip_seconds=BEAT_SECONDS, seed=42)
        t2 = time.perf_counter()
        print(f"[records] TED: {n_ted} windows from {RECORD_CLIPS} clips of {RECORD_SECONDS} s, "
              f"{_dir_bytes(ted_dir) / 2 ** 20:.1f} MiB, built in {t1 - t0:.2f} s; BEAT: {n_beat} "
              f"windows from {BEAT_CLIPS} clips of {BEAT_SECONDS} s, "
              f"{_dir_bytes(beat_dir) / 2 ** 20:.1f} MiB, built in {t2 - t1:.2f} s (host)")
        check(n_ted >= 2 * TRAIN_BATCH and n_beat >= 2 * BEAT_BATCH,
              f"records: {n_ted} TED and {n_beat} BEAT windows, too few for two batches")

        # the host side of the streaming loader at B=512, through the native gather
        ds = TedWindowDataset(ted_dir)
        gather = native_gather_check(ds, card)
        fields = train_rag.TRAIN_FIELDS["ted"]
        chunk = np.random.default_rng(0).permutation(len(ds))[:TRAIN_BATCH]
        gather_ms = wall_ms(lambda: ds.batch(chunk, fields=fields), reps=5)
        host = ds.batch(chunk, fields=fields)
        slots = _PinnedSlots(1, [torch.device("cuda", 0)])
        send_ms = wall_ms(lambda: slots.send(host)[1][0][1].synchronize(), reps=5)  # pinned copy + H2D
        stream = DataLoader(ds, TRAIN_BATCH, seed=10, fields=fields, device="cuda")
        for b in stream:  # a warm-up epoch: the host allocator's pinned blocks
            pass
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for _ in range(3):
            for b in stream:
                torch.cuda.current_stream().synchronize()
                n += 1
        loader_ms = (time.perf_counter() - t0) * 1e3 / n
        batch_mb = sum(v.numel() * v.element_size() for v in b.values()) / 1e6
        resident = DeviceDataLoader(ds, TRAIN_BATCH, seed=10, fields=fields, device="cuda")
        for loader in (stream, resident):
            loader.set_epoch(0)
        a, r = next(iter(stream)), next(iter(resident))
        same = all(a[k].dtype == r[k].dtype and torch.equal(a[k], r[k]) for k in fields)
        print(f"[records] streaming loader: host gather {gather_ms:.2f} ms a batch of "
              f"{TRAIN_BATCH} ({batch_mb:.1f} MB), into the pinned slot and to the card "
              f"{send_ms:.2f} ms, {loader_ms:.2f} ms a batch delivered to the card (alone, {n} "
              f"batches after a warm-up epoch, each epoch's first without overlap); host ms "
              f"medians of 5; device-resident copy {resident.nbytes / 1e6:.1f} MB; first "
              f"batches identical: {same}")
        check(same, "records: the two loaders' first batches differ")
        del stream, resident, a, r, b, slots, host

        common = ["--dataset", "ted", "--data_dir", ted_dir, "--fused_train", "--batch_size",
                  str(TRAIN_BATCH), "--epochs", str(RECORD_EPOCHS), "--lr", str(TRAIN_LR),
                  "--latent_dim", "512", "--layers", str(LAYERS), "--n_speakers", "1400",
                  "--seed", "10"]
        runs = {}
        for resident_flag in ("0", "1"):
            tag = "records-ted-resident" if resident_flag == "1" else "records-ted-stream"
            _, runs[tag] = _records_rag_run(tag, common + ["--device_resident", resident_flag],
                                            os.path.join(work, tag), card, want_decrease=True)
        s, r = runs["records-ted-stream"], runs["records-ted-resident"]
        # the same seed, init and batch stream: the losses differ only by the
        # run-to-run rounding of cuDNN's convs
        loss_diff = float(np.max(np.abs(np.subtract(s["losses"], r["losses"]))))
        print(f"[records-ted] step ms median: streaming {s['step_ms']:.2f} (epoch-first "
              f"{s['epoch_first_ms']:.2f}), device-resident {r['step_ms']:.2f} (epoch-first "
              f"{r['epoch_first_ms']:.2f}), train_phase's fixed batch {beside['step_ms']:.2f} mean; "
              f"clips/s {s['clips_s']:.1f} / {r['clips_s']:.1f} / {beside['clips_s']:.1f}; peak "
              f"{s['peak_gib']:.2f} / {r['peak_gib']:.2f} / {beside['peak_gib']:.2f} GiB; the two "
              f"loaders' losses differ by at most {loss_diff:.3e} ({card})")

        _, beat = _records_rag_run(
            "records-beat", ["--dataset", "beat", "--data_dir", beat_dir, "--fused_train",
                             "--batch_size", str(BEAT_BATCH), "--epochs", str(BEAT_EPOCHS),
                             "--lr", str(TRAIN_LR), "--seed", "11"],
            os.path.join(work, "beat_run"), card, want_decrease=False)

        sag_dir = os.path.join(work, "sag")
        tee = _Tee()
        torch.cuda.reset_peak_memory_stats()
        with redirect_stdout(tee):
            out = train_sag.main(["--dataset", "ted", "--data_dir", ted_dir, "--latent_dim", "512",
                                  "--clip_layers", "12", "--batch_size", str(TRAIN_BATCH),
                                  "--epochs", str(SAG_EPOCHS), "--eval_interval", "1",
                                  "--log_interval", "1", "--save_dir", sag_dir, "--seed", "12"])
        torch.cuda.synchronize()
        rows = _progress_rows(sag_dir, "sum")
        sums = [row["sum"] for row in rows]
        fgds = [row["eval_fgd"] for row in _progress_rows(sag_dir, "eval_fgd")]
        sag_ms = np.diff([row["elapsed_s"] for row in rows]) * 1e3
        check(len(sums) == out["step"] > 0 and all(np.isfinite(sums)),
              f"records-sag: losses {sums} for {out['step']} steps")
        check("new best FGD" in "".join(tee.parts), "records-sag: no new best FGD printed")
        check(os.path.exists(os.path.join(sag_dir, "sag_best.npz")), "records-sag: no sag_best.npz")
        print(f"[records-sag] {out['step']} steps at B={TRAIN_BATCH}, latent 512, CLIP 12 layers: "
              f"losses " + " ".join(f"{v:.4f}" for v in sums) + f"; FGD each epoch "
              + " ".join(f"{v:.6g}" for v in fgds) + f", best {out['best_fgd']:.6g}")
        print(f"[records-sag] step {np.median(sag_ms):.2f} ms median (tokenize, CLIP encode and "
              f"the Adam step; the gaps between logged steps within an epoch), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
        del out

        # compose from what was trained
        rag_dir = os.path.join(work, "records-ted-stream")
        saved = load_args(rag_dir)
        cfg = RAGConfig(njoints=saved["njoints"], nfeats=saved["nfeats"], nframes=saved["n_poses"],
                        latent_dim=saved["latent_dim"], num_layers=saved["layers"],
                        n_speakers=saved["n_speakers"], num_emotions=saved["num_emotions"])
        step = s["steps"]
        rag = RAG(cfg)
        rag.load_state_dict(convert.jax_params_to_state_dict(
            load_params_npz(os.path.join(rag_dir, f"model{step:09d}.npz"))))
        sag = SAG(njoints=cfg.njoints, nfeats=cfg.nfeats, latent_dim=512)
        sag.load_state_dict(convert.jax_params_to_state_dict(
            load_params_npz(os.path.join(sag_dir, "sag_best.npz"))))
        clip = CLIPTextEncoder(CLIPTextConfig(layers=12, embed_dim=512),
                               generator=torch.Generator().manual_seed(0))  # train_sag's tower
        cond = _cond(cfg, np.random.default_rng(43), len(SENTENCES))
        gen = lambda: torch.Generator(device="cuda").manual_seed(7)
        with torch.no_grad():
            pipes = {f: LivelySpeakerPipeline(rag.cuda(), sag, clip, HashTokenizer(), use_fused=f)
                     for f in (True, False)}
            fused_mlp.fused_transmlp.launches = 0
            fused_mlp.fused_transmlp_reference.calls = 0
            fused = pipes[True](SENTENCES, cond, gen(), guidance=1.5)
            torch.cuda.synchronize()
            n, plain = fused_mlp.fused_transmlp.launches, fused_mlp.fused_transmlp_reference.calls
            eager = pipes[False](SENTENCES, cond, gen(), guidance=1.5)
        rel = _rel(fused, eager)
        shape = (len(SENTENCES), cfg.njoints, cfg.nfeats, cfg.nframes)
        print(f"[records-compose] trained RAG (step {step}) and sag_best.npz: {tuple(fused.shape)}, "
              f"K1 launches {n}, plain calls {plain}; fused vs eager rel {rel:.3e} (tol {SLICE_TOL})")
        check(tuple(fused.shape) == shape and bool(torch.isfinite(fused).all()),
              "records-compose: the composed batch is not finite of the expected shape")
        check(n == COMPOSED_STEPS and plain == 0,
              f"records-compose: K1 launched {n} times (want {COMPOSED_STEPS}), plain {plain}")
        check(rel <= SLICE_TOL, "records-compose: fused composition disagrees with the eager one")
        del pipes, rag, sag, clip
        evals = eval_phase(card, work, ted_dir, beat_dir,
                           os.path.join(rag_dir, f"model{step:09d}.npz"),
                           final_npz(os.path.join(work, "beat_run")),
                           os.path.join(sag_dir, "sag_best.npz"))
        return {"stream": s, "resident": r, "beat": beat, "gather_ms": gather_ms,
                "send_ms": send_ms, "loader_ms": loader_ms, "eval": evals, "native": gather}
    finally:
        shutil.rmtree(work, ignore_errors=True)


RAW_TED_CLIPS, RAW_TED_SECONDS = 40, 20  # 26 windows a clip: 1,040 TED windows
RAW_BEAT_NAMES = tuple(f"{speaker}_{r}" for speaker in ("2_scott", "4_lawrence")
                       for r in ("0_9_9", "0_10_10", "0_11_11"))  # all in BEAT's train split
RAW_BEAT_SECONDS = 40  # 57 windows a recording: 342 BEAT windows
RAW_RAG_EPOCHS, RAW_BEAT_EPOCHS, AE_EPOCHS = 5, 3, 10
AE_MANIFEST = os.path.join("tests", "manifests", "gesture_ae_ted.json")


def records_build_phase(card):
    """Records built from raw files through the port's scripts, then trained
    through K2 and the gesture autoencoder on the card: raw TED clips
    (npz, ``write_raw_ted_clips``) through ``build_ted_records.main`` in
    f32 and PCM16; a raw BEAT directory (two speakers, train recordings:
    BVH at 120 fps, WAV, TextGrid, csv, txt, json) through
    ``build_beat_records.main``; both read by the loaders onto the card;
    ``train_rag --fused_train`` from the TED records at B=512 and the BEAT
    records at B=128 (K2's launches counted, finite and falling losses);
    ``train_gesture_autoencoder`` on the TED records at batch 512,
    base 32 (finite, falling reconstruction MSE; the npz has the Flax
    module's keys and shapes, ``tests/manifests/gesture_ae_ted.json``, and
    loads into the port's model). Builds are host work: their seconds are
    printed, with each run's step ms."""
    import shutil
    import tempfile

    from livelyspeaker_tpu_torch.data import DataLoader, TedWindowDataset
    from livelyspeaker_tpu_torch.data.beat import BeatWindowDataset, beat_official_split
    from livelyspeaker_tpu_torch.data.synthetic import (write_raw_beat_recordings,
                                                        write_raw_ted_clips)
    from livelyspeaker_tpu_torch.data.ted import pcm16_decode
    from livelyspeaker_tpu_torch.models.embedding_net import GestureAutoencoder
    from livelyspeaker_tpu_torch.scripts import (build_beat_records, build_ted_records,
                                                 train_gesture_autoencoder)
    from livelyspeaker_tpu_torch.utils.checkpoints import load_params_npz
    from livelyspeaker_tpu_torch.utils.convert import flax_variables_to_state_dict

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_raw.")
    try:
        raw_ted, raw_beat = os.path.join(work, "raw_ted"), os.path.join(work, "raw_beat")
        ted = {k: os.path.join(work, f"ted_{k}") for k in ("float32", "int16")}
        beat_dir = os.path.join(work, "beat")
        t0 = time.perf_counter()
        write_raw_ted_clips(raw_ted, RAW_TED_CLIPS, RAW_TED_SECONDS, seed=51)
        secs = {"write_ted": time.perf_counter() - t0}
        n_ted = {}
        for dtype, out in ted.items():
            t0 = time.perf_counter()
            n_ted[dtype], vocab = build_ted_records.main(
                ["--clips_dir", raw_ted, "--out", out, "--audio_dtype", dtype])
            secs[f"build_ted_{dtype}"] = time.perf_counter() - t0
        for name in RAW_BEAT_NAMES:
            split = beat_official_split(name, RAW_BEAT_SECONDS)
            check(split == {"train": [(0.0, RAW_BEAT_SECONDS)], "val": [], "test": []},
                  f"raw BEAT: {name} is not a train recording")
        t0 = time.perf_counter()
        write_raw_beat_recordings(raw_beat, RAW_BEAT_NAMES, RAW_BEAT_SECONDS, seed=52)
        secs["write_beat"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_beat = build_beat_records.main(["--raw_dir", raw_beat, "--out", beat_dir,
                                          "--speakers", "2", "4"])
        secs["build_beat"] = time.perf_counter() - t0
        print(f"[raw-records] TED: {RAW_TED_CLIPS} raw clips of {RAW_TED_SECONDS} s written in "
              f"{secs['write_ted']:.2f} s, built into {n_ted['float32']} windows ("
              f"{vocab.n_words} speakers) in {secs['build_ted_float32']:.2f} s (f32, "
              f"{_dir_bytes(ted['float32']) / 2 ** 20:.1f} MiB) and {n_ted['int16']} in "
              f"{secs['build_ted_int16']:.2f} s (PCM16, {_dir_bytes(ted['int16']) / 2 ** 20:.1f} "
              f"MiB); BEAT: {len(RAW_BEAT_NAMES)} raw recordings of {RAW_BEAT_SECONDS} s "
              f"(BVH at 120 fps, WAV, TextGrid, csv, txt, json) written in "
              f"{secs['write_beat']:.2f} s, built into {n_beat} windows in "
              f"{secs['build_beat']:.2f} s (host)")
        check(n_ted["float32"] == n_ted["int16"] >= 2 * TRAIN_BATCH and n_beat >= 2 * BEAT_BATCH,
              f"raw records: {n_ted} TED and {n_beat} BEAT windows, too few for two batches")

        fields = ("motion", "audio", "vid")
        first = {}
        for dtype, root in ted.items():
            loader = DataLoader(TedWindowDataset(root), TRAIN_BATCH, shuffle=False,
                                fields=fields, device="cuda")
            first[dtype] = next(iter(loader))
        f32, pcm = first["float32"], first["int16"]
        audio_err = (torch.from_numpy(pcm16_decode(pcm["audio"].cpu().numpy())).cuda()
                     - f32["audio"]).abs().max().item()
        beat_batch = next(iter(DataLoader(BeatWindowDataset(beat_dir), BEAT_BATCH, shuffle=False,
                                          fields=("motion", "audio", "vid", "emo"),
                                          device="cuda")))
        torch.cuda.synchronize()
        print(f"[raw-records] loaders onto the card: TED f32 motion "
              f"{tuple(f32['motion'].shape)}, audio {f32['audio'].dtype}; PCM16 audio "
              f"{pcm['audio'].dtype}, decoded within {audio_err:.3e} of the f32 records; BEAT "
              f"motion {tuple(beat_batch['motion'].shape)}, emo {tuple(beat_batch['emo'].shape)}")
        check(torch.equal(f32["motion"], pcm["motion"]) and torch.equal(f32["vid"], pcm["vid"]),
              "raw records: the f32 and PCM16 TED records' motion or speakers differ")
        check(pcm["audio"].dtype == torch.int16 and audio_err <= 2.0 ** -15,
              "raw records: PCM16 audio off the f32 records by more than half a step")
        check(tuple(beat_batch["motion"].shape) == (BEAT_BATCH, 47, 6, 34)
              and bool(torch.isfinite(beat_batch["motion"]).all()),
              "raw records: BEAT batch not finite [B, 47, 6, 34]")
        del first, f32, pcm, beat_batch

        _, ted_run = _records_rag_run(
            "raw-ted", ["--dataset", "ted", "--data_dir", ted["float32"], "--fused_train",
                        "--batch_size", str(TRAIN_BATCH), "--epochs", str(RAW_RAG_EPOCHS),
                        "--lr", str(TRAIN_LR), "--latent_dim", "512", "--layers", str(LAYERS),
                        "--n_speakers", "1400", "--seed", "14"],
            os.path.join(work, "rag_ted"), card, want_decrease=True)
        _, beat_run = _records_rag_run(
            "raw-beat", ["--dataset", "beat", "--data_dir", beat_dir, "--fused_train",
                         "--batch_size", str(BEAT_BATCH), "--epochs", str(RAW_BEAT_EPOCHS),
                         "--lr", str(TRAIN_LR), "--seed", "15"],
            os.path.join(work, "rag_beat"), card, want_decrease=True)

        ae_dir = os.path.join(work, "ae")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_gesture_autoencoder.main(
            ["--dataset", "ted", "--data_dir", ted["float32"], "--batch_size", str(TRAIN_BATCH),
             "--base", "32", "--epochs", str(AE_EPOCHS), "--lr", "1e-3", "--log_interval", "1",
             "--save_dir", ae_dir, "--seed", "13"])
        torch.cuda.synchronize()
        ae_wall = time.perf_counter() - t0
        rows = _progress_rows(ae_dir, "recon_mse")
        losses = [r["recon_mse"] for r in rows]
        ae_ms = np.diff([0.0] + [r["elapsed_s"] for r in rows]) * 1e3
        check(len(losses) == out["step"] > 5 and all(np.isfinite(losses)),
              f"autoencoder: losses {losses} for {out['step']} steps")
        ae_first, ae_last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        with open(AE_MANIFEST) as f:
            manifest = {k: tuple(v) for k, v in json.load(f).items()}
        with np.load(out["path"]) as z:
            layout = {k: z[k].shape for k in z.files}
        model = GestureAutoencoder(base=32)
        model.load_state_dict(flax_variables_to_state_dict(load_params_npz(out["path"]), model))
        feat = model.cuda().embed(torch.zeros(4, 34, 27, device="cuda"))
        print(f"[raw-ae] {out['step']} steps at B={TRAIN_BATCH}, base 32: recon MSE first-5 mean "
              f"{ae_first:.5f} last-5 mean {ae_last:.5f}; losses "
              + " ".join(f"{v:.4f}" for v in losses)
              + f"; step {np.median(ae_ms[2:]):.2f} ms median after the second (host clock "
              f"between logged steps, each after its loss is read), {ae_wall:.2f} s for the run, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"{os.path.basename(out['path'])}: {len(layout)} arrays, the Flax module's "
              f"layout {layout == manifest}, loaded into the port ({card})")
        check(ae_last < ae_first, f"autoencoder: MSE did not fall ({ae_first} -> {ae_last})")
        check(layout == manifest, f"autoencoder npz is not the Flax layout of {AE_MANIFEST}")
        check(tuple(feat.shape) == (4, 32) and bool(torch.isfinite(feat).all()),
              "autoencoder: the loaded model's embedding is not finite [4, 32]")
        print(f"[raw-records] step ms median: train_rag TED {ted_run['step_ms']:.2f} "
              f"(B={TRAIN_BATCH}), BEAT {beat_run['step_ms']:.2f} (B={BEAT_BATCH}), autoencoder "
              f"{np.median(ae_ms[2:]):.2f} (B={TRAIN_BATCH}) ({card})")
        print(f"[raw-records] phase: {time.perf_counter() - t_phase:.1f} s")
        return {"secs": secs, "ted": ted_run, "beat": beat_run, "ae_ms": float(np.median(ae_ms[2:]))}
    finally:
        shutil.rmtree(work, ignore_errors=True)


EVAL_STEPS = 100  # the eval scripts' DDIM-100


def _reference_layout(manifest, seed):
    """A seeded state_dict with exactly the keys and shapes of a released
    checkpoint (``tests/manifests/<manifest>.json``), at unit-fan-in scale:
    std 1/sqrt(fan_in) for a weight of two or more axes, 1 for an embedding
    table, norm scales near 1, running variances above 0.5."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "manifests",
                           f"{manifest}.json")) as f:
        shapes = json.load(f)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7, dtype=torch.int64)
            continue
        a = rng.normal(size=shape)
        if k.endswith("running_var"):
            a = np.abs(a) + 0.5
        elif k.endswith("alpha") or (k.endswith("weight") and len(shape) == 1):
            a = 1.0 + 0.1 * a
        elif "embedding.weight" in k:
            pass
        elif len(shape) >= 2 and k.endswith("weight"):
            a = a / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * a
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def _openai_clip_layout(clip):
    """The state_dict of the port's CLIP text tower under OpenAI CLIP's key
    names (the inverse of ``utils.convert.clip_text_state_dict_from_openai``)."""
    import re

    out = {}
    for k, v in clip.state_dict().items():
        if k == "token_embedding":
            k = "token_embedding.weight"
        m = re.match(r"block_(\d+)\.(.*)", k)
        if m:
            rest = m.group(2)
            for ours, theirs in (("attn_in_proj_", "attn.in_proj_"), ("attn_out_proj.",
                                                                       "attn.out_proj."),
                                 ("mlp_c_fc.", "mlp.c_fc."), ("mlp_c_proj.", "mlp.c_proj.")):
                rest = rest.replace(ours, theirs)
            k = f"transformer.resblocks.{m.group(1)}.{rest}"
        out[k] = v.detach().cpu().clone()
    return out


def _eval_run(tag, module, argv, expect_launches):
    """``module.main(argv)`` with K1's counts set to 0 just before and read
    just after: every number of its results finite, K1 launched
    ``expect_launches(results)`` times, its plain version never. Returns
    (results, K1 launches, the script's time line as a dict, with the whole
    call's seconds as "call")."""
    from contextlib import redirect_stdout

    from livelyspeaker_tpu_torch.ops import fused_mlp

    tee = _Tee()
    torch.cuda.synchronize()
    fused_mlp.fused_transmlp.launches = 0
    fused_mlp.fused_transmlp_reference.calls = 0
    t0 = time.perf_counter()
    with redirect_stdout(tee):
        results = module.main(argv)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    n, plain = fused_mlp.fused_transmlp.launches, fused_mlp.fused_transmlp_reference.calls
    line = [x for x in "".join(tee.parts).splitlines() if x.startswith("seconds: ")][-1]
    seconds = {k: float(v) for k, v in (f.split("=") for f in line.split()[1:])}
    seconds["call"] = call_s  # main() whole, loading included
    want = expect_launches(results)
    print(f"[{tag}] K1 launches {n} (want {want}), plain version calls {plain}")
    check(bool(results) and all(np.isfinite(np.asarray(r, np.float64)).all() for r in results),
          f"{tag}: a number is not finite: {results}")
    check(n == want and plain == 0, f"{tag}: K1 launched {n} times (want {want}), plain {plain}")
    return results, n, seconds


def eval_phase(card, work, ted_dir, beat_dir, rag_npz, beat_npz, sag_npz):
    """The port's evaluation on what the records phase built and trained: a
    reference-layout RAG checkpoint through convert_checkpoint; the four
    eval scripts with --fused (TED at batch 512, BEAT at its records'
    273), seeded evaluator, BEAT SAG and CLIP checkpoints in the released
    layouts; K1's launches counted on each; the first TED batch fused
    against eager; where each script's time goes."""
    import random

    t_phase = time.perf_counter()
    from livelyspeaker_tpu_torch.data import DataLoader, TedWindowDataset
    from livelyspeaker_tpu_torch.models import SAG, CLIPTextConfig, CLIPTextEncoder, RAG, RAGConfig
    from livelyspeaker_tpu_torch.scripts import (convert_checkpoint, eval_livelyspeaker_beat,
                                                 eval_livelyspeaker_ted, eval_rag_beat,
                                                 eval_rag_ted)
    from livelyspeaker_tpu_torch.training.checkpoints import save_params_npz
    from livelyspeaker_tpu_torch.utils.config import generate_args
    from livelyspeaker_tpu_torch.utils.convert import rag_state_dict_from_reference

    # 1. a released-layout RAG checkpoint -> npz -> the port's RAG
    ref = _reference_layout("rag_ted", seed=51)
    src, dst = os.path.join(work, "RAG.pt"), os.path.join(work, "rag_converted.npz")
    torch.save(ref, src)
    t0 = time.perf_counter()
    convert_checkpoint.main(["rag", src, dst])
    convert_s = time.perf_counter() - t0
    converted = RAG(RAGConfig.ted())
    converted.load_state_dict(eval_rag_ted.load_rag_params(dst, generate_args(
        ["--model_path", dst])), strict=True)
    direct = rag_state_dict_from_reference(ref)
    same = all(torch.equal(v, direct[k]) for k, v in converted.state_dict().items())
    print(f"[eval-convert] {len(ref)} reference keys -> {len(direct)} tensors of RAG(RAGConfig"
          f".ted()) in {convert_s:.2f} s; loaded strict; npz round trip bit-exact: {same}")
    check(same, "eval-convert: the converted npz differs from rag_state_dict_from_reference")
    del converted, direct, ref

    ted_eval, beat_eval = os.path.join(work, "ted_evaluator.bin"), os.path.join(work, "best_rec.bin")
    torch.save({"gen_dict": _reference_layout("ted_evaluator", 52), "pose_dim": 27}, ted_eval)
    torch.save({"model_state": _reference_layout("beat_half_embedding", 53)}, beat_eval)
    clip_pt, beat_sag = os.path.join(work, "clip.pt"), os.path.join(work, "sag_beat.npz")
    # train_sag's text tower (seed 0), in OpenAI's layout
    torch.save(_openai_clip_layout(CLIPTextEncoder(CLIPTextConfig(layers=12, embed_dim=512),
                                                   generator=torch.Generator().manual_seed(0))),
               clip_pt)
    sag = SAG(njoints=47, nfeats=6, latent_dim=512, generator=torch.Generator().manual_seed(54))
    save_params_npz(beat_sag, sag.state_dict(), sag)
    del sag

    from livelyspeaker_tpu_torch.data.beat import BeatWindowDataset

    ted_batch = TRAIN_BATCH
    n_ted = len(TedWindowDataset(ted_dir)) // ted_batch
    n_beat = len(BeatWindowDataset(beat_dir))
    n_beat //= min(n_beat, 512)  # the scripts' batch: min(--batch_size 512, the records)
    runs = {}
    common = ["--data_dir", ted_dir, "--eval_model_path", ted_eval, "--fused"]
    runs["eval_rag_ted"] = _eval_run(
        "eval-rag-ted", eval_rag_ted,
        ["--model_path", rag_npz, "--batch_size", str(ted_batch)] + common,
        lambda r: len(r) * n_ted * EVAL_STEPS)
    runs["eval_rag_beat"] = _eval_run(
        "eval-rag-beat", eval_rag_beat,
        ["--model_path", beat_npz, "--data_dir", beat_dir, "--eval_model_path", beat_eval,
         "--fused"], lambda r: len(r) * n_beat * EVAL_STEPS)
    runs["eval_livelyspeaker_ted"] = _eval_run(
        "eval-ls-ted", eval_livelyspeaker_ted,
        ["--model_path", rag_npz, "--sag_path", sag_npz, "--clip_path", clip_pt,
         "--batch_size", str(ted_batch)] + common,
        lambda r: len(r) * n_ted * COMPOSED_STEPS)
    runs["eval_livelyspeaker_beat"] = _eval_run(
        "eval-ls-beat", eval_livelyspeaker_beat,
        ["--model_path", beat_npz, "--sag_path", beat_sag, "--clip_path", clip_pt,
         "--data_dir", beat_dir, "--eval_model_path", beat_eval, "--fused"],
        lambda r: len(r) * n_beat * COMPOSED_STEPS)

    # the TED RAG eval's first batch at its first guidance, fused and eager
    args = generate_args(["--model_path", rag_npz, "--data_dir", ted_dir])
    model = RAG(RAGConfig(njoints=args.njoints, nfeats=args.nfeats, nframes=args.n_poses,
                          latent_dim=args.latent_dim, num_layers=args.layers,
                          n_speakers=args.n_speakers))
    model.load_state_dict(eval_rag_ted.load_rag_params(rag_npz, args))
    dataset = TedWindowDataset(ted_dir)
    batch = next(iter(DataLoader(dataset, batch_size=ted_batch, shuffle=True, drop_last=True,
                                 seed=233)))
    random.seed(233)
    speakers = list(dataset.speaker_model.word2index.values())
    vid = np.array([random.choice(speakers) for _ in range(ted_batch)], np.int32)
    cond = {"audio": torch.from_numpy(batch["audio"]).cuda(), "vid": torch.from_numpy(vid).cuda(),
            "origin_x": torch.from_numpy(batch["motion"]).cuda()}
    outs = []
    for fused in (True, False):
        args.fused = fused
        sampler = eval_rag_ted.sampler_from_args(model, args)
        outs.append(sampler(cond, torch.Generator(device="cuda").manual_seed(233), guidance=1.0))
    rel = _rel(outs[0], outs[1])
    print(f"[eval-rag-ted] first batch, guidance 1.0, fused vs eager sampler, "
          f"{tuple(outs[0].shape)} (K1 at 2B={2 * ted_batch}): rel {rel:.3e} (tol {SLICE_TOL})")
    check(rel <= SLICE_TOL, "eval-rag-ted: fused sampling disagrees with the eager modules")
    del model, outs, cond

    for name, (results, n, sec) in runs.items():
        scoring = {k: v for k, v in sec.items() if k not in ("call", "wall", "sampling")}
        rest = sec["call"] - sec["sampling"] - sum(scoring.values())
        print(f"[eval-time] {name}: main() {sec['call']:.2f} s, sampling {sec['sampling']:.2f} s "
              f"({n} K1 launches), scoring {sum(scoring.values()):.2f} s ("
              + ", ".join(f"{k} {v:.2f}" for k, v in scoring.items())
              + f"), loading and the rest {rest:.2f} s; host clock, synchronised ({card})")
    print(f"[eval] the phase: {time.perf_counter() - t_phase:.2f} s, host clock ({card})")
    return {"launches": sum(n for _, n, _ in runs.values()), "seconds": {
        k: sec for k, (_, _, sec) in runs.items()}}


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


def _counted(fn):
    """``fn()`` with every kernel count set to 0 just before and read just
    after: (result, counts, seconds). ``counts``: K1's launches and its
    plain version's calls, K2's launches by kernel and its plain versions'
    calls."""
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2

    torch.cuda.synchronize()
    _reset_counts()
    fused_mlp.fused_transmlp_reference.calls = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, {
        "k1": fused_mlp.fused_transmlp.launches,
        "k1_plain": fused_mlp.fused_transmlp_reference.calls,
        "k2": dict(k2.LAUNCHES),
        "k2_plain": (k2.fused_transmlp_train_forward_reference.calls,
                     k2.fused_transmlp_train_backward_reference.calls),
    }, secs


def trace_summary(path, k1_name="fused_transmlp_cluster_kernel"):
    """What a torch.profiler Chrome trace shows: the span of its events, the
    card's busy time (the union of the kernels' intervals), K1's time and
    launches, the host's kernel-launch calls, and the five kernels that
    took the most time. Times in ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    check(kernels, f"{path}: the trace holds no kernel")
    busy, end = 0.0, -1.0
    for e in kernels:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    k1 = [e["dur"] for e in kernels if k1_name in e["name"]]
    launch_calls = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                       and "Launch" in e.get("name", ""))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / span,
            "k1_ms": sum(k1) / 1e3, "k1_kernels": len(k1), "kernels": len(kernels),
            "launch_calls": launch_calls, "top": [(n[:60], t / 1e3) for n, t in top]}


SERVE_RUNS = (  # (tag, bench_serve arguments)
    ("ted-depth0", ["--burst", "256", "--pipeline_depth", "0"]),
    ("ted-depth1", ["--burst", "256", "--pipeline_depth", "1"]),
    ("beat-single", ["--dataset", "beat", "--burst", "64", "--single", "8"]),
    ("beat-text", ["--dataset", "beat", "--burst", "64", "--text_frac", "0.25"]),
)
BENCH_TRAIN_STEPS = 10
SOAK_SECONDS, SOAK_RELOAD_EVERY = 20, 5


def measure_phase(card, profile_dir=None):
    """The measurement scripts of ``livelyspeaker_tpu_torch.scripts`` at full
    width, each called through its ``main(argv)`` with the kernel counts set
    to 0 just before and read just after: ``bench_serve`` (TED at
    max_batch 16, a burst of 256 at pipeline depth 0 and 1; BEAT, a burst
    of 64 with 8 single requests, and one with a quarter of the requests
    carrying text) with K1 20 times a served batch and its plain version
    never; ``bench_train --fused_train`` (K2 1 + 3 x 8 launches a step, its
    plain versions and K1 never) twice, in turns with ``--loaders`` (the
    eager step, then both loaders); ``bench_data``;
    ``profile`` of the sampler (batch 256, ddim100, K1's kernel in its
    trace) and of the train step (batch 512), with what each trace shows;
    and ``soak_serve`` against a server process with the composition.
    Returns (K1 launches, K2 launches by kernel)."""
    import tempfile

    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2
    from livelyspeaker_tpu_torch.scripts import (
        bench_data,
        bench_serve,
        bench_train,
        profile,
        soak_serve,
    )

    k1_total, k2_total = 0, {k: 0 for k in k2.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, argv in SERVE_RUNS:
            out, c, secs = _counted(lambda: bench_serve.main(["--max_batch", "16"] + argv))
            print(f"[measure] bench_serve {tag}: {secs:.2f} s, {out['batches']} batches "
                  f"(burst {out['burst_batches']}), K1 launches {c['k1']}, plain {c['k1_plain']} "
                  f"({card})")
            check(c["k1"] == 20 * out["batches"] and c["k1_plain"] == 0,
                  f"bench_serve {tag}: K1 {c['k1']} for {out['batches']} batches, "
                  f"plain {c['k1_plain']}")
            check(not any(c["k2"].values()), f"bench_serve {tag}: K2 ran")
            k1_total += c["k1"]

        # the fused step, the eager one (then both loaders), the fused one
        # again: fused and eager in turns
        step_ms = {"fused": [], "eager": []}
        for turn in ("fused", "loaders", "fused"):
            fused = turn == "fused"
            argv = ["--dtypes", "float32", "--steps", str(BENCH_TRAIN_STEPS)] + (
                ["--fused_train"] if fused else
                ["--loaders", "--data_dir", os.path.join(tmp, "loader_records")])
            rows, c, secs = _counted(lambda: bench_train.main(argv))
            step_ms["fused" if fused else "eager"].append(rows[0]["value"])
            check(np.isfinite(rows[0]["final_loss"]), f"bench_train: loss {rows[0]['final_loss']}")
            if not fused:
                print(f"[measure] bench_train --loaders (eager backbone): {secs:.2f} s ({card})")
                check([r.get("loader") for r in rows] == [None, "streaming", "device_resident"]
                      and all(r["value"] > 0 for r in rows), f"bench_train --loaders: {rows}")
                check(not any(c["k2"].values()) and c["k1"] == 0,
                      "bench_train --loaders: a kernel ran")
                continue
            steps = BENCH_TRAIN_STEPS + 1  # and the first step, timed apart
            print(f"[measure] bench_train --fused_train: {secs:.2f} s, K2 {c['k2']} over "
                  f"{steps} steps, plain {c['k2_plain']}, K1 {c['k1']} ({card})")
            want = {k: steps * (1 if k == "fwd" else LAYERS) for k in k2.LAUNCHES}
            check(c["k2"] == want and c["k2_plain"] == (0, 0) and c["k1"] == 0,
                  f"bench_train: K2 {c['k2']} (want {want}), plain {c['k2_plain']}, K1 {c['k1']}")
            for k in k2_total:
                k2_total[k] += c["k2"][k]
        print(f"[measure] bench_train step ms in turns (fused, eager, fused): "
              f"{step_ms['fused'][0]} / {step_ms['eager'][0]} / {step_ms['fused'][1]} ({card})")

        rows, _, secs = _counted(lambda: bench_data.main(
            ["--epochs", "1", "--synthetic_dir", tmp]))
        print(f"[measure] bench_data: {secs:.2f} s (records built included) ({card})")
        check(len(rows) == 3 and all(r["value"] > 0 for r in rows), f"bench_data: {rows}")

        trace_root = profile_dir or os.path.join(tmp, "traces")
        for what, argv, want_k1 in (
                ("sampler", ["--batch", "256", "--sampler", "ddim", "--timestep_respacing",
                             "ddim100", "--iters", "2"], 3 * EVAL_STEPS),
                ("train", ["--batch", "512", "--iters", "3"], 0)):
            path, c, secs = _counted(lambda: profile.main(
                ["--what", what, "--trace_dir", os.path.join(trace_root, f"profile_{what}")]
                + argv))
            check(os.path.getsize(path) > 0, f"profile {what}: no trace at {path}")
            t = trace_summary(path)
            print(f"[measure] profile --what {what}: {secs:.2f} s; trace {path}: span "
                  f"{t['span_ms']:.2f} ms, device busy {t['busy_ms']:.2f} ms, idle "
                  f"{100 * t['idle_share']:.1f}%, {t['kernels']} kernels, {t['launch_calls']} "
                  f"launch calls, K1 {t['k1_kernels']} kernels {t['k1_ms']:.2f} ms ({card})")
            print(f"[measure] profile --what {what}: top kernels "
                  + "; ".join(f"{n} {ms:.2f} ms" for n, ms in t["top"]))
            check(c["k1"] == want_k1 and c["k1_plain"] == 0,
                  f"profile {what}: K1 {c['k1']} (want {want_k1}), plain {c['k1_plain']}")
            if what == "sampler":
                check(t["k1_kernels"] == 2 * EVAL_STEPS,
                      f"profile sampler: K1's kernel {t['k1_kernels']} times in the trace")
            k1_total += c["k1"]

        summary, _, secs = _counted(lambda: soak_serve.main(
            ["--seconds", str(SOAK_SECONDS), "--reload_every", str(SOAK_RELOAD_EVERY),
             "--composition", "--out", os.path.join(tmp, "soak")]))
        print(f"[measure] soak_serve: {secs:.2f} s ({card})")
        check(summary["errors"] == 0 and summary["sigterm_exit_code"] == 0
              and summary["param_version"] == summary["reload"] > 0
              and summary["text"] > 0, f"soak_serve: {summary}")
    return k1_total, k2_total


GENERATE_TEXT = "we should protect the oceans"


def generate_phase(card):
    """``scripts.generate`` on the front end's seeded TED and SAG checkpoints
    (``_write_checkpoints``) and a seeded BEAT checkpoint, with --fused:
    ``run`` RAG-only (DDIM-100: K1 100 launches), with --sag_path (the
    composition's 20 refinement steps) and --long over 10 s of audio (100 a
    window), then ``main`` at BEAT (100, and its npz); the plain version
    never; the RAG-only TED clip against the same call through the eager
    modules (the same seeded generator) within rel 1e-4. Returns K1's
    launches."""
    import tempfile

    from livelyspeaker_tpu_torch.models import RAGConfig
    from livelyspeaker_tpu_torch.scripts import generate
    from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz

    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        _, paths = _write_checkpoints(tmp)
        bcfg = RAGConfig.beat()
        beat = _random_model(bcfg, seed=25)
        os.makedirs(os.path.join(tmp, "beat"))
        paths["beat"] = os.path.join(tmp, "beat", "rag.npz")
        save_params_npz(paths["beat"], beat.state_dict(), beat)
        save_args(os.path.dirname(paths["beat"]), {
            "njoints": bcfg.njoints, "nfeats": bcfg.nfeats, "n_poses": bcfg.nframes,
            "latent_dim": bcfg.latent_dim, "layers": bcfg.num_layers, "mlpact": bcfg.mlpact,
            "n_speakers": bcfg.n_speakers, "num_emotions": bcfg.num_emotions,
            "cond_mask_prob": bcfg.cond_mask_prob})
        speech = os.path.join(tmp, "speech.npy")
        rng = np.random.default_rng(26)
        np.save(speech, (0.1 * rng.normal(size=LONG_SECONDS * 16000)).astype(np.float32))
        base = ["--model_path", paths["rag"], "--audio", speech, "--speaker", "7"]
        total_frames = LONG_SECONDS * 15
        runs = (("rag", base + ["--fused"], EVAL_STEPS, 34),
                ("sag", base + ["--fused", "--sag_path", paths["sag"], "--text", GENERATE_TEXT],
                 COMPOSED_STEPS, 34),
                ("long", base + ["--fused", "--long"], EVAL_STEPS * LONG_WINDOWS, total_frames))
        motions = {}
        for tag, argv, want, frames in runs:
            (motion, wav), c, secs = _counted(lambda: generate.run(generate.parse_args(argv)))
            print(f"[generate] {tag}: motion {motion.shape}, {secs:.2f} s, K1 launches {c['k1']} "
                  f"(want {want}), plain {c['k1_plain']} ({card})")
            check(motion.shape == (frames, 27) and np.isfinite(motion).all(),
                  f"generate {tag}: motion {motion.shape}, finite {np.isfinite(motion).all()}")
            check(c["k1"] == want and c["k1_plain"] == 0,
                  f"generate {tag}: K1 {c['k1']} (want {want}), plain {c['k1_plain']}")
            motions[tag] = motion
            launches += c["k1"]
        eager, _ = generate.run(generate.parse_args(base))
        rel = float(np.abs(motions["rag"] - eager).max() / np.abs(eager).max())
        print(f"[generate] rag: fused against eager rel {rel:.3e} (tol {SLICE_TOL})")
        check(rel <= SLICE_TOL, f"generate: fused against eager rel {rel:.3e}")

        out = os.path.join(tmp, "beat_clip")
        path, c, secs = _counted(lambda: generate.main(
            ["--model_path", paths["beat"], "--audio", speech, "--emotion", "3", "--fused",
             "--out", out]))
        motion = np.load(path)["motion"]
        print(f"[generate] beat main: {path} motion {motion.shape}, {secs:.2f} s, K1 launches "
              f"{c['k1']}, plain {c['k1_plain']} ({card})")
        check(motion.shape == (34, bcfg.njoints * bcfg.nfeats) and np.isfinite(motion).all(),
              f"generate beat: motion {motion.shape}")
        check(c["k1"] == EVAL_STEPS and c["k1_plain"] == 0,
              f"generate beat: K1 {c['k1']}, plain {c['k1_plain']}")
        launches += c["k1"]
    return launches

DP_BATCH, DP_STEPS, DP_EPOCHS = 512, 3, 5  # two shards of 256 on the one card


def _dp_train_parts(model, lr):
    """(state, single-device step, optimizer, config) of ``model``: AdamW
    with eps 1e-3, as the CPU parity tests take it (its first step is
    g / (|g| + eps): at 1e-8 the round-off of a gradient that is 0 in exact
    arithmetic, such as the conv biases before an InstanceNorm, would turn
    into a step of lr)."""
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
    from livelyspeaker_tpu_torch.training import TrainConfig, init_train_state
    from livelyspeaker_tpu_torch.training.trainer import AdamW

    tcfg = TrainConfig(lr=lr)
    tx = AdamW(lr, eps=1e-3)
    sched = DiffusionSchedule.create(steps=1000, schedule="cosine")
    return init_train_state(dict(model.named_parameters()), tx, cfg=tcfg), sched, tx, tcfg


def _max_param_diff(a, b):
    return max((p - q).abs().max().item() for p, q in zip(a.parameters(), b.parameters()))


def data_parallel_phase(card):
    """Data parallelism (``parallel/``) on a mesh that names the one card
    twice, at TED full width: (1) training through K2 on both shards at a
    global batch of 512, held against the single-device step (identical
    shards with fold_shard_rng=False against the step at 256; different
    shards with injected t, noise, style and drop against the step at 512:
    loss within rel 1e-5, parameters within 1e-4), then TrainLoop(mesh=)
    for 3 steps (the main path: K2 twice the single-device launches, the
    replicas bit-identical, moments included); (2) the serving burst of 24
    requests through build_rag_server on the mesh (K1 2 x 20 launches a
    batch), the sharded sampler against the single-device one on a
    deterministic route (DDIM-20 at eta 0, noise and style injected: rel
    1e-4 of max|x|, K1 twice the launches) and one composed batch through
    LivelySpeakerPipeline(mesh=); (3) train_rag --device cuda:0,cuda:0
    --fused_train from synthetic records at B=512, and, on a one-card
    machine, serving_mesh(data_parallel=2) and eval_rag_ted
    --data_parallel 2 raising. Prints a step's and a burst's wall with one
    shard and with two, in turns. Returns K1's and K2's main-path
    launches."""
    import copy
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from livelyspeaker_tpu_torch.data import HashTokenizer
    from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records
    from livelyspeaker_tpu_torch.models import SAG, CLIPTextEncoder, RAG, RAGConfig
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2
    from livelyspeaker_tpu_torch.parallel import create_mesh, shard_train_step
    from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline, RAGSampler
    from livelyspeaker_tpu_torch.scripts import eval_rag_ted
    from livelyspeaker_tpu_torch.scripts.eval_common import final_npz
    from livelyspeaker_tpu_torch.serving import ServeConfig, build_rag_server, serving_mesh
    from livelyspeaker_tpu_torch.training import make_train_step
    from livelyspeaker_tpu_torch.training.loop import TrainLoop

    t_phase = time.perf_counter()
    two = create_mesh(devices=["cuda:0", "cuda:0"])
    cfg = RAGConfig.ted(fused_train_backbone=True)
    half = DP_BATCH // 2
    rng = np.random.default_rng(60)

    # (1a) identical shards, the parent's stream on both, against the step at 256
    base = RAG(cfg, generator=torch.Generator().manual_seed(61)).cuda()
    single, dp = base, copy.deepcopy(base)
    state, sched, tx, tcfg = _dp_train_parts(single, TRAIN_LR)
    dstate = _dp_train_parts(dp, TRAIN_LR)[0]
    step = make_train_step(single, sched, tx, tcfg)
    dstep = shard_train_step(dp, sched, tx, tcfg, two, fold_shard_rng=False)
    shard = _train_batch(cfg, rng, half)
    state, m = step(state, shard, torch.Generator(device="cuda").manual_seed(1))
    dstate, dm = dstep(dstate, {k: torch.cat([v, v]) for k, v in shard.items()},
                       torch.Generator(device="cuda").manual_seed(1))
    rel, diff = abs(dm["loss"] - m["loss"]) / abs(m["loss"]), _max_param_diff(single, dp)
    print(f"[data-parallel] identical shards of {half}, fold_shard_rng=False, against the "
          f"single step at {half}: loss {dm['loss']:.6f} / {m['loss']:.6f} (rel {rel:.3e}, tol "
          f"1e-5), max |param diff| {diff:.3e} (tol 1e-4)")
    check(rel <= 1e-5 and diff <= 1e-4, "data-parallel: identical shards disagree with the "
          "single-device step")

    # (1b) different shards, injected draws, against the step at 512
    single, dp = copy.deepcopy(base), copy.deepcopy(base)
    state, sched, tx, tcfg = _dp_train_parts(single, TRAIN_LR)
    dstate = _dp_train_parts(dp, TRAIN_LR)[0]
    step = make_train_step(single, sched, tx, tcfg)
    dstep = shard_train_step(dp, sched, tx, tcfg, two)
    batch = _train_batch(cfg, rng, DP_BATCH)
    g = torch.Generator(device="cuda").manual_seed(2)
    draws = {"t": torch.randint(0, 1000, (DP_BATCH,), generator=g, device="cuda"),
             "noise": torch.randn(batch["motion"].shape, generator=g, device="cuda"),
             "style_eps": torch.randn((DP_BATCH, 1, cfg.latent_dim), generator=g, device="cuda"),
             "cond_drop": (torch.rand((DP_BATCH,), generator=g, device="cuda") < 0.1).float()}
    state, m = step(state, batch, None, **draws)
    dstate, dm = dstep(dstate, batch, None, **draws)
    rel, diff = abs(dm["loss"] - m["loss"]) / abs(m["loss"]), _max_param_diff(single, dp)
    ps = _rel(dm["loss_per_sample"], m["loss_per_sample"])
    print(f"[data-parallel] two different shards of {half}, injected t, noise, style and drop, "
          f"against the single step at {DP_BATCH}: loss {dm['loss']:.6f} / {m['loss']:.6f} (rel "
          f"{rel:.3e}, tol 1e-5), per-sample losses rel {ps:.3e}, max |param diff| {diff:.3e} "
          f"(tol 1e-4)")
    check(rel <= 1e-5 and ps <= 1e-5 and diff <= 1e-4,
          "data-parallel: two shards disagree with the single-device step on their batch")
    check(torch.equal(dm["t"], draws["t"]), "data-parallel: t not gathered in shard order")

    # one step's wall, one shard at 512 against two of 256, in turns
    gen = lambda i: torch.Generator(device="cuda").manual_seed(100 + i)
    box = {"single": [state, step], "two": [dstate, dstep]}

    def run(name, n=4):
        st, fn = box[name]
        for i in range(n):
            st, _ = fn(st, batch, gen(i))
        box[name][0] = st

    for name in box:
        run(name, 1)  # warm-up
    step_ms = {k: [] for k in box}
    for name in ("single", "two", "two", "single"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name)
        torch.cuda.synchronize()
        step_ms[name].append((time.perf_counter() - t0) * 1e3 / 4)
    print(f"[data-parallel] train step at B={DP_BATCH}, host ms a step, synchronised, 4 steps a "
          f"turn, in turns: one shard {step_ms['single']}, two shards of {half} on the one card "
          f"{step_ms['two']} ({card})")
    del box, single, dp, state, dstate, step, dstep

    # (1c) the main path: TrainLoop over the mesh, counts set to 0 just before
    model = RAG(cfg, generator=torch.Generator().manual_seed(62)).cuda()
    loop = TrainLoop(model, sched, None, [batch] * DP_STEPS, cfg=tcfg, num_epochs=1,
                     log_interval=1, seed=63, mesh=two)
    torch.cuda.synchronize()
    _reset_counts()
    fused_mlp.fused_transmlp_reference.calls = 0
    state = loop.run_loop()
    torch.cuda.synchronize()
    k2_launches = dict(k2.LAUNCHES)
    plain = (k2.fused_transmlp_train_forward_reference.calls,
             k2.fused_transmlp_train_backward_reference.calls,
             fused_mlp.fused_transmlp.launches)
    r0, r1 = loop.step_fn.replicas
    s0, s1 = loop.step_fn.states()
    same = all(torch.equal(a, b) and torch.equal(s0.opt_state.mu[k], s1.opt_state.mu[k])
               and torch.equal(s0.opt_state.nu[k], s1.opt_state.nu[k])
               for (k, a), b in zip(r0.named_parameters(), r1.parameters()))
    print(f"[data-parallel] TrainLoop(mesh=[cuda:0, cuda:0]) {state.step} steps at "
          f"B={DP_BATCH}: K2 launches {k2_launches} (per step: fwd 2, each backward kernel "
          f"{2 * LAYERS}); plain versions and K1 {plain}; replicas bit-identical, moments "
          f"included: {same}")
    check(state.step == DP_STEPS, f"data-parallel: {state.step} steps ran")
    check(k2_launches["fwd"] == 2 * DP_STEPS, "data-parallel: K2's forward count")
    for k in ("bwd_block", "wgrad", "reduce"):
        check(k2_launches[k] == 2 * LAYERS * DP_STEPS, f"data-parallel: {k} launched "
              f"{k2_launches[k]} times")
    check(plain == (0, 0, 0), "data-parallel: a plain version or K1 ran on the training path")
    check(same, "data-parallel: the replicas differ after the steps")
    del loop, model, state, batch

    # (2) serving: the burst through the batcher on the mesh
    scfg = RAGConfig.ted()
    rag = _random_model(scfg, seed=64)
    batchers = {"single": build_rag_server(rag, ServeConfig()),
                "two": build_rag_server(rag, ServeConfig(data_parallel=2), mesh=two)}
    srng = np.random.default_rng(65)
    audio = [(0.1 * srng.normal(size=batchers["two"].n_samples)).astype(np.float32)
             for _ in range(24)]
    speakers = srng.integers(0, scfg.n_speakers, size=len(audio))
    guidances = srng.choice([1.0, 1.5, 2.0, 2.5], size=len(audio))
    try:
        for b in batchers.values():
            b.generate(audio[0], timeout=600)
            b.reset_stats()
        fused_mlp.fused_transmlp.launches = 0
        fused_mlp.fused_transmlp_reference.calls = 0
        results, errors, wall, threads = _burst(batchers["two"], audio, speakers, guidances, 3)
        k1_burst = fused_mlp.fused_transmlp.launches
        k1_plain = fused_mlp.fused_transmlp_reference.calls
        stats = batchers["two"].stats()
        burst_s = {"single": [], "two": [wall]}
        for name in ("single", "single", "two"):  # in turns with the counted burst
            burst_s[name].append(_burst(batchers[name], audio, speakers, guidances, 3)[2])
    finally:
        for b in batchers.values():
            b.close()
    check(not errors, f"data-parallel serving: a request failed: {errors[:1]}")
    check(all(not t.is_alive() for t in threads), "data-parallel serving: a client thread hung")
    for r in results:
        check(r is not None and r.shape == (9, 3, 34) and np.isfinite(r).all(),
              "data-parallel serving: a clip is missing, misshapen or non-finite")
    batches = stats["batches_served"]
    print(f"[data-parallel] serving burst of {len(audio)} requests through build_rag_server on "
          f"the mesh: {batches} batches, K1 launches {k1_burst} (2 x 20 a batch), plain version "
          f"{k1_plain}; p50 {stats['latency_ms_p50']:.1f} ms, p95 {stats['latency_ms_p95']:.1f} "
          f"ms")
    check(k1_burst == 2 * 20 * batches and k1_plain == 0,
          f"data-parallel serving: {k1_burst} K1 launches for {batches} batches")
    print(f"[data-parallel] burst wall, s, in turns (two, single, single, two): one shard "
          f"{burst_s['single']}, two shards on the one card {burst_s['two']} ({card})")

    # the sharded sampler against the single-device one, deterministic route
    cond = _cond(scfg, srng, 8)
    cond["style_eps"] = torch.from_numpy(
        srng.normal(size=(8, 1, scfg.latent_dim)).astype(np.float32)).cuda()
    noise = torch.from_numpy(srng.normal(size=(8, 9, 3, 34)).astype(np.float32)).cuda()
    outs, counts = {}, {}
    for name, kw in (("single", {}), ("two", {"mesh": two})):
        sampler = RAGSampler(rag, steps=1000, timestep_respacing="ddim20", method="ddim",
                             use_fused=True, **kw)
        n0 = fused_mlp.fused_transmlp.launches
        outs[name] = sampler(cond, torch.Generator(device="cuda").manual_seed(3),
                             guidance=1.5, noise=noise)
        torch.cuda.synchronize()
        counts[name] = fused_mlp.fused_transmlp.launches - n0
    rel = _rel(outs["two"], outs["single"])
    print(f"[data-parallel] sharded sampler (DDIM-20, eta 0, noise and style injected) against "
          f"the single-device one, batch 8: rel {rel:.3e} (tol {SLICE_TOL}); K1 launches "
          f"{counts['two']} against {counts['single']}")
    check(rel <= SLICE_TOL and bool(torch.isfinite(outs["two"]).all()),
          "data-parallel: the sharded sampler disagrees with the single-device one")
    check(counts == {"single": 20, "two": 40}, f"data-parallel: K1 launches {counts}")

    # one composed batch through LivelySpeakerPipeline(mesh=)
    g = torch.Generator().manual_seed(66)
    sag = random_normal_(SAG(njoints=9, nfeats=3, latent_dim=512, generator=g), g)
    clip = random_normal_(CLIPTextEncoder(generator=g), g)
    pipe = LivelySpeakerPipeline(rag, sag, clip, HashTokenizer(), use_fused=True, mesh=two)
    ccond = _cond(scfg, srng, len(SENTENCES))
    fused_mlp.fused_transmlp.launches = 0
    fused_mlp.fused_transmlp_reference.calls = 0
    t0 = time.perf_counter()
    out = pipe(SENTENCES, ccond, torch.Generator(device="cuda").manual_seed(4), guidance=1.5)
    torch.cuda.synchronize()
    comp_ms = (time.perf_counter() - t0) * 1e3
    k1_comp, comp_plain = fused_mlp.fused_transmlp.launches, fused_mlp.fused_transmlp_reference.calls
    print(f"[data-parallel] composed batch of {len(SENTENCES)} through LivelySpeakerPipeline("
          f"mesh=[cuda:0, cuda:0]): K1 launches {k1_comp} (2 x {COMPOSED_STEPS}), plain "
          f"version {comp_plain}, {comp_ms:.1f} ms on the host clock (its first call)")
    check(tuple(out.shape) == (len(SENTENCES), 9, 3, 34) and bool(torch.isfinite(out).all()),
          "data-parallel composition: shape or non-finite clip")
    check(k1_comp == 2 * COMPOSED_STEPS and comp_plain == 0,
          f"data-parallel composition: K1 launched {k1_comp} times")
    del pipe, sag, clip, rag

    # (3) the scripts
    work = tempfile.mkdtemp(prefix="chip_smoke_dp.")
    try:
        ted_dir, save_dir = os.path.join(work, "ted"), os.path.join(work, "run")
        build_synthetic_ted_records(ted_dir, n_clips=RECORD_CLIPS, clip_seconds=RECORD_SECONDS,
                                    seed=67)
        argv = ["--dataset", "ted", "--data_dir", ted_dir, "--device", "cuda:0,cuda:0",
                "--fused_train", "--batch_size", str(DP_BATCH), "--epochs", str(DP_EPOCHS),
                "--lr", str(TRAIN_LR), "--latent_dim", "512", "--layers", str(LAYERS),
                "--n_speakers", "1400", "--seed", "12"]
        run_loop, run = _records_rag_run("data-parallel train_rag", argv, save_dir, card,
                                         want_decrease=True, shards=2)
        check(run_loop.mesh is not None and run_loop.mesh.size == 2,
              "data-parallel train_rag: the loop is not on a mesh of two")
        if torch.cuda.device_count() == 1:
            try:
                serving_mesh(ServeConfig(data_parallel=2))
                raised = None
            except (ValueError, RuntimeError) as e:
                raised = str(e)
            print(f"[data-parallel] serving_mesh(ServeConfig(data_parallel=2)) on one card: "
                  f"raised {raised!r}")
            check(raised is not None, "serving_mesh(data_parallel=2) ran on one card")
            try:
                with redirect_stdout(sys.stderr):
                    eval_rag_ted.main(["--model_path", final_npz(save_dir), "--data_dir",
                                       ted_dir, "--data_parallel", "2", "--fused"])
                raised = None
            except SystemExit as e:
                raised = str(e)
            print(f"[data-parallel] eval_rag_ted --data_parallel 2 on one card: raised "
                  f"{raised!r}")
            check(raised is not None, "eval_rag_ted --data_parallel 2 ran on one card")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[data-parallel] phase wall {time.perf_counter() - t_phase:.1f} s")
    for k in k2_launches:
        k2_launches[k] += run["launches"][k]
    return k1_burst + k1_comp, k2_launches


MH_BATCH, MH_STEPS, MH_TIMEOUT = 512, 3, 300  # the global batch: 256 a process


def _mh_data(cfg):
    """The multi-process phase's global batch and each step's draws, the
    same on every process (numpy, seeded)."""
    rng = np.random.default_rng(70)
    batch = _train_batch(cfg, rng, MH_BATCH)
    draws = []
    for _ in range(MH_STEPS):
        d = {"t": rng.integers(0, 1000, size=(MH_BATCH,)),
             "noise": rng.normal(size=(MH_BATCH, cfg.njoints, cfg.nfeats, cfg.nframes))
             .astype(np.float32),
             "style_eps": rng.normal(size=(MH_BATCH, 1, cfg.latent_dim)).astype(np.float32),
             "cond_drop": (rng.random(MH_BATCH) < 0.1).astype(np.float32)}
        draws.append({k: torch.from_numpy(v).cuda() for k, v in d.items()})
    return batch, draws


def _mh_model():
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig

    cfg = RAGConfig.ted(fused_train_backbone=True)
    return cfg, RAG(cfg, generator=torch.Generator().manual_seed(71)).cuda()


def _wait_for(path, procs=()):
    """Poll for ``path`` (a gate or a result file), MH_TIMEOUT at most; a
    process of ``procs`` that fails meanwhile fails the phase."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if any(p.poll() for p in procs):
            _finish(procs, f"multihost: waiting for {os.path.basename(path)}")
        check(time.perf_counter() - t0 < MH_TIMEOUT, f"multihost: no {path}")
        time.sleep(0.01)


def _mh_train(mesh, rows, gate=None):
    """MH_STEPS data-parallel steps of the fused TED model over ``mesh`` on
    ``rows`` of each global batch, once the file ``gate`` exists (the set-up
    before it is not timed): (model, losses, step ms, K2 launches, plain
    calls)."""
    from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2
    from livelyspeaker_tpu_torch.parallel import global_batch, shard_train_step

    cfg, model = _mh_model()
    state, sched, tx, tcfg = _dp_train_parts(model, TRAIN_LR)
    step = shard_train_step(model, sched, tx, tcfg, mesh)
    batch, draws = _mh_data(cfg)
    torch.cuda.synchronize()
    if gate is not None:
        _wait_for(gate)
    _reset_counts()
    losses, ms = [], []
    for d in draws:
        t0 = time.perf_counter()
        state, m = step(state, global_batch({k: v[rows] for k, v in batch.items()}, mesh), None,
                        **{k: v[rows] for k, v in d.items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    plain = (k2.fused_transmlp_train_forward_reference.calls,
             k2.fused_transmlp_train_backward_reference.calls)
    return model, losses, ms, dict(k2.LAUNCHES), plain


@contextlib.contextmanager
def cudnn_pinned(on=True):
    """cuDNN pinned to deterministic algorithms (``deterministic = True``,
    ``benchmark = False``) inside the block, as it was after."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    if on:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def multihost_worker(rank, world, port, backend, out_dir, pinned=False):
    """One process of ``multihost_phase``: joins the group on cuda:0, sets
    up, trains its rows once ``out_dir/go_{backend}`` exists (with
    ``pinned``, cuDNN pinned to deterministic algorithms), and writes its
    numbers (and rank 0 its params) to ``out_dir``."""
    import hashlib

    import torch.distributed as dist

    from livelyspeaker_tpu_torch.parallel import create_mesh, init_distributed

    if pinned:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    init_distributed(f"localhost:{port}", world, rank, local_device_ids=[0], backend=backend)
    try:
        mesh = create_mesh(devices=["cuda:0"])
        rows = slice(rank * MH_BATCH // world, (rank + 1) * MH_BATCH // world)
        model, losses, ms, launches, plain = _mh_train(
            mesh, rows, gate=os.path.join(out_dir, f"go_{backend}"))
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
        if rank == 0:
            torch.save(flat, os.path.join(out_dir, f"params_{backend}.pt"))
        with open(os.path.join(out_dir, f"{backend}_rank{rank}.part"), "w") as f:
            json.dump({"losses": losses, "ms": ms, "launches": launches, "plain": plain,
                       "sha256": hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
                       "data": mesh.shape["data"], "backend": dist.get_backend()}, f)
        os.replace(os.path.join(out_dir, f"{backend}_rank{rank}.part"),
                   os.path.join(out_dir, f"{backend}_rank{rank}.json"))
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(cmds):
    """Start the commands from this checkout's root."""
    root = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for c in cmds]


def _finish(procs, tag):
    """Wait for the processes (MH_TIMEOUT each); every one is killed and
    joined whatever happens. Returns their outputs."""
    try:
        outs = [p.communicate(timeout=MH_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
    for p, out in zip(procs, outs):
        if p.returncode:
            print(out[-4000:])
        check(p.returncode == 0, f"{tag}: a process exited with {p.returncode}")
    return outs


def _worker_cmd(rank, world, port, backend, out_dir, pinned=False):
    code = (f"import chip_smoke; chip_smoke.multihost_worker({rank}, {world}, {port}, "
            f"{backend!r}, {out_dir!r}, pinned={pinned})")
    return [sys.executable, "-c", code]


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()


def _param_gap(model, got):
    """(largest |got - model| over the parameters, its name, the largest
    outside the conv biases before an InstanceNorm), ``got`` the flat
    parameters of another run."""
    names = [k for k, _ in model.named_parameters()]
    sizes = [p.numel() for p in model.parameters()]
    diffs = [(a - b).abs().max().item()
             for a, b in zip(got.split(sizes), _flat_params(model).split(sizes))]
    diff = max(diffs)
    outside = max(d for k, d in zip(names, diffs) if k not in ZERO_GRAD)
    return diff, names[diffs.index(diff)], outside


def multihost_pinned_check(card):
    """The gloo pair against the in-process [cuda:0, cuda:0] step once more
    with cuDNN pinned to deterministic algorithms in all three runs: whether
    the unpinned runs' gap at the WavEncoder's weights goes to 0. The gate
    stays 1e-4; the bits are reported."""
    from livelyspeaker_tpu_torch.parallel import create_mesh

    work = tempfile.mkdtemp(prefix="chip_smoke_mh_pinned.")
    procs = []
    try:
        port = _free_port()
        procs = _start([_worker_cmd(r, 2, port, "gloo", work, pinned=True) for r in (0, 1)])
        open(os.path.join(work, "go_gloo"), "w").close()
        for r in (0, 1):
            _wait_for(os.path.join(work, f"gloo_rank{r}.json"), procs)
        _finish(procs, "multihost pinned gloo ranks")
        with cudnn_pinned():
            model, losses, ms, _, _ = _mh_train(create_mesh(devices=["cuda:0", "cuda:0"]),
                                                slice(None))
        with open(os.path.join(work, "gloo_rank0.json")) as f:
            rank0 = json.load(f)
        got = torch.load(os.path.join(work, "params_gloo.pt"), weights_only=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(rank0["losses"], losses))
    diff, leaf, outside = _param_gap(model, got)
    exact = bool(torch.equal(got, _flat_params(model)))
    print(f"[multihost] cuDNN pinned deterministic in all three runs: gloo pair against the "
          f"in-process step ({ms} ms a step, {card}): loss rel {rel:.3e}, max |param diff| "
          f"{diff:.3e} at {leaf}, {outside:.3e} outside the conv biases before an "
          f"InstanceNorm, bit-identical: {exact}")
    check(rel <= 1e-5 and diff <= 1e-4, "multihost pinned: the processes disagree with the mesh step")
    return {"diff": diff, "leaf": leaf, "bit_identical": exact}


def multihost_phase(card):
    """Multi-process data parallelism over torch.distributed on the one
    card: two processes join a gloo group on cuda:0 and each trains
    MH_STEPS steps of the fused TED model on its 256 rows of a global batch
    of 512 with injected draws (K2 in each process); both ranks must hold
    the same bits, and rank 0's loss and params must agree with the
    in-process [cuda:0, cuda:0] mesh step on the same batch and draws within
    the data-parallel phase's gates (loss rel 1e-5, params 1e-4). A one-rank
    NCCL group trains the same steps (NCCL's init and all-reduce on the
    card), and the demo script runs on two gloo processes (--platform
    cuda). The processes start together and set up at once; the timed
    steps run one after another, each alone on the card: the gloo pair,
    the NCCL rank, the in-process reference; then the demo. Returns K2's
    launches in the processes."""
    from livelyspeaker_tpu_torch.parallel import create_mesh

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mh.")
    procs = []
    try:
        port, demo_port, nccl_port = _free_port(), _free_port(), _free_port()
        procs = _start([_worker_cmd(r, 2, port, "gloo", work) for r in (0, 1)]
                       + [_worker_cmd(0, 1, nccl_port, "nccl", work)])
        result = lambda name: os.path.join(work, f"{name}.json")
        open(os.path.join(work, "go_gloo"), "w").close()
        for r in (0, 1):
            _wait_for(result(f"gloo_rank{r}"), procs)
        open(os.path.join(work, "go_nccl"), "w").close()
        _wait_for(result("nccl_rank0"), procs)
        _finish(procs, "multihost gloo ranks and one-rank nccl")
        model, losses, ms, _, _ = _mh_train(create_mesh(devices=["cuda:0", "cuda:0"]),
                                            slice(None))
        ranks = []
        for r in (0, 1):
            with open(result(f"gloo_rank{r}")) as f:
                ranks.append(json.load(f))
        with open(result("nccl_rank0")) as f:
            nccl = json.load(f)
        got = torch.load(os.path.join(work, "params_gloo.pt"), weights_only=True)
        procs = _start([[sys.executable, "-m",
                         "livelyspeaker_tpu_torch.scripts.train_multihost_demo",
                         "--process_id", str(r), "--coordinator", f"localhost:{demo_port}",
                         "--platform", "cuda", "--backend", "gloo"] for r in (0, 1)])
        outs = _finish(procs, "multihost demo")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)

    for r, res in enumerate(ranks):
        print(f"[multihost] gloo rank {r} of 2 on cuda:0, mesh data {res['data']}: losses "
              + " ".join(f"{v:.6f}" for v in res["losses"]) + f"; step ms {res['ms']} "
              f"(the two processes share the card; {card}); K2 launches "
              f"{res['launches']}, plain versions {res['plain']}")
        check(res["data"] == 2 and res["backend"] == "gloo", f"multihost: rank {r}'s mesh")
        check(res["launches"]["fwd"] == MH_STEPS and res["plain"] == [0, 0],
              f"multihost: rank {r} launched K2's forward {res['launches']['fwd']} times")
        for k in ("bwd_block", "wgrad", "reduce"):
            check(res["launches"][k] == LAYERS * MH_STEPS,
                  f"multihost: rank {r} launched {k} {res['launches'][k]} times")
    check(ranks[0]["sha256"] == ranks[1]["sha256"], "multihost: the ranks' params differ")
    check(ranks[0]["losses"] == ranks[1]["losses"], "multihost: the ranks' losses differ")

    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], losses))
    diff, leaf, outside = _param_gap(model, got)
    print(f"[multihost] two gloo processes against the in-process [cuda:0, cuda:0] step "
          f"({ms} ms a step, {card}): loss rel {rel:.3e} (tol 1e-5), max |param diff| "
          f"{diff:.3e} (tol 1e-4) at {leaf}, {outside:.3e} outside the "
          f"conv biases before an InstanceNorm (gradient 0 in exact arithmetic), "
          f"bit-identical: {bool(torch.equal(got, _flat_params(model)))}")
    check(rel <= 1e-5 and diff <= 1e-4, "multihost: the processes disagree with the mesh step")
    del model

    print(f"[multihost] one-rank nccl group (backend {nccl['backend']}): losses "
          + " ".join(f"{v:.6f}" for v in nccl["losses"]) + f"; step ms {nccl['ms']} ({card}); "
          f"K2 launches {nccl['launches']}")
    check(nccl["backend"] == "nccl" and nccl["data"] == 1, "multihost: the nccl group")
    check(nccl["launches"]["fwd"] == MH_STEPS and nccl["plain"] == [0, 0],
          "multihost: the nccl rank's K2 launches")
    check(all(np.isfinite(nccl["losses"])), "multihost: the nccl rank's loss is not finite")
    demo_losses = []
    for out in outs:
        check("multihost demo OK" in out, "multihost demo: no 'multihost demo OK'")
        demo_losses.append(re.findall(r"loss=([0-9.]+)", out))
        print("[multihost] demo: " + " | ".join(
            line for line in out.splitlines() if line.startswith("[p")))
    check(len(demo_losses[0]) == 3 and demo_losses[0] == demo_losses[1],
          f"multihost demo: the processes print other losses {demo_losses}")
    multihost_pinned_check(card)
    print(f"[multihost] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {k: ranks[0]["launches"][k] + ranks[1]["launches"][k] + nccl["launches"][k]
            for k in ranks[0]["launches"]}


MESH_RECORD_CLIPS = 60  # 1,560 windows: one epoch of 3 steps at B=512


def _state_bytes(state):
    """Bytes of a train state's params, Adam moments and EMA (one shard)."""
    trees = (state.params, state.opt_state.mu, state.opt_state.nu, state.ema_params or {})
    return sum(t.numel() * t.element_size() for tree in trees for t in tree.values())


def _mesh_records(work):
    from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records

    ted_dir = os.path.join(work, "ted")
    if not os.path.exists(os.path.join(ted_dir, "meta.json")):
        build_synthetic_ted_records(ted_dir, n_clips=MESH_RECORD_CLIPS,
                                    clip_seconds=RECORD_SECONDS, seed=72)
    return ted_dir


def _mesh_run(tag, work, flags, card):
    """train_rag on the eager backbone at TED B=512 for one epoch (3 steps),
    with ``flags``: the loop and its numbers; K2 must not run."""
    argv = ["--dataset", "ted", "--data_dir", _mesh_records(work), "--batch_size",
            str(TRAIN_BATCH), "--epochs", "1", "--lr", str(TRAIN_LR), "--latent_dim", "512",
            "--layers", str(LAYERS), "--n_speakers", "1400", "--seed", "13", *flags]
    return _records_rag_run(tag, argv, os.path.join(work, tag.replace(" ", "_")), card,
                            want_decrease=False, shards=0)


def fsdp_phase(card, work):
    """train_rag --fsdp --device cuda:0,cuda:0 (eager backbone, TED B=512,
    3 steps) against the replicated data-parallel run on the same
    mesh: the losses within rel 1e-5, each shard's persistent state (params,
    Adam moments) about half the replicated shard's. Returns the replicated
    run's losses."""
    t_phase = time.perf_counter()
    rep_loop, rep = _mesh_run("replicated", work, ["--device", "cuda:0,cuda:0"], card)
    rep_bytes = [_state_bytes(s) for s in rep_loop.step_fn.states()]
    del rep_loop
    torch.cuda.empty_cache()
    loop, run = _mesh_run("fsdp", work, ["--device", "cuda:0,cuda:0", "--fsdp"], card)
    states = loop.step_fn.states()
    nbytes = [_state_bytes(s) for s in states]
    freed = all(p.numel() == 0 for r in loop.step_fn.replicas
                for k, p in r.named_parameters() if k in loop.step_fn.shards.dims)
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], rep["losses"]))
    ratio = max(a / b for a, b in zip(nbytes, rep_bytes))
    mib = lambda xs: [round(x / 2 ** 20, 2) for x in xs]
    print(f"[fsdp] {len(loop.step_fn.shards.dims)} of {len(states[0].params)} leaves sharded; "
          f"persistent state a shard {mib(nbytes)} MiB against {mib(rep_bytes)} replicated "
          f"(ratio {ratio:.3f}); gathered weights freed after the step: {freed}; peak memory "
          f"{run['peak_gib']:.2f} GiB against {rep['peak_gib']:.2f}")
    print(f"[fsdp] losses against the replicated run: rel {rel:.3e} (tol 1e-5); step "
          f"{run['step_ms']:.2f} ms against {rep['step_ms']:.2f} ({card})")
    check(rel <= 1e-5, "fsdp: the losses disagree with the replicated run's")
    check(0.45 <= ratio <= 0.6, f"fsdp: a shard holds {ratio:.3f} of the replicated state")
    check(freed, "fsdp: a replica kept its gathered weights")
    print(f"[fsdp] phase wall {time.perf_counter() - t_phase:.1f} s")
    return rep["losses"]


def pipeline_phase(card, work, replicated_losses):
    """train_rag --pipeline_parallel 2 --device cuda:0,cuda:0 (one row of two
    stages) against the plain step on cuda:0, then --pipeline_parallel 2
    --fsdp over cuda:0 named four times (2 data rows of 2 stages) against
    the replicated two-shard run of ``fsdp_phase`` (the same folded
    streams): eager backbone, TED B=512, 3 steps, losses within
    rel 1e-5."""
    t_phase = time.perf_counter()
    plain = _mesh_run("plain", work, ["--device", "cuda:0"], card)[1]
    one_row = _mesh_run("pipeline", work, ["--device", "cuda:0,cuda:0",
                                           "--pipeline_parallel", "2"], card)
    check(one_row[0].mesh.shape == {"data": 1, "stage": 2}, "pipeline: the mesh")
    rows = _mesh_run("pipeline fsdp", work, ["--device", ",".join(["cuda:0"] * 4),
                                             "--pipeline_parallel", "2", "--fsdp"], card)
    check(rows[0].mesh.shape == {"data": 2, "stage": 2} and rows[0].fsdp, "pipeline: the mesh")
    rel1 = max(abs(a - b) / abs(b) for a, b in zip(one_row[1]["losses"], plain["losses"]))
    rel2 = max(abs(a - b) / abs(b) for a, b in zip(rows[1]["losses"], replicated_losses))
    print(f"[pipeline] one row of 2 stages against the plain step: loss rel {rel1:.3e}; 2 rows "
          f"of 2 stages with fsdp against the replicated two-shard run: rel {rel2:.3e} (tol "
          f"1e-5); step {one_row[1]['step_ms']:.2f} and {rows[1]['step_ms']:.2f} ms against "
          f"{plain['step_ms']:.2f} plain ({card})")
    check(rel1 <= 1e-5 and rel2 <= 1e-5, "pipeline: the losses disagree")
    print(f"[pipeline] phase wall {time.perf_counter() - t_phase:.1f} s")


TP_SAMPLE_BATCH, TP_STEPS, TP_PIPE_BATCH = 16, 3, 64


def _device_state_bytes(states, layout):
    """{(data row, model column): bytes} of each row's persistent state
    (params, Adam moments, EMA): a slice ``name.j`` of a split leaf on
    column j, every other leaf on column 0, its row's first device."""
    out = {}
    for i, state in enumerate(states):
        for tree in (state.params, state.opt_state.mu, state.opt_state.nu,
                     state.ema_params or {}):
            for k, t in tree.items():
                key = (i, layout[k][2])
                out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def tensor_parallel_phase(card):
    """Tensor parallelism (``parallel/tensor_parallel.py``) at TED full width
    (D=512, L=8, S=35, silu) over cuda:0 named four times (data 2 x model 2):
    the eager RAGSampler (DDIM-20 at eta 0, noise and style injected, batch
    16) against the single-device eager sampler within rel 1e-4 of max|x|,
    K1 never launched; 3 FSDP steps at B=512 on the eager backbone against
    the replicated single-device step (injected draws; loss within rel 1e-5
    each step, params within 1e-4), each device's persistent state bytes
    beside the replicated run's; a pipeline forward of 2 stages x model 2
    (cuda:0 named eight times, 2 data rows) against the sequential backbone
    within rel 1e-5 of max|x|; the fused sampler and the fused step on the
    mesh raising the JAX package's words. The ms printed are plumbing on
    one card (the devices of a group run in turns), not speed."""
    import copy

    from livelyspeaker_tpu_torch import parallel
    from livelyspeaker_tpu_torch.models import RAG, RAGConfig
    from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP
    from livelyspeaker_tpu_torch.models.initializers import random_normal_
    from livelyspeaker_tpu_torch.ops import fused_mlp
    from livelyspeaker_tpu_torch.parallel.sampling import TP_FUSED_REFUSAL as SAMPLE_WORDS
    from livelyspeaker_tpu_torch.parallel.training import TP_FUSED_REFUSAL as TRAIN_WORDS
    from livelyspeaker_tpu_torch.pipeline import RAGSampler
    from livelyspeaker_tpu_torch.training import make_train_step

    t_phase = time.perf_counter()
    mesh = parallel.create_mesh(devices=["cuda:0"] * 4, model_parallel=2)
    check(mesh.shape == {"data": 2, "model": 2}, f"tensor-parallel: mesh {mesh.shape}")
    cfg = RAGConfig.ted()
    rng = np.random.default_rng(90)

    # (1) the sampler
    rag = _random_model(cfg, seed=91)
    b = TP_SAMPLE_BATCH
    cond = _cond(cfg, rng, b)
    cond["style_eps"] = torch.from_numpy(
        rng.normal(size=(b, 1, cfg.latent_dim)).astype(np.float32)).cuda()
    noise = torch.from_numpy(rng.normal(size=(b, 9, 3, 34)).astype(np.float32)).cuda()
    samplers = {name: RAGSampler(rag, steps=1000, timestep_respacing="ddim20", method="ddim",
                                 **kw) for name, kw in (("single", {}), ("tp", {"mesh": mesh}))}
    fused_mlp.fused_transmlp.launches = 0
    outs = {name: sampler(cond, None, guidance=1.5, noise=noise)
            for name, sampler in samplers.items()}  # also the warm-up
    ms = {name: [] for name in samplers}
    for name in ("single", "tp", "tp", "single"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samplers[name](cond, None, guidance=1.5, noise=noise)
        torch.cuda.synchronize()
        ms[name].append(round((time.perf_counter() - t0) * 1e3, 1))
    rel = _rel(outs["tp"], outs["single"])
    split = sum(isinstance(m, parallel.TPWeight) for m in samplers["tp"].replicas[0].modules())
    print(f"[tensor-parallel] eager RAGSampler on data 2 x model 2 ({split} weights in slices a "
          f"replica) against the single-device one, DDIM-20 at eta 0, batch {b}: rel {rel:.3e} "
          f"(tol {SLICE_TOL}); K1 launches {fused_mlp.fused_transmlp.launches}; host ms a call "
          f"(synchronised, after a warm-up, in turns) {ms['tp']} against {ms['single']} ({card})")
    check(rel <= SLICE_TOL and bool(torch.isfinite(outs["tp"]).all()),
          "tensor-parallel: the sampler disagrees with the single-device one")
    check(fused_mlp.fused_transmlp.launches == 0, "tensor-parallel: K1 ran on the eager route")
    del samplers, outs

    # (2) FSDP over data x model against the replicated single-device step
    base = RAG(cfg, generator=torch.Generator().manual_seed(92)).cuda()
    single, tp = base, copy.deepcopy(base)
    state, sched, tx, tcfg = _dp_train_parts(single, TRAIN_LR)
    fstate = _dp_train_parts(tp, TRAIN_LR)[0]
    rep_bytes = _state_bytes(state)
    step = make_train_step(single, sched, tx, tcfg)
    fstep = parallel.fsdp_train_step(tp, sched, tx, tcfg, mesh)
    rels, step_ms = [], {"single": [], "fsdp": []}
    g = torch.Generator(device="cuda").manual_seed(93)
    for i in range(TP_STEPS):
        batch = _train_batch(cfg, rng, TRAIN_BATCH)
        draws = {"t": torch.randint(0, 1000, (TRAIN_BATCH,), generator=g, device="cuda"),
                 "noise": torch.randn(batch["motion"].shape, generator=g, device="cuda"),
                 "style_eps": torch.randn((TRAIN_BATCH, 1, cfg.latent_dim), generator=g,
                                          device="cuda"),
                 "cond_drop": (torch.rand((TRAIN_BATCH,), generator=g, device="cuda")
                               < 0.1).float()}
        for name, fn in (("single", step), ("fsdp", fstep)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "single":
                state, m = fn(state, batch, None, **draws)
            else:
                fstate, fm = fn(fstate, batch, None, **draws)
            torch.cuda.synchronize()
            step_ms[name].append(round((time.perf_counter() - t0) * 1e3, 2))
        rels.append(abs(fm["loss"] - m["loss"]) / abs(m["loss"]))
    full = fstep.gathered_state()
    diff = max((full.params[k] - v).abs().max().item() for k, v in state.params.items())
    dev_bytes = _device_state_bytes(fstep.states(), fstep.shards.layout)
    mib = lambda x: round(x / 2 ** 20, 2)
    print(f"[tensor-parallel] fsdp_train_step on data 2 x model 2, eager backbone, B="
          f"{TRAIN_BATCH}, injected draws, {TP_STEPS} steps against the single-device step: "
          f"loss rel {[f'{r:.3e}' for r in rels]} (tol 1e-5), max |param diff| {diff:.3e} (tol "
          f"1e-4); {len(fstep.shards.dims)} of {len(fstate.params)} leaves sharded over data")
    print(f"[tensor-parallel] persistent state a device (data row, model column) MiB "
          f"{ {k: mib(v) for k, v in sorted(dev_bytes.items())} } against {mib(rep_bytes)} "
          f"replicated; step host ms (synchronised, in turns, the first a warm-up) fsdp "
          f"{step_ms['fsdp']}, single {step_ms['single']} ({card})")
    check(max(rels) <= 1e-5 and diff <= 1e-4,
          "tensor-parallel: the FSDP step disagrees with the single-device step")
    check(max(dev_bytes.values()) < 0.5 * rep_bytes,
          "tensor-parallel: a device holds half of the replicated state or more")
    del single, tp, base, state, fstate, step, fstep, full

    # (3) GPipe stages with column-parallel channel mixes
    torch.manual_seed(94)
    g = torch.Generator().manual_seed(94)
    backbone = random_normal_(TransMLP(cfg.seq_len, LAYERS, cfg.latent_dim, cfg.mlpact,
                                       generator=g), g).cuda()
    x = torch.from_numpy(rng.normal(size=(TP_PIPE_BATCH, cfg.seq_len, cfg.latent_dim))
                         .astype(np.float32)).cuda()
    t = torch.from_numpy(rng.integers(0, 1000, size=(TP_PIPE_BATCH,))).cuda()
    pmesh = parallel.create_pipeline_mesh(devices=["cuda:0"] * 8, pipeline_parallel=2,
                                          model_parallel=2)
    check(pmesh.shape == {"data": 2, "stage": 2, "model": 2}, f"tensor-parallel: {pmesh.shape}")
    with torch.no_grad():
        stacked = parallel.stack_block_params(dict(backbone.named_parameters()), LAYERS)
        emb = backbone.embed_timestep(t)
        seq = backbone(x, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        piped = parallel.pipeline_forward(stacked, x, emb, pmesh, num_microbatches=2,
                                          act=cfg.mlpact)
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
    rel = _rel(piped, seq)
    print(f"[tensor-parallel] pipeline_forward on data 2 x stage 2 x model 2 against the "
          f"sequential backbone, batch {TP_PIPE_BATCH}: rel {rel:.3e} (tol 1e-5); host ms "
          f"{pipe_ms:.1f} ({card})")
    check(rel <= 1e-5, "tensor-parallel: the pipeline disagrees with the sequential backbone")

    # (4) the fused kernels refuse the model axis, with the JAX package's words
    words = {}
    try:
        RAGSampler(rag, use_fused=True, mesh=mesh)
    except ValueError as e:
        words["sampler"] = str(e)
    fused = RAG(RAGConfig.ted(fused_train_backbone=True)).cuda()
    try:
        parallel.shard_train_step(fused, sched, tx, tcfg, mesh)
    except ValueError as e:
        words["step"] = str(e)
    print(f"[tensor-parallel] refusals: {words}")
    check(words == {"sampler": SAMPLE_WORDS.format(2), "step": TRAIN_WORDS.format(2)},
          "tensor-parallel: the fused kernels did not refuse the model axis")
    print(f"[tensor-parallel] phase wall {time.perf_counter() - t_phase:.1f} s")


STUDY_CLIPS, STUDY_EPOCHS = 40, 4  # 1,040 windows: 2 steps an epoch at B=512, 8 a soak run
LONG_FORM_SECONDS = 10


def dump_train_counts(out_dir):
    """In a ``train_rag`` process the studies start: write K1's and K2's
    launches and their plain versions' calls to ``out_dir`` at exit."""
    from livelyspeaker_tpu_torch.ops import fused_mlp, fused_mlp_train as k2

    counts = {"argv": sys.argv[1:], "k2": dict(k2.LAUNCHES),
              "k2_plain": [k2.fused_transmlp_train_forward_reference.calls,
                           k2.fused_transmlp_train_backward_reference.calls],
              "k1": fused_mlp.fused_transmlp.launches}
    with open(os.path.join(out_dir, f"train_{os.getpid()}.json"), "w") as f:
        json.dump(counts, f)


@contextlib.contextmanager
def _counted_train_rag(count_dir):
    """Every ``train_rag`` process a study starts (``eval_common.
    run_train_rag``) writes its kernel counts to ``count_dir`` at exit: the
    command the study asked for, run through ``runpy`` after registering
    :func:`dump_train_counts` (the soak's cuDNN pin kept)."""
    from livelyspeaker_tpu_torch.scripts import eval_common

    orig = eval_common.train_rag_command
    run_module = ("import runpy; runpy.run_module('livelyspeaker_tpu_torch.scripts.train_rag', "
                  "run_name='__main__', alter_sys=True)")

    def counted(argv, *, cudnn_deterministic=False):
        cmd = orig(argv, cudnn_deterministic=cudnn_deterministic)
        if cmd[1] == "-m":
            cmd = [cmd[0], "-c", run_module] + cmd[3:]
        cmd[2] = (f"import atexit, chip_smoke; atexit.register(chip_smoke.dump_train_counts, "
                  f"{count_dir!r}); " + cmd[2])
        return cmd

    eval_common.train_rag_command = counted
    try:
        yield
    finally:
        eval_common.train_rag_command = orig


def _train_counts(count_dir):
    """The counts of the processes that wrote to ``count_dir``, emptied."""
    out = []
    for name in sorted(os.listdir(count_dir)):
        with open(os.path.join(count_dir, name)) as f:
            out.append(json.load(f))
        os.unlink(os.path.join(count_dir, name))
    return out


def _run_steps(argv, spe):
    """Steps a ``train_rag`` process took: its epochs, less those a resume
    starts past (each study's runs resume only to the end of the split)."""
    epochs = int(argv[argv.index("--epochs") + 1])
    if "--resume_checkpoint" in argv:
        epochs -= epochs // 2
    return epochs * spe


def _check_k2_counts(tag, procs, spe, total):
    """K2's launches in a study's train_rag processes: 1 forward and LAYERS
    of each backward kernel a step, no plain version, no K1; returns their
    sum."""
    launches = {k: 0 for k in ("fwd", "bwd_block", "wgrad", "reduce")}
    steps = 0
    for p in procs:
        n = _run_steps(p["argv"], spe)
        steps += n
        check(p["k2"]["fwd"] == n and all(p["k2"][k] == LAYERS * n
                                          for k in ("bwd_block", "wgrad", "reduce")),
              f"{tag}: K2 launches {p['k2']} for {n} steps")
        check(p["k2_plain"] == [0, 0] and p["k1"] == 0,
              f"{tag}: plain versions {p['k2_plain']}, K1 {p['k1']} in a training process")
        for k in launches:
            launches[k] += p["k2"][k]
    check(steps == total, f"{tag}: {steps} steps in {len(procs)} processes, want {total}")
    print(f"[studies] {tag}: K2 launches {launches} over {steps} steps in {len(procs)} "
          f"train_rag processes (per step: fwd 1, each backward kernel {LAYERS}); plain 0")
    return launches


def _median_step_ms(save_dir):
    """Median step ms of a run logged every step, from the log's clock,
    after its first two steps."""
    rows = _progress_rows(save_dir, "loss")
    ms = np.diff([r["elapsed_s"] for r in rows]) * 1e3
    return float(np.median(ms[1:])) if len(ms) > 1 else float("nan")


def studies_phase(card):
    """The studies (``scripts/soak_flagship.py``, ``scripts/measure_*.py``,
    ``experiments/distillation``) through their ``main(argv)`` on the card,
    at full width and a reduced length: the soak's split run resumed bit for
    bit with cuDNN pinned (and, read without the pin first, the largest
    param difference and its leaf), its EMA within the script's bound; K2
    in every train_rag process (1 forward and 8 of each backward kernel a
    step, against the steps taken); K1 in the long-form run (20 a window at
    ddim20, the random baseline included); every FGD, recall and seam
    ratio finite. Prints each study's wall seconds. Returns (K1's launches,
    K2's by kernel)."""
    from livelyspeaker_tpu_torch.data import TedWindowDataset
    from livelyspeaker_tpu_torch.experiments.distillation import distill_rag, \
        measure_distill_quality
    from livelyspeaker_tpu_torch.pipeline import long_form_window_grid
    from livelyspeaker_tpu_torch.scripts import (
        eval_common,
        measure_audio_bf16,
        measure_ema_warmup,
        measure_long_form_seams,
        measure_semantic_payoff,
        measure_semantic_payoff_beat,
        soak_flagship,
    )

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_studies.")
    counts = os.path.join(work, "counts")
    os.makedirs(counts)
    k2_total = {k: 0 for k in ("fwd", "bwd_block", "wgrad", "reduce")}
    walls = {}

    def add(launches):
        for k in k2_total:
            k2_total[k] += launches[k]

    def finite(tag, values):
        check(all(np.isfinite(v) for v in values), f"{tag}: not finite: {values}")

    try:
        with _counted_train_rag(counts):
            soak = ["--epochs", str(STUDY_EPOCHS), "--n_clips", str(STUDY_CLIPS),
                    "--log_interval", "1", "--fused_train"]
            # the soak's runs without the pin: read, not gated
            a = soak_flagship.parse_args(soak + ["--out", os.path.join(work, "soak_unpinned")])
            t0 = time.perf_counter()
            records = soak_flagship.build_records(a)
            walls["records"] = time.perf_counter() - t0
            spe = len(TedWindowDataset(records)) // TRAIN_BATCH  # steps an epoch
            t0 = time.perf_counter()
            unpinned = soak_flagship.train_runs(a, records, cudnn_deterministic=False)
            walls["soak_unpinned_runs"] = time.perf_counter() - t0
            unpinned_ms = _median_step_ms(unpinned["full_dir"])
            print(f"[studies] soak without the cuDNN pin: full against split and resumed, "
                  f"max |param diff| {unpinned['max_delta']:.3e} at {unpinned['leaf']}, "
                  f"bit-exact {unpinned['max_delta'] == 0.0}; full run step "
                  f"{unpinned_ms:.2f} ms median ({card})")
            add(_check_k2_counts("soak unpinned", _train_counts(counts), spe,
                                 2 * STUDY_EPOCHS * spe))

            # the soak as its main runs it: pinned, gated
            out_dir = os.path.join(work, "soak")
            os.makedirs(out_dir)
            os.symlink(records, os.path.join(out_dir, "records_ted"))
            t0 = time.perf_counter()
            try:
                res = soak_flagship.main(soak + ["--out", out_dir])
            except AssertionError as e:
                check(False, f"soak_flagship: {e}")
            walls["soak_flagship"] = time.perf_counter() - t0
            pinned_ms = _median_step_ms(os.path.join(out_dir, "full"))
            print(f"[studies] soak_flagship --fused_train ({STUDY_EPOCHS} epochs of {spe} steps "
                  f"at B={TRAIN_BATCH}, split at {STUDY_EPOCHS // 2}, cuDNN pinned): "
                  f"{json.dumps(res)}; full run step {pinned_ms:.2f} ms median against "
                  f"{unpinned_ms:.2f} unpinned ({card})")
            check(res["resume_bit_exact"], "soak: the resume is not bit-exact")
            finite("soak", [res["fgd_raw"], res["fgd_ema"]])
            add(_check_k2_counts("soak", _train_counts(counts), spe, 2 * STUDY_EPOCHS * spe))

            short = ["--epochs", "2", "--n_clips", str(STUDY_CLIPS), "--log_interval", "1"]
            for tag, module, keys in (
                    ("measure_ema_warmup", measure_ema_warmup,
                     ["fgd_raw_plain", "fgd_ema_plain", "fgd_raw_warmup", "fgd_ema_warmup"]),
                    ("measure_audio_bf16", measure_audio_bf16,
                     ["final_loss_f32", "final_loss_bf16", "fgd_f32", "fgd_bf16"])):
                d = os.path.join(work, tag)
                os.makedirs(d)
                os.symlink(records, os.path.join(d, "records"))
                t0 = time.perf_counter()
                res = module.main(short + ["--out", d])
                walls[tag] = time.perf_counter() - t0
                print(f"[studies] {tag} (2 epochs of {spe} steps at B={TRAIN_BATCH}, fused): "
                      f"{json.dumps(res)} ({card})")
                finite(tag, [res[k] for k in keys])
                add(_check_k2_counts(tag, _train_counts(counts), spe, 2 * 2 * spe))

        # long form on the soak's trained checkpoint, K1 at ddim20
        n_windows = long_form_window_grid(LONG_FORM_SECONDS * 16000, 34, 4)[0]
        res, c, secs = _counted(lambda: measure_long_form_seams.main(
            ["--model_path", eval_common.final_npz(os.path.join(out_dir, "full")),
             "--seconds", str(LONG_FORM_SECONDS), "--respacing", "ddim20", "--fused"]))
        walls["measure_long_form_seams"] = secs
        want = 20 * n_windows * 2  # the trained model and the random baseline
        print(f"[studies] measure_long_form_seams --fused over {LONG_FORM_SECONDS} s "
              f"({n_windows} windows, ddim20): {json.dumps(res, sort_keys=True)}; K1 launches "
              f"{c['k1']} (want {want}), plain {c['k1_plain']} ({card})")
        check(c["k1"] == want and c["k1_plain"] == 0, f"long form: K1 {c['k1']}, want {want}")
        for rep in (res["trained"], res["random_baseline"]):
            check(rep["n_seams"] == n_windows - 1, f"long form: {rep['n_seams']} seams")
            finite("long form", [rep[k] for k in ("ratio_p95", "seam_mean", "within_mean")])
        k1 = c["k1"]

        semantic = ["--rag_steps", "20", "--sag_steps", "20", "--samples_per_window", "1"]
        for tag, module, metrics in (
                ("measure_semantic_payoff", measure_semantic_payoff,
                 ["mode_recall", "fgd", "cond_fgd_mean"]),
                ("measure_semantic_payoff_beat", measure_semantic_payoff_beat,
                 ["mode_recall", "srgr", "fid", "cond_fid_mean"])):
            res, c, secs = _counted(lambda: module.main(semantic))
            walls[tag] = secs
            print(f"[studies] {tag} (latent 512, 8 blocks, clip_layers 4, 20 RAG and 20 SAG "
                  f"steps at batch 64, ddim100, skip 80): {json.dumps(res)} ({card})")
            finite(tag, [res["header"][k] for k in ("classifier_acc_on_real", "sketch_recall",
                                                    "x0hat_recall_at_boundary")]
                   + [r[k] for r in res["rows"] for k in metrics])
            check(c["k1"] == 0 and c["k2"]["fwd"] == 0, f"{tag}: the unfused path ran a kernel")

        t0 = time.perf_counter()
        res = distill_rag.main(["--model_path", eval_common.final_npz(os.path.join(out_dir, "full")),
                                "--data_dir", records, "--save_dir", os.path.join(work, "distill"),
                                "--rounds", "1", "--steps_per_round", "3", "--log_interval", "1"])
        walls["distill_rag"] = time.perf_counter() - t0
        print(f"[studies] distill_rag (latent 512, 1 round of 3 steps at batch 128): "
              f"{json.dumps(res)} ({card})")
        check(all(os.path.exists(p) for p in res["students"]), "distill_rag: no student npz")
        t0 = time.perf_counter()
        res = measure_distill_quality.main(["--train_steps", "10", "--distill_steps", "5"])
        walls["measure_distill_quality"] = time.perf_counter() - t0
        print(f"[studies] measure_distill_quality (latent 256, 4 blocks, 10 teacher steps, 2 "
              f"rounds of 5): {json.dumps(res)} ({card})")
        finite("measure_distill_quality", [r["fgd"] for r in res["rows"]])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("[studies] wall s: " + " ".join(f"{k}={v:.2f}" for k, v in walls.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return k1, k2_total


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile a serving burst, 3 composed batches and 3 steps of "
                             "each training run, writing the traces and tables to DIR")
    args = parser.parse_args()
    card = device_phase()
    build_phase()
    worst_abs, k1 = kernel_phase(card)
    bf16_worst, bf16, bf16_launches = bf16_kernel_phase(card)
    launches = serving_phase(card, args.profile)
    beat_phase()
    launches += composition_phase(card, args.profile)
    launches += front_end_phase(card)
    grouped_worst, grouped = grouped_swiglu_phase(card)
    tower = tower_phase(card)
    train_worst, train_times = train_kernel_phase(card)
    train_launches, _, model, loop, train_stats = train_phase(card)
    dp_k1, dp_k2 = data_parallel_phase(card)
    launches += dp_k1
    for k, n in dp_k2.items():
        train_launches[k] += n
    for k, n in multihost_phase(card).items():
        train_launches[k] += n
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh.")
    try:
        pipeline_phase(card, work, fsdp_phase(card, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tensor_parallel_phase(card)
    launches += records_train_phase(card, train_stats)["eval"]["launches"]
    records_build_phase(card)
    wav_worst, wav_times = wav_kernel_phase(card)
    _, wav_launches, wav_model, wav_loop, _ = train_phase(card, wav_kernels=True, beside=train_stats)
    fused_vs_eager_train_phase()
    wav_sampler_phase()
    measure_launches, bench_train_launches = measure_phase(card, args.profile)
    launches += measure_launches + generate_phase(card)
    for k, n in bench_train_launches.items():
        train_launches[k] += n
    studies_k1, studies_k2 = studies_phase(card)
    launches += studies_k1
    for k, n in studies_k2.items():
        train_launches[k] += n
    if args.profile:
        wgrad_library_probe(card, args.profile)
        profile_phase(model, loop, args.profile, card)
        profile_phase(wav_model, wav_loop, args.profile, card, name="train_step_k3")
    # library_ms: the grouped SwiGLU's is the per-expert cuBLAS loop the
    # tower ran before it (three F.linear an expert); one torch.matmul
    # computes the K2 weight-gradient kernel's
    # product, one torch.sum each reduce kernel's sums, and torch.var_mean
    # (then an rsqrt of B*C values) K3's statistics kernel's; no single
    # PyTorch call computes any other of these functions (8-block mixer
    # stacks and their backward; K3's in_bwd, and its convs over an
    # InstanceNorm and a LeakyReLU: cuDNN's forward conv, weight and data
    # gradients, printed beside K3's, skip the InstanceNorm, the LeakyReLU
    # and conv0; K3's stats0 and wgrad0, which recompute conv0 and go
    # through IN0: F.conv1d then torch.var_mean, and cuDNN's conv0 weight
    # and data gradient on a materialised g_m0, printed beside them, are
    # two or more calls each)
    kernels = [{
        "name": "fused_transmlp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst_abs, **k1, "library_ms": None,
    }, {
        "name": "fused_transmlp_bf16", "route": "cuda", "source": BF16_SOURCE,
        "replaces": BF16_REPLACES, "launches": bf16_launches,
        "max_abs_err": bf16_worst, **bf16, "library_ms": None,
    }]
    kernels.append({
        "name": "grouped_swiglu", "route": "cuda", "source": GROUPED_SOURCE,
        "replaces": None, "launches": tower["launches"],
        "launches_of": "one Moonlight tower call", "tower": tower,
        "max_abs_err": grouped_worst, **grouped["routed"], "by_group": grouped,
    })
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
    from livelyspeaker_tpu_torch.ops.fused_wav import FORWARD_LAUNCHES as k3_forward

    for k in wav_launches:
        fwd = k in k3_forward
        kernels.append({
            "name": f"fused_wav_{k}", "route": "cuda", "source": WAV_SOURCE,
            "replaces": WAV_REPLACES, "launches": wav_launches[k],
            "max_abs_err": wav_worst["fwd" if fwd else "bwd"], "ms": wav_times["ms"][k],
            "plain_ms": wav_times["plain_fwd" if fwd else "plain_bwd"],
            "bound_ms": wav_times["bound"][k][0], "bound_by": wav_times["bound"][k][1],
            "library_ms": wav_times["library"].get(k),
        })
    print(json.dumps({"kernels": kernels}))
    print(f"[device] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
