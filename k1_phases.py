"""Where K1's time goes inside one launch, by phase, on the card.

Builds an instrumented copy of ``livelyspeaker_tpu_torch/csrc/fused_transmlp.cu``
into ``csrc/_build/k1_phases/`` (the shipped source is not touched): thread 0
of every CTA reads ``clock64`` at the phase boundaries of each layer and adds
the cycles into a per-CTA record. Three builds, started together:

- ``as-is``: the kernel as shipped;
- ``no-product``: the channel mix's FMAs left out (the weight stream, its
  waits and the K-slice sums alone);
- ``no-copy``: the weight ring's TMA copies left out, each stage marked full
  at once (the product on stale data: the FMAs alone).

It runs TED's serving layout (S=35, D=512, L=8, LN2 folded, pose F=27) at
2B in {2, 16, 512} and clusters of 8 and 4, and prints the mean cycles per
CTA by phase and the time per launch (CUDA events), with the card's name and
power limit. The clock reads cost a few percent; compare variants with each
other, not with ``chip_smoke.py``'s times. Run on the card:
``python3 k1_phases.py``.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from livelyspeaker_tpu_torch.models.initializers import random_normal_  # noqa: E402
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP  # noqa: E402
from livelyspeaker_tpu_torch.ops import fused_mlp  # noqa: E402
from livelyspeaker_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

OUT_DIR = CSRC_DIR / "_build" / "k1_phases"
PHASES = ["emb + parameters", "LN1 statistics", "LN1 + token mix", "LN2 statistics",
          "LN2 rows exchange", "channel mix: ring waits", "channel mix: product",
          "channel mix: arrive + refill", "channel mix: K-slice sums", "end of layer",
          "pose projection / store"]
RECORD = 16  # counters a CTA
B2S, NS = (2, 16, 512), (8, 4)  # batches (2B) and cluster sizes

# (anchor in the source, text put in its place); every anchor must be found
PATCHES = [
    ("  int S, D, L, F, N;\n};", "  int S, D, L, F, N;\n  long long* prof;\n};\n"
     "#define PROF(i) do { if (threadIdx.x == 0) { long long _t = clock64(); "
     "p.prof[blockIdx.x * 16 + (i)] += _t - _tl; _tl = _t; } } while (0)"),
    ("  if (tid < kStagesMax) {\n    mbar_init",
     "  long long _tl = clock64();\n  if (tid < kStagesMax) {\n    mbar_init"),
    ("    issue_params(c, l + 1);  // its buffer was last read in layer l - 1\n",
     "    issue_params(c, l + 1);  // its buffer was last read in layer l - 1\n    PROF(0);\n"),
    ("    row_stats(c, c.x_s, 0);\n", "    row_stats(c, c.x_s, 0);\n    PROF(1);\n"),
    ("    token_mix_cols<kAct>(c, h_s, tw, tb);\n    __syncthreads();\n",
     "    token_mix_cols<kAct>(c, h_s, tw, tb);\n    __syncthreads();\n    PROF(2);\n"),
    ("    row_stats(c, c.x_s, 1);\n", "    row_stats(c, c.x_s, 1);\n    PROF(3);\n"),
    ("    channel_mix<kAct>(c, l, cb);\n    __syncthreads();\n",
     "    PROF(4);\n    channel_mix<kAct>(c, l, cb);\n    _tl = clock64();\n"
     "    __syncthreads();\n    PROF(9);\n"),
    ("og[(idx / dc) * D + idx % dc] = c.x_s[idx];\n  }\n}",
     "og[(idx / dc) * D + idx % dc] = c.x_s[idx];\n  }\n  __syncthreads();\n  PROF(10);\n}"),
    # inside the channel mix: thread 0 sums its own steps, written once a layer
    ("  if (t.active) {\n    const SliceRows r(t, c.p.D);",
     "  long long _q = clock64(), _w = 0, _m = 0, _a = 0;\n"
     "  if (t.active) {\n    const SliceRows r(t, c.p.D);"),
    ("      mbar_wait(&c.bars[stage], parity);\n      mma_quads(",
     "      mbar_wait(&c.bars[stage], parity);\n"
     "      { long long _t = clock64(); _w += _t - _q; _q = _t; }\n      MMA mma_quads("),
    ("      arrive_slice(t, &c.bars[kStagesMax + stage]);",
     "      { long long _t = clock64(); _m += _t - _q; _q = _t; }\n"
     "      arrive_slice(t, &c.bars[kStagesMax + stage]);"),
    ("        issue_tile(c, t, r, u + kRing);\n      }\n    }\n  }\n",
     "        issue_tile(c, t, r, u + kRing);\n      }\n"
     "      { long long _t = clock64(); _a += _t - _q; _q = _t; }\n    }\n  }\n"),
    ("    x.w += activate(s.w + b.w, kAct);\n    *xr = x;\n  });\n",
     "    x.w += activate(s.w + b.w, kAct);\n    *xr = x;\n  });\n"
     "  if (threadIdx.x == 0) {\n    long long* pr = c.p.prof + blockIdx.x * 16;\n"
     "    pr[5] += _w; pr[6] += _m; pr[7] += _a; pr[8] += clock64() - _q;\n  }\n"),
    ("  mbar_expect_tx(full, kKt * c.ws * sizeof(float));\n  tma_load_2d(",
     "  COPY mbar_expect_tx(full, kKt * c.ws * sizeof(float));\n  COPY tma_load_2d("),
    ("    float* out, int B, int S, int D, int L, int F, int act, int cluster, void* stream) {",
     "    float* out, int B, int S, int D, int L, int F, int act, int cluster, void* stream,\n"
     "    long long* prof) {"),
    ("                  S, D, L, F, cluster};", "                  S, D, L, F, cluster, prof};"),
    ('#include "transmlp_common.cuh"', '#include "transmlp_common.cuh"\n'
     "#ifdef K1_NO_PRODUCT\n#define MMA if (false)\n#else\n#define MMA\n#endif\n"
     "#ifdef K1_NO_COPY\n#define COPY if (false)\n#else\n#define COPY\n#endif"),
]
# the no-copy build marks each stage full with one plain arrival instead
NO_COPY_ARRIVE = ("  COPY tma_load_2d(",
                  '#ifdef K1_NO_COPY\n  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" '
                  '::"r"(smem_addr(full)) : "memory");\n#endif\n  COPY tma_load_2d(')
VARIANTS = {"as-is": [], "no-product": ["-DK1_NO_PRODUCT"], "no-copy": ["-DK1_NO_COPY"]}


def instrumented_source():
    src = (CSRC_DIR / "fused_transmlp.cu").read_text()
    for anchor, text in PATCHES + [NO_COPY_ARRIVE]:
        if src.count(anchor) != 1:
            raise SystemExit(f"k1_phases: the kernel changed; anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def build():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / "fused_transmlp_phases.cu"
    cu.write_text(instrumented_source())
    procs = {}
    for name, flags in VARIANTS.items():
        so = OUT_DIR / f"lib{name}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", *flags, "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k1_phases: nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.fused_transmlp_launch.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                                              + [ctypes.c_void_p] * 2)
        libs[name] = lib
    return libs


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = build()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stack = random_normal_(TransMLP(35, 8, 512, "silu"), g).to(dev)
    packed = fused_mlp.pack_transmlp_params(stack, fold_ln2=True)
    op = fused_mlp.pack_out_proj(random_normal_(torch.nn.Linear(512, 27), g).to(dev))
    ptr = lambda k: packed[k].data_ptr() if k in packed else None

    def launch(lib, x, emb, n, prof):
        b = x.shape[0]
        out = torch.empty(b, 35, 27, device=dev)
        err = lib.fused_transmlp_launch(
            x.data_ptr(), emb.data_ptr(), ptr("ln1_scale"), ptr("ln1_bias"), ptr("token_w"),
            ptr("token_b"), None, None, ptr("ch_w"), ptr("ch_b"), op["out_w"].data_ptr(),
            op["out_b"].data_ptr(), out.data_ptr(), b, 35, 512, 8, 27, 0, n,
            torch.cuda.current_stream().cuda_stream, prof.data_ptr())
        if err != 0:
            raise SystemExit(f"k1_phases: launch failed with cudaError {err}")
        return out

    print(f"[k1-phases] {card}; cycles per CTA over the 8 layers (thread 0's clock64), "
          f"TED S=35 D=512 L=8 LN2 folded, pose F=27")
    for b2 in B2S:
        x = torch.randn(b2, 35, 512, generator=g).to(dev)
        emb = torch.randn(b2, 512, generator=g).to(dev)
        ref = fused_mlp.fused_transmlp_reference(x, emb, packed, out_proj=op)
        for n in NS:
            for name, lib in libs.items():
                prof = torch.zeros(b2 * n * RECORD, dtype=torch.int64, device=dev)
                out = launch(lib, x, emb, n, prof)
                torch.cuda.synchronize()
                rel = ((out - ref).abs().max() / ref.abs().max()).item()
                cyc = prof.view(-1, RECORD).double().mean(0).tolist()[:len(PHASES)]
                spare = torch.zeros_like(prof)
                ms = time_ms(lambda: launch(lib, x, emb, n, spare), 20 if b2 <= 16 else 5)
                print(f"[k1-phases] 2B={b2} N={n} {name}: {ms:.4f} ms a launch, "
                      f"{sum(cyc):.0f} cycles a CTA"
                      + (f", rel {rel:.1e} against the plain version" if name == "as-is" else "")
                      + "; " + ", ".join(f"{k} {v:.0f}" for k, v in zip(PHASES, cyc)))
                if name == "as-is" and not rel <= 1e-5:
                    raise SystemExit(f"k1_phases: the instrumented kernel disagrees (rel {rel})")
    print(f"[k1-phases] done ({card})")


if __name__ == "__main__":
    main()
