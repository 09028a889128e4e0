"""Where K1's time goes inside one launch, by phase, on the card.

Builds an instrumented copy of ``livelyspeaker_tpu_torch/csrc/fused_transmlp.cu``
into ``csrc/_build/k1_phases/`` (the shipped source is not touched): thread 0
of every CTA reads ``clock64`` at the phase boundaries of each layer and adds
the cycles into a per-CTA record. Three builds, started together:

- ``as-is``: the kernel as shipped;
- ``no-product``: the channel mix's and the pose projection's wgmma left out
  (the weight stream, the loads and splits of the fragments, the partial
  sums' exchange and the epilogue alone);
- ``no-wait``: the compute warps do not wait for the weight ring's copies
  (the product on whatever the ring holds: the wgmma and the fragments'
  loads without the stream's stalls; the producer still streams).

It runs TED's serving layout (S=35, D=512, L=8, LN2 folded, pose F=27) at
2B in {2, 16, 512} on clusters of every size D=512 allows, and prints the
mean cycles per CTA by phase and the time per launch (CUDA events), with the
card's name and power limit. Thread 0 is in the first compute warpgroup; the
clock reads and the record's global adds cost a few percent, so compare the
variants with each other, not with ``chip_smoke.py``'s times. Run on the
card: ``python3 k1_phases.py``.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from livelyspeaker_tpu_torch.models.initializers import random_normal_  # noqa: E402
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP  # noqa: E402
from livelyspeaker_tpu_torch.ops import fused_mlp  # noqa: E402
from livelyspeaker_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

OUT_DIR = CSRC_DIR / "_build" / "k1_phases"
PHASES = ["emb + parameters", "LN1 statistics", "LN1 + token mix", "LN2 statistics",
          "LN2 rows", "channel mix: passes", "channel mix: own partials staged",
          "channel mix: partials' barrier", "channel mix: epilogue", "end of layer",
          "pose projection / store"]
RECORD = 16  # counters a CTA; the last holds thread 0's previous clock read
B2S = (2, 16, 512)  # batches (2B)

# (anchor in the source, text put in its place); every anchor must be found once
PATCHES = [
    ("  int S, D, L, F, N;\n};", "  int S, D, L, F, N;\n  long long* prof;\n};\n"
     "long long* g_prof = nullptr;  // set through k1_phases_set before a launch\n"
     "__device__ __forceinline__ void prof_mark(const ClusterParams& p, int i) {\n"
     "  if (threadIdx.x == 0) {\n    long long* r = p.prof + blockIdx.x * 16;\n"
     "    const long long t = clock64();\n    r[i] += t - r[15];\n    r[15] = t;\n  }\n}"),
    ("  if (tid < kMaxStages) {\n    mbar_init",
     "  if (tid == 0) p.prof[blockIdx.x * 16 + 15] = clock64();\n"
     "  if (tid < kMaxStages) {\n    mbar_init"),
    ("    mbar_wait(&c.full[kMaxStages + l % 2], (uint32_t)((l / 2) & 1));\n    __syncthreads();\n",
     "    mbar_wait(&c.full[kMaxStages + l % 2], (uint32_t)((l / 2) & 1));\n    __syncthreads();\n"
     "    prof_mark(p, 0);\n"),
    ("    row_stats(c, c.x_s, 0);\n", "    row_stats(c, c.x_s, 0);\n    prof_mark(p, 1);\n"),
    ("    token_mix_cols<kAct>(c, h_s, tw, tb);\n    __syncthreads();\n",
     "    token_mix_cols<kAct>(c, h_s, tw, tb);\n    __syncthreads();\n    prof_mark(p, 2);\n"),
    ("    row_stats(c, c.x_s, 1);\n", "    row_stats(c, c.x_s, 1);\n    prof_mark(p, 3);\n"),
    ("\n    channel_mix<kAct>(c, l, cb);\n    __syncthreads();\n",
     "\n    prof_mark(p, 4);\n    channel_mix<kAct>(c, l, cb);\n    prof_mark(p, 8);\n"
     "    __syncthreads();\n    prof_mark(p, 9);\n"),
    ("  __syncthreads();  // every product is done with the B rows\n",
     "  prof_mark(c.p, 5);\n  __syncthreads();  // every product is done with the B rows\n"),
    ("  cg::this_cluster().sync();  // every CTA's partials of this CTA's columns are in\n",
     "  prof_mark(c.p, 6);\n"
     "  cg::this_cluster().sync();  // every CTA's partials of this CTA's columns are in\n"
     "  prof_mark(c.p, 7);\n"),
    ("    pose_projection(c, p.out + c.seq * S * p.F);\n",
     "    pose_projection(c, p.out + c.seq * S * p.F);\n    prof_mark(p, 10);\n"),
    ("    wgmma_tf32(d, f.lo + 4 * kk, bh, kk == 0 ? 0 : 1);\n"
     "    wgmma_tf32(d, f.hi + 4 * kk, bl, 1);\n    wgmma_tf32(d, f.hi + 4 * kk, bh, 1);\n",
     "#ifndef K1_NO_PRODUCT\n    wgmma_tf32(d, f.lo + 4 * kk, bh, kk == 0 ? 0 : 1);\n"
     "    wgmma_tf32(d, f.hi + 4 * kk, bl, 1);\n    wgmma_tf32(d, f.hi + 4 * kk, bh, 1);\n#endif\n"),
    ("    mbar_wait(&c.full[s], (uint32_t)((u / c.lay.stages) & 1));\n",
     "#ifndef K1_NO_WAIT\n    mbar_wait(&c.full[s], (uint32_t)((u / c.lay.stages) & 1));\n#endif\n"),
    ("                  S, D, L, F, cluster};", "                  S, D, L, F, cluster, g_prof};"),
    ("// Dynamic shared memory of one CTA, or 0 for a geometry the kernel refuses.",
     'extern "C" void k1_phases_set(long long* prof) { g_prof = prof; }\n'
     "// Dynamic shared memory of one CTA, or 0 for a geometry the kernel refuses."),
]
VARIANTS = {"as-is": [], "no-product": ["-DK1_NO_PRODUCT"], "no-wait": ["-DK1_NO_WAIT"]}


def instrumented_source():
    src = (CSRC_DIR / "fused_transmlp.cu").read_text()
    for anchor, text in PATCHES:
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
                                              + [ctypes.c_void_p])
        lib.k1_phases_set.argtypes, lib.k1_phases_set.restype = [ctypes.c_void_p], None
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
        lib.k1_phases_set(prof.data_ptr())
        err = lib.fused_transmlp_launch(
            x.data_ptr(), emb.data_ptr(), ptr("ln1_scale"), ptr("ln1_bias"), ptr("token_w"),
            ptr("token_b"), None, None, ptr("ch_w"), ptr("ch_b"), op["out_w"].data_ptr(),
            op["out_b"].data_ptr(), out.data_ptr(), b, 35, 512, 8, 27, 0, n,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"k1_phases: launch failed with cudaError {err}")
        return out

    print(f"[k1-phases] {card}; cycles per CTA over the 8 layers (thread 0's clock64), "
          f"TED S=35 D=512 L=8 LN2 folded, pose F=27")
    for b2 in B2S:
        x = torch.randn(b2, 35, 512, generator=g).to(dev)
        emb = torch.randn(b2, 512, generator=g).to(dev)
        ref = fused_mlp.fused_transmlp_reference(x, emb, packed, out_proj=op)
        for n in fused_mlp.forward_cluster_sizes(512):
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
