"""K1's bf16 kernel alone, on the card, against another checkout's build.

    python3 k1_bf16.py [--other DIR] [--phases]

Builds ``csrc/fused_transmlp_bf16.cu`` and, at TED (S=35, F=27) and BEAT
(S=36, F=282), D=512, L=8, LN2 folded, pose projection on, 2B in {16,
512}: holds the kernel against its plain bf16 version (``BF16_TOL`` of
max|plain|), then times it with CUDA events in turns beside the f32 kernel
on the same weights, and prints each time's share of the bf16 bound and
the L2 weight bytes a call (every cluster reads all of ``ch_w`` and
``out_w``), with the card's name and power limit.

``--other DIR`` also builds ``DIR/livelyspeaker_tpu_torch/csrc/
fused_transmlp_bf16.cu`` (a checkout of another commit, unpacked with
``git archive`` into a gitignored directory) into ``csrc/_build/k1_bf16/``,
holds it against the plain version too and times it in the same turns
(this, other, f32, f32, other, this, ...). Each build is called with its
own signature: one without ``fused_transmlp_bf16_max_clusters`` is the
one-CTA-a-sequence kernel, launched with no cluster or group.

``--phases`` instead builds an instrumented copy of the shipped source into
``csrc/_build/k1_bf16/`` (text patches; the anchors must match the source,
``tests/test_torch_fused_mlp_bf16.py`` checks them here): thread 0 of
every CTA adds ``clock64`` deltas between the phase boundaries of each
layer into a record of its CTA, and inside the ring product splits the
waits for a tile, the wgmma and the releases. It runs TED's serving layout
(LN2 folded, F=27) at the geometry's choices for 2B in {16, 512} and
prints the mean cycles a CTA a layer by phase and the time a launch. Each
clock read adds a global read-modify-write to thread 0's path (the ring's
three a chunk most): compare phases with each other, not with the turns.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from livelyspeaker_tpu_torch.models.initializers import random_normal_  # noqa: E402
from livelyspeaker_tpu_torch.models.mlp_backbone import TransMLP  # noqa: E402
from livelyspeaker_tpu_torch.ops import fused_mlp  # noqa: E402
from livelyspeaker_tpu_torch.ops._build import (  # noqa: E402
    BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc, build_log, load_libraries)

OUT_DIR = BUILD_DIR / "k1_bf16"

PHASES = ["x + emb, parameters", "LN1 statistics: local", "LN1 statistics: cluster barrier",
          "LN1 statistics: combine", "LN1 rows, token_w", "token mix", "pose projection",
          "LN2 statistics: local", "LN2 statistics: cluster barrier", "LN2 statistics: combine",
          "LN2 rows: push", "LN2 rows: cluster barrier", "channel mix and epilogue",
          "ring: wait for a tile", "ring: wgmma", "ring: release"]
_PROF = ("#define PROF(i) do { if (threadIdx.x == 0) { long long _t = clock64(); "
         "c.p.prof[blockIdx.x * 16 + (i)] += _t - prof_tl; prof_tl = _t; } } while (0)\n"
         "#define QPROF(i) do { if (threadIdx.x == 0) { long long _t = clock64(); "
         "c.p.prof[blockIdx.x * 16 + (i)] += _t - _q; _q = _t; } } while (0)\n")
# (anchor in the shipped source, text put in its place); each anchor is found once
PATCHES = [
    ("  int B, S, D, L, F, N, G;\n};", "  int B, S, D, L, F, N, G;\n  long long* prof;\n};\n"
     "long long* g_prof = nullptr;  // set through k1_bf16_set_prof before a launch\n"
     "__shared__ long long prof_tl;\n" + _PROF),
    ("  if (tid < kMaxStages) {\n    mbar_init(&c.full[tid], 1);",
     "  if (tid == 0) prof_tl = clock64();\n  if (tid < kMaxStages) {\n    mbar_init(&c.full[tid], 1);"),
    ("    cp_async_wait<0>();  // this layer's parameters\n    __syncthreads();\n",
     "    cp_async_wait<0>();  // this layer's parameters\n    __syncthreads();\n    PROF(0);\n"),
    ("      *reinterpret_cast<float2*>(dst + (c.rank * rows + i) * 2) = make_float2(mean, v);\n"
     "    }\n  }\n  cg::this_cluster().sync();\n",
     "      *reinterpret_cast<float2*>(dst + (c.rank * rows + i) * 2) = make_float2(mean, v);\n"
     "    }\n  }\n  PROF(1 + 6 * which);\n  cg::this_cluster().sync();\n  PROF(2 + 6 * which);\n"),
    ("    c.inv[i] = rsqrtf(__fadd_rn(__fdiv_rn(m2, (float)c.p.D), kEps));\n  }\n  __syncthreads();\n",
     "    c.inv[i] = rsqrtf(__fadd_rn(__fdiv_rn(m2, (float)c.p.D), kEps));\n  }\n  __syncthreads();\n"
     "  PROF(3 + 6 * which);\n"),
    ("    __syncthreads();\n    issue_params(c, l + 1);",
     "    __syncthreads();\n    PROF(4);\n    issue_params(c, l + 1);"),
    ("    __syncthreads();\n    // LN2: statistics", "    __syncthreads();\n    PROF(5);\n    // LN2: statistics"),
    ("    push_rows(c, true, affine ? g2 : nullptr, affine ? b2 : nullptr);\n    cg::this_cluster().sync();\n",
     "    push_rows(c, true, affine ? g2 : nullptr, affine ? b2 : nullptr);\n    PROF(10);\n"
     "    cg::this_cluster().sync();\n    PROF(11);\n"),
    ("                         pass, cb, l + 1 < p.L);\n    __syncthreads();\n",
     "                         pass, cb, l + 1 < p.L);\n    __syncthreads();\n    PROF(12);\n"),
    ("                         false);\n  } else {", "                         false);\n    PROF(6);\n  } else {"),
    ("    mbar_wait(&c.full[s], (uint32_t)((u / c.stages) & 1));\n    __syncwarp();\n",
     "    mbar_wait(&c.full[s], (uint32_t)((u / c.stages) & 1));\n    __syncwarp();\n    QPROF(13);\n"),
    ("  fence_acc(acc);\n  for (int j = 0; j < c.kc; ++j) {",
     "  fence_acc(acc);\n  long long _q = clock64();\n  for (int j = 0; j < c.kc; ++j) {"),
    ("    wgmma_wait<1>();  // the previous chunk's; this one's stays in flight\n"
     "    if (j > 0) release_tile(c, u - 1);\n",
     "    wgmma_wait<1>();  // the previous chunk's; this one's stays in flight\n    QPROF(14);\n"
     "    if (j > 0) release_tile(c, u - 1);\n    QPROF(15);\n"),
    ("           static_cast<bf16*>(out), B, S, D, L, proj ? F : 0, cluster, group};",
     "           static_cast<bf16*>(out), B, S, D, L, proj ? F : 0, cluster, group, g_prof};"),
]


def instrumented_source():
    """The shipped bf16 source with ``PATCHES`` applied and a setter of the
    record pointer; raises SystemExit when an anchor is not found once."""
    src = (CSRC_DIR / "fused_transmlp_bf16.cu").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"k1_bf16: anchor not found once in fused_transmlp_bf16.cu: "
                             f"{anchor!r}")
        src = src.replace(anchor, text)
    return src + '\nextern "C" void k1_bf16_set_prof(long long* p) { g_prof = p; }\n'


def phases(card):
    """Cycles a CTA a layer by phase, at the geometry's choices for TED 2B
    in {16, 512}, from an instrumented build of the shipped source."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / "phases.cu", OUT_DIR / "libphases.so"
    cu.write_text(instrumented_source())
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"k1_bf16: nvcc failed on the instrumented source:\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_transmlp_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k1_bf16_set_prof.argtypes = [ctypes.c_void_p]
    dev, bf16, layers = torch.device("cuda"), torch.bfloat16, 8
    g = torch.Generator().manual_seed(12)
    stack = random_normal_(TransMLP(35, layers, 512, "silu"), g).to(dev)
    pose = random_normal_(torch.nn.Linear(512, 27), g).to(dev)
    packed = fused_mlp.pack_transmlp_params(stack, fold_ln2=True, dtype=bf16)
    op = fused_mlp.pack_out_proj(pose, dtype=bf16)
    ptr = lambda k: packed[k].data_ptr() if k in packed else None
    for b2 in (16, 512):
        geo = fused_mlp.transmlp_bf16_geometry(b2, 35, 512,
                                               fused_mlp.bf16_resident_clusters(512, dev))
        x = torch.randn(b2, 35, 512, generator=g).to(dev).to(bf16)
        emb = torch.randn(b2, 512, generator=g).to(dev).to(bf16)
        out = torch.empty(b2, 35, 27, dtype=bf16, device=dev)
        ctas = geo.clusters * geo.cluster
        prof = torch.zeros(ctas * 16, dtype=torch.int64, device=dev)
        lib.k1_bf16_set_prof(prof.data_ptr())

        def launch():
            err = fn(x.data_ptr(), emb.data_ptr(), ptr("ln1_scale"), ptr("ln1_bias"),
                     ptr("token_w"), ptr("token_b"), None, None, ptr("ch_w"), ptr("ch_b"),
                     op["out_w"].data_ptr(), op["out_b"].data_ptr(), out.data_ptr(), b2, 35, 512,
                     layers, 27, 0, geo.cluster, geo.group,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"instrumented launch failed with cudaError {err}")

        launch()
        torch.cuda.synchronize()
        prof.zero_()
        ms = chip_smoke.time_ms(launch, 5)
        reps = 5 + 3  # time_ms's warm-up calls count too
        cyc = prof.view(ctas, 16).double().mean(0).cpu().numpy() / reps / layers
        print(f"[k1_bf16] phases, TED 2B={b2} folded F=27 at ({geo.cluster}, {geo.group}): "
              f"{ms:.4f} ms a launch instrumented; mean cycles a CTA a layer (thread 0): "
              + ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, cyc)) + f" ({card})")


def build_other(checkout):
    """The ctypes library of ``checkout``'s bf16 kernel, built with its own
    headers."""
    csrc = Path(checkout).resolve() / "livelyspeaker_tpu_torch" / "csrc"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / f"lib{Path(checkout).resolve().name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{csrc}", "-o", str(so),
                           str(csrc / "fused_transmlp_bf16.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"k1_bf16: nvcc failed on {csrc}:\n{proc.stdout[-4000:]}"
                         f"{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(so))


def other_call(lib):
    """(fn(x, emb, packed, op) -> bf16 out through another build, with its
    own signature and, where it has one, this checkout's geometry; whether
    it takes a cluster)."""
    fn = lib.fused_transmlp_bf16_launch
    clustered = hasattr(lib, "fused_transmlp_bf16_max_clusters")
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * (8 if clustered else 6) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, emb, packed, op):
        b, s, d = x.shape
        f = op["out_w"].shape[0]
        out = torch.empty(b, s, f, dtype=torch.bfloat16, device=x.device)
        ints = [b, s, d, packed["token_w"].shape[0], f, 0]
        if clustered:
            geo = fused_mlp.transmlp_bf16_geometry(
                b, s, d, fused_mlp.bf16_resident_clusters(d, x.device))
            ints += [geo.cluster, geo.group]
        ptr = lambda k: packed[k].data_ptr() if k in packed else None
        err = fn(x.data_ptr(), emb.data_ptr(), ptr("ln1_scale"), ptr("ln1_bias"),
                 ptr("token_w"), ptr("token_b"), ptr("ln2_scale"), ptr("ln2_bias"),
                 ptr("ch_w"), ptr("ch_b"), op["out_w"].data_ptr(), op["out_b"].data_ptr(),
                 out.data_ptr(), *ints, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch of another build failed with cudaError {err}")
        return out

    return call, clustered


def weight_bytes(clusters, packed, op):
    """L2 reads of the weight matrices a call: each cluster reads all of
    ``ch_w`` and ``out_w`` once."""
    return clusters * (packed["ch_w"].numel() + op["out_w"].numel()) * 2


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", metavar="DIR",
                        help="also time DIR's fused_transmlp_bf16.cu in the same turns")
    parser.add_argument("--phases", action="store_true",
                        help="instead count cycles by phase in an instrumented build")
    args = parser.parse_args()
    card = chip_smoke.device_phase()
    load_libraries(["fused_transmlp", "fused_transmlp_bf16"])
    for line in build_log("fused_transmlp_bf16").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] fused_transmlp_bf16: {line.strip()}")
    if args.phases:
        phases(card)
        return
    other, clustered = other_call(build_other(args.other)) if args.other else (None, False)
    other_name = Path(args.other).resolve().name if args.other else None
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    bf16 = torch.bfloat16
    for name, seq, feats in (("TED", 35, 27), ("BEAT", 36, 282)):
        stack = random_normal_(TransMLP(seq, 8, 512, "silu"), g).to(dev)
        pose = random_normal_(torch.nn.Linear(512, feats), g).to(dev)
        p16 = fused_mlp.pack_transmlp_params(stack, fold_ln2=True, dtype=bf16)
        o16 = fused_mlp.pack_out_proj(pose, dtype=bf16)
        p32 = fused_mlp.pack_transmlp_params(stack, fold_ln2=True)
        o32 = fused_mlp.pack_out_proj(pose)
        for b2 in (16, 512):
            x = torch.randn(b2, seq, 512, generator=g).to(dev)
            emb = torch.randn(b2, 512, generator=g).to(dev)
            xb, eb = x.to(bf16), emb.to(bf16)
            ref = fused_mlp.fused_transmlp_reference(xb, eb, p16, out_proj=o16).float()
            runs = {"this": lambda: fused_mlp.fused_transmlp(xb, eb, p16, out_proj=o16)}
            if other is not None:
                runs[other_name] = lambda: other(xb, eb, p16, o16)
            for k, fn in runs.items():
                err = (fn().float() - ref).abs().max().item() / ref.abs().max().item()
                chip_smoke.check(err <= chip_smoke.BF16_TOL,
                                 f"k1_bf16: {k} disagrees with the plain version: rel {err:.3e}")
            runs["f32 kernel"] = lambda: fused_mlp.fused_transmlp(x, emb, p32, out_proj=o32)
            times = chip_smoke.time_turns(runs, 20 if b2 <= 16 else 5, rounds=4)
            flop, nbytes = chip_smoke.k1_cost(xb, eb, p16, o16)
            bound_ms, bound_by = chip_smoke.bound(flop, nbytes, chip_smoke.PEAK_BF16)
            geo = fused_mlp.transmlp_bf16_geometry(
                b2, seq, 512, fused_mlp.bf16_resident_clusters(512, dev))
            l2 = {"this": weight_bytes(geo.clusters, p16, o16)}
            if other is not None:
                l2[other_name] = weight_bytes(geo.clusters if clustered else b2, p16, o16)
            print(f"[k1_bf16] {name} 2B={b2} S={seq} F={feats} folded: bound {bound_ms:.4f} ms "
                  f"({bound_by}); " + "; ".join(
                      f"{k} {t:.4f} ms ({bound_ms / t:.1%} of the bound"
                      + (f", L2 weight reads {l2[k] / 1e9:.3f} GB a call)" if k in l2 else ")")
                      for k, t in times.items())
                  + f"; this build's geometry ({geo.cluster}, {geo.group}) ({card})")


if __name__ == "__main__":
    main()
