"""Where the time of K2's backward block kernel goes inside one launch, by
phase, on the card.

Builds ``livelyspeaker_tpu_torch/csrc/fused_transmlp_train.cu`` once more with
``-DK2_PHASES`` into ``csrc/_build/k2_phases/`` (the shipped build has none of
the instrumentation): thread 0 of every CTA reads ``clock64`` at the phase
boundaries and adds the cycles into a per-CTA record; inside the two
products it also splits its own time into ring waits, FMAs and the
arrive-and-refill step.

It runs one layer's launch (the last block of an 8-block TED stack, S=35,
D=512, silu) at B in {64, 512} and clusters of 8 and 4, checks the result
against the shipped kernel's (the same bits), and prints the mean cycles per
CTA by phase and the time per launch (CUDA events), with the card's name
and power limit. The clock reads cost a few percent; compare phases with
each other, not with ``chip_smoke.py``'s times. Run on the card:
``python3 k2_phases.py``.
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
from livelyspeaker_tpu_torch.ops import fused_mlp_train as k2  # noqa: E402
from livelyspeaker_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

OUT_DIR = CSRC_DIR / "_build" / "k2_phases"
# (counter, phase), in the order they run; 15-17 are thread 0's own split of
# the two products
PHASES = [(18, "barriers, first tiles"),
          (0, "parameters, whole rows of x, LN1 statistics, a = x + emb"),
          (1, "xhat1, h1"), (2, "token mix"), (3, "LN2 statistics (the start barrier's wait; barrier)"),
          (4, "xhat2, h2 store and gather (barrier)"), (5, "product 1: h2 @ ch_w"),
          (19, "epilogue 1: K-slice sums, g_m2"), (6, "epilogue 1: barrier"), (7, "g_m2 gather, d ch_b (barrier)"),
          (8, "product 2: g_m2 @ ch_w^T"), (9, "epilogue 2: K-slice sums"),
          (10, "LN2 backward sums, d ln2 (barrier)"), (11, "g_r1, g_m1, h1"),
          (20, "d token_w, d token_b"), (12, "g_h1"), (13, "LN1 backward sums, d ln1 (barrier)"),
          (14, "g_a, token-gradient sums, d emb")]
INSIDE = [(15, "ring waits"), (16, "FMAs"), (17, "arrive + refill")]
RECORD = 24  # counters a CTA (kPhases in the source)
SEQ, DIM, LAYERS = 35, 512, 8
BATCHES, CLUSTERS = (64, 512), (8, 4)


def build():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / "libk2_phases.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-DK2_PHASES", "-o", str(so),
           str(CSRC_DIR / "fused_transmlp_train.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"k2_phases: nvcc failed:\n{proc.stdout[-4000:]}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_transmlp_train_bwd_block_launch.argtypes = (
        [p] * 5 + [i] + [p] * 12 + [i] * 5 + [p] * 2)
    return lib


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
        raise SystemExit("k2_phases: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lib = build()
    shipped = k2._launcher("bwd_block")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stack = random_normal_(TransMLP(SEQ, LAYERS, DIM, "silu"), g).to(dev)
    with torch.no_grad():
        packed = {k: v.contiguous() for k, v in k2.pack_transmlp_train_params(stack).items()}
    cw_t = packed["ch_w"].transpose(1, 2).contiguous()
    layer = LAYERS - 1
    at = lambda t: t[layer].data_ptr()

    print(f"[k2-phases] {card}; one launch of the backward block kernel (layer {layer} of "
          f"{LAYERS}), TED S={SEQ} D={DIM} silu; mean cycles per CTA (thread 0's clock64)")
    for b in BATCHES:
        x = torch.randn(b, SEQ, DIM, generator=g).to(dev)
        emb = torch.randn(b, DIM, generator=g).to(dev)
        cot = torch.randn(b, SEQ, DIM, generator=g).to(dev)
        _, stash = k2.fused_transmlp_train_forward(x, emb, packed)
        part = torch.empty(b, 5 * DIM + SEQ + SEQ * SEQ, device=dev)

        bufs = [torch.empty_like(cot), torch.empty_like(emb), torch.empty_like(cot),
                torch.empty_like(cot), part]  # g_a, d emb, h2, g_m2, part

        def launch(fn, n, *extra):
            gx, gemb, h2, gm2, _ = bufs
            err = fn(at(stash), emb.data_ptr(), cot.data_ptr(), gx.data_ptr(), gemb.data_ptr(), 1,
                     *[at(packed[k]) for k in k2.PACKED_KEYS[:7]], at(cw_t), at(packed["ch_b"]),
                     h2.data_ptr(), gm2.data_ptr(), part.data_ptr(), b, SEQ, DIM, 0, n,
                     torch.cuda.current_stream().cuda_stream, *extra)
            if err != 0:
                raise SystemExit(f"k2_phases: launch failed with cudaError {err}")

        for n in CLUSTERS:
            prof = torch.zeros(b * n * RECORD, dtype=torch.int64, device=dev)
            launch(lib.fused_transmlp_train_bwd_block_launch, n, prof.data_ptr())
            got = [t.clone() for t in bufs]
            launch(shipped, n)
            torch.cuda.synchronize()
            if not all(torch.equal(a, r) for a, r in zip(got, bufs)):
                raise SystemExit("k2_phases: the instrumented kernel disagrees with the shipped one")
            cyc = prof.view(-1, RECORD).double().mean(0).tolist()
            spare = torch.zeros_like(prof)
            ms = time_ms(lambda: launch(lib.fused_transmlp_train_bwd_block_launch, n,
                                        spare.data_ptr()), 10)
            plain = time_ms(lambda: launch(shipped, n), 10)
            print(f"[k2-phases] B={b} N={n}: {ms:.4f} ms a launch ({plain:.4f} without the clock "
                  f"reads), {sum(cyc[i] for i, _ in PHASES):.0f} cycles a CTA; "
                  + ", ".join(f"{k} {cyc[i]:.0f}" for i, k in PHASES) + "; inside the products: "
                  + ", ".join(f"{k} {cyc[i]:.0f}" for i, k in INSIDE))
    print(f"[k2-phases] done ({card})")


if __name__ == "__main__":
    main()
