"""K3's data-gradient kernel alone, conv by conv, on the card.

    python3 k3_bwd_data.py [--profile] [--no-recompute] [--phases]

Builds ``csrc/fused_wav.cu`` and, at TED's waveform length (36,267
samples) and B in {8, 512}, times each conv's launches of the data-gradient
kernel (``ops.fused_wav.data_grad``) against cuDNN's data gradient of the
same conv on the same cotangent (``chip_smoke.wav_bwd_data_turns``: CUDA
graphs, in turns, each result checked first), with the card's name and
power limit. ``--profile`` also lists the kernels cuDNN runs for each conv
(torch.profiler over one call). The other options build text-patched
copies of the source into ``csrc/_build/k3_bwd_data/`` (the shipped source
has no switches) and time them in turns with the shipped build:
``--no-recompute`` conv1 with its epilogue taking conv0's output from the
accumulator instead of recomputing it from the waveform, at B in {8, 512};
``--phases`` each conv at B=512 without the tensor-core products, without
the weight copies, and without either. Only the shipped build's results
are right; compare the builds with each other.
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
from livelyspeaker_tpu_torch.ops import fused_wav as k3  # noqa: E402
from livelyspeaker_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

OUT_DIR = CSRC_DIR / "_build" / "k3_bwd_data"
# Each variant: a list of patches, each a list of (anchor in the source,
# text put in its place) of which the first anchor found once is patched.
# conv1's conv0 recompute in the epilogue, replaced by a value of the
# accumulator; the second anchor is the epilogue of the FP32-FMA kernel
# this one replaced, for measuring a checkout that still has it.
NO_RECOMPUTE = [
    ("            for (int k = 0; k < kK; ++k) m = conv0_tap(m, w0r[e][k], x[k]);\n"
     "            x2[e] = m;\n",
     "            x2[e] = m + 0.5f * acc[r][2 * h + e];\n"),
    ("      const float xh = src_xhat<kFromWav>(src, b, tau, ch);\n",
     "      const float xh = kFromWav ? 0.5f * acc[i][c] : src_xhat<kFromWav>(src, b, tau, ch);\n"),
]
NO_PRODUCTS = [("      for (int j = 0; j < 3; ++j) {\n        // a0..a3",
                "      for (int j = 0; j < 0; ++j) {\n        // a0..a3")]
NO_WEIGHT_COPIES = [("        mbar_expect_tx(&full[slot], G::kW * sizeof(float));\n"
                     "        tma_load_1d(",
                     "        mbar_arrive(&full[slot]);\n        if (false) tma_load_1d(")]
VARIANTS = {"no conv0 recompute": [NO_RECOMPUTE], "no products": [NO_PRODUCTS],
            "no weight copies": [NO_WEIGHT_COPIES],
            "neither": [NO_PRODUCTS, NO_WEIGHT_COPIES]}
PHASES = ("no products", "no weight copies", "neither")


def patched_source(patches):
    src = (CSRC_DIR / "fused_wav.cu").read_text()
    for alternatives in patches:
        for anchor, text in alternatives:
            if src.count(anchor) == 1:
                src = src.replace(anchor, text)
                break
        else:
            raise SystemExit(f"k3_bwd_data: no anchor found once in fused_wav.cu: "
                             f"{alternatives[0][0]!r}")
    return src


def build(names):
    """{name: the patched build's fused_wav_bwd_data_launch, bound as the
    shipped one}, one nvcc a variant, started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        stem = name.replace(" ", "_")
        cu, so = OUT_DIR / f"fused_wav_{stem}.cu", OUT_DIR / f"lib{stem}.so"
        cu.write_text(patched_source(VARIANTS[name]))
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    k3._launcher("bwd_data")
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k3_bwd_data: nvcc failed on {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).fused_wav_bwd_data_launch
        fn.argtypes, fn.restype = k3._bound["bwd_data"].argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def variant_turns(card, fns, convs, batches):
    """Conv i's launches of the shipped build and of each variant in
    ``fns``, in turns (CUDA graphs): ms a call."""
    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_

    length = audio_samples_for_frames(34)
    d = k3.WavDims(length)
    t = (d.T1, d.T2, d.T3, d.T4)
    g = torch.Generator().manual_seed(90)
    packed = k3.pack_wav_params(random_normal_(WavEncoder(), g).cuda(), differentiable=False)
    shipped = k3._bound["bwd_data"]
    for b in batches:
        wav = (0.1 * torch.randn(b, length, generator=g)).cuda()
        _, res = k3.fused_wav_forward(wav, packed)
        for i in convs:
            cot = torch.randn(b, t[i], k3.CHANNELS[i + 1], generator=g).cuda()
            runs = {}
            for name, fn in {"as shipped": shipped, **fns}.items():
                k3._bound["bwd_data"] = fn
                runs[name] = chip_smoke.graphed(lambda: k3.data_grad(i, res, cot, packed))
            k3._bound["bwd_data"] = shipped
            times = chip_smoke.time_turns(runs, 10)
            print(f"[k3-bwd-data] conv{i} B={b}, ms a call: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                  + f"; CUDA graphs, in turns ({card})")


def cudnn_kernels(card):
    """The device kernels of one cuDNN data-gradient call a conv, B=512."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(91)
    d = k3.WavDims(36_267)
    t = (d.T1, d.T2, d.T3, d.T4)
    for i in (1, 2, 3):
        cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
        a = torch.randn(512, cin, t[i - 1], generator=g).cuda()
        gt = torch.randn(512, cout, t[i], generator=g).cuda()
        w = torch.randn(cout, cin, 15, generator=g).cuda()
        call = lambda: torch.ops.aten.convolution_backward(
            gt, a, w, [cout], [6], [0], [1], False, [0], 1, [True, False, False])
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                print(f"[cudnn] conv{i} B=512: {e.key[:150]} x{e.count} "
                      f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.4f} ms ({card})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also list the kernels cuDNN runs for each conv")
    parser.add_argument("--no-recompute", action="store_true",
                        help="also time conv1 without its epilogue's conv0 recompute")
    parser.add_argument("--phases", action="store_true",
                        help="also time each conv without its products, without its weight "
                             "copies, and without either")
    args = parser.parse_args()
    card = chip_smoke.device_phase()
    from livelyspeaker_tpu_torch.ops._build import load_library

    load_library("fused_wav")
    for b in (8, 512):
        chip_smoke.wav_bwd_data_turns(card, b)
    if args.no_recompute:
        variant_turns(card, build(["no conv0 recompute"]), (1,), (8, 512))
    if args.phases:
        variant_turns(card, build(PHASES), (1, 2, 3), (512,))
    if args.profile:
        cudnn_kernels(card)


if __name__ == "__main__":
    main()
