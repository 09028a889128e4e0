"""K3's forward conv kernel alone, conv by conv, on the card.

    python3 k3_conv_fwd.py [--profile] [--no-recompute] [--phases] [--parent DIR] [--sass]

Builds ``csrc/fused_wav.cu`` and, at TED's waveform length (36,267
samples) and B in {8, 512}, times each conv's launches of the forward conv
kernel (conv i over lrelu(IN(pre)), written [B, T_i, C_out]) against
cuDNN's forward conv of the same conv on the materialised input
a = lrelu(IN(pre)) laid out [B, C_in, T_in] (F.conv1d, f32, TF32 off),
which does no InstanceNorm, LeakyReLU or conv0 recompute. Every build is
held first against the plain conv in f64 and a second launch against the
first's bits, then all are replayed from CUDA graphs and timed in turns,
with the card's name and power limit. A build whose source has
``fused_wav_wsplit_fwd_launch`` is called as the shipped forward calls it
(the weights split into TF32 halves, then the conv); one without it (the
FP32-FMA kernel this one replaced) gets torch's weights as they are.

``--parent DIR`` also builds ``DIR/livelyspeaker_tpu_torch/csrc/fused_wav.cu``
(a checkout of another commit) and times it in the same turns.
``--no-recompute`` also builds a text-patched copy of each measured source
in which conv1 sums one tap of conv0 (the 3xTF32 kernel) or reads one
waveform sample (the FP32-FMA kernel) where it sums fifteen taps, and
times it at conv1. ``--phases`` instead builds the shipped kernel without
its tensor-core products (and the A-fragment loads that feed them),
without its weight copies, without its window transform (normalisation,
LeakyReLU, conv1's conv0), without its window copies, without the first
three, without all four, and with the products alone (their loads from
shared memory; nothing copied or transformed), and times them at B=512
only. ``--profile`` lists the kernels cuDNN runs for each conv
(torch.profiler over one call, B=512). ``--sass`` counts the tensor-core,
FP32 and bulk-copy instructions of each instantiation of the shipped
``wav_conv_fwd_kernel`` (``cuobjdump -sass``). The patched builds go to
``csrc/_build/k3_conv_fwd/``; only the unpatched builds' results are right.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from livelyspeaker_tpu_torch.ops import fused_wav as k3  # noqa: E402
from livelyspeaker_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

OUT_DIR = CSRC_DIR / "_build" / "k3_conv_fwd"
# conv1's conv0 recompute cut to one tap: (anchor, text) pairs, of
# which the first anchor found once is patched. The first is the 3xTF32
# kernel's window transform, the second the FP32-FMA kernel's staging.
NO_RECOMPUTE = [
    ("            for (int k = 0; k < kK; ++k) {\n              const float x = xw[k];",
     "            for (int k = 0; k < 1; ++k) {\n              const float x = xw[k];"),
    ("  const float pre = kFromWav ? conv0_at(s, b, tau, c)\n",
     "  const float pre = kFromWav ? __ldg(s.wav + (size_t)b * s.L + tau)\n"),
]


# the shipped kernel without a job, for --phases: (anchor, text)
NO_PRODUCTS = [("      for (int f = 0; f < kFNF; ++f) {\n        // b0, b1",
                "      for (int f = 0; f < 0; ++f) {\n        // b0, b1")]
NO_A_LOADS = [("      for (int x = 0; x < kFMF; ++x) {\n        const float2 v0 = ld2(",
               "      for (int x = 0; x < 0; ++x) {\n        const float2 v0 = ld2(")]
NO_WEIGHT_COPIES = [("        mbar_expect_tx(&wfull[ws], bytes);\n        tma_load_1d(",
                     "        mbar_arrive(&wfull[ws]);\n        if (false) tma_load_1d(")]
NO_TRANSFORM = [("      for (int q = 0; q < ns; ++q) {\n        const float* st = src.st",
                 "      for (int q = 0; q < 0; ++q) {\n        const float* st = src.st")]
NO_WINDOW_COPIES = [("          cp_async16(dst + (seg[q].u + u) * kFWRow + 4 * v,",
                     "          if (false) cp_async16(dst + (seg[q].u + u) * kFWRow + 4 * v,")]
PHASES = {"no products": [NO_PRODUCTS, NO_A_LOADS], "no weight copies": [NO_WEIGHT_COPIES],
          "no transform": [NO_TRANSFORM], "no window copies": [NO_WINDOW_COPIES],
          "none of them": [NO_PRODUCTS, NO_A_LOADS, NO_WEIGHT_COPIES, NO_TRANSFORM],
          "nothing": [NO_PRODUCTS, NO_A_LOADS, NO_WEIGHT_COPIES, NO_TRANSFORM, NO_WINDOW_COPIES],
          "products alone": [NO_WEIGHT_COPIES, NO_TRANSFORM, NO_WINDOW_COPIES]}


def patched_source(src: str, patches=(NO_RECOMPUTE,)) -> str:
    """``src`` with each patch applied: of each list of (anchor, text), the
    first anchor found once."""
    for alternatives in patches:
        for anchor, text in alternatives:
            if src.count(anchor) == 1:
                src = src.replace(anchor, text)
                break
        else:
            raise SystemExit(f"k3_conv_fwd: no anchor found once in fused_wav.cu: "
                             f"{alternatives[0][0]!r}")
    return src


def build(sources):
    """{name: ctypes library} for {name: (source text, its csrc directory)},
    one nvcc each, started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, inc) in sources.items():
        stem = name.replace(" ", "_").replace(",", "")
        cu, so = OUT_DIR / f"fused_wav_{stem}.cu", OUT_DIR / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-I{inc}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k3_conv_fwd: nvcc failed on {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib):
    """(conv, split) launch functions of a build; split is None for a build
    whose conv kernel reads torch's weights as they are."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    conv = lib.fused_wav_conv_fwd_launch
    conv.argtypes, conv.restype = [i, p, p, i, i, p, p, p, i, p, p, p, i, i, i, f, p], ctypes.c_int
    split = getattr(lib, "fused_wav_wsplit_fwd_launch", None)
    if split is not None:
        split.argtypes, split.restype = [p, i, i, p, p], ctypes.c_int
    return conv, split


def conv_launches(fns, i, res, packed, y, wsp):
    """Conv i's launches of one build into y [B, T_i, C_out]."""
    conv, split = fns
    stream = torch.cuda.current_stream().cuda_stream
    cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
    d = k3.WavDims(res.wav.shape[1])
    b, t_in = res.wav.shape[0], (d.T1, d.T2, d.T3)[i - 1]
    w = packed[f"w{i}"].data_ptr()
    if split is not None:
        err = split(w, cin, cout, wsp.data_ptr(), stream)
        if err:
            raise RuntimeError(f"weight split launch failed with cudaError {err}")
        w = wsp.data_ptr()
    pre, st = (None, res.m1, res.m2)[i - 1], (res.st0, res.st1, res.st2)[i - 1]
    err = conv(*k3._src(i == 1, pre, st, t_in, cin, res.wav, packed), w,
               packed[f"b{i}"].data_ptr(), y.data_ptr(), b, y.shape[1], cout, 0.3, stream)
    if err:
        raise RuntimeError(f"conv launch failed with cudaError {err}")


def turns(card, builds, convs, batches, iters=10):
    """Each build's launches of conv i and cuDNN's forward conv, checked and
    then timed in turns (CUDA graphs)."""
    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_

    length = audio_samples_for_frames(34)
    d = k3.WavDims(length)
    t = (d.T1, d.T2, d.T3, d.T4)
    g = torch.Generator().manual_seed(100)
    enc = random_normal_(WavEncoder(), g).cuda()
    packed = k3.pack_wav_params(enc, differentiable=False)
    for b in batches:
        wav = (0.1 * torch.randn(b, length, generator=g)).cuda()
        _, res = k3.fused_wav_forward(wav, packed)
        xh = k3.lrelu_inputs(res, packed)
        for i in convs:
            cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
            a = F.leaky_relu(xh[i - 1], 0.3).contiguous()  # [B, C_in, T_in]
            w, bias = packed[f"w{i}"], packed[f"b{i}"]
            ref = F.conv1d(a.double(), w.double(), bias.double(), stride=6).transpose(1, 2)
            wsp = torch.empty(cin * cout * 30, device="cuda")
            runs, notes, keep = {}, [], []  # keep: the outputs the graphs write
            for name, fns in builds.items():
                y = torch.empty(b, t[i], cout, device="cuda")
                y2 = torch.empty_like(y)
                keep.append(y)
                conv_launches(fns, i, res, packed, y, wsp)
                conv_launches(fns, i, res, packed, y2, wsp)
                torch.cuda.synchronize()
                rel = chip_smoke._rel(y.double(), ref)
                same = torch.equal(y, y2)
                notes.append(f"{name} rel {rel:.1e}{'' if same else ', other bits twice'}")
                if name in ("shipped", "parent"):
                    chip_smoke.check(same and rel <= chip_smoke.KERNEL_TOL,
                                     f"conv{i} B={b} {name}: rel {rel:.3e}, same bits {same}")
                runs[name] = chip_smoke.graphed(
                    lambda fns=fns, y=y: conv_launches(fns, i, res, packed, y, wsp))
            crel = chip_smoke._rel(F.conv1d(a, w, bias, stride=6).double().transpose(1, 2), ref)
            del ref
            runs["cuDNN"] = chip_smoke.graphed(lambda: F.conv1d(a, w, bias, stride=6))
            times = chip_smoke.time_turns(runs, iters)
            print(f"[k3-conv-fwd] conv{i} B={b} T_out {t[i]}, ms a call: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                  + f" ({'; '.join(notes)}; cuDNN rel {crel:.1e}); CUDA graphs, in turns ({card})")


def cudnn_kernels(card):
    """The device kernels of one cuDNN forward conv a conv, B=512."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(101)
    d = k3.WavDims(36_267)
    t = (d.T1, d.T2, d.T3, d.T4)
    for i in (1, 2, 3):
        cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
        a = torch.randn(512, cin, t[i - 1], generator=g).cuda()
        w = torch.randn(cout, cin, 15, generator=g).cuda()
        bias = torch.randn(cout, generator=g).cuda()
        call = lambda: F.conv1d(a, w, bias, stride=6)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                print(f"[cudnn] conv{i} B=512: {e.key[:150]} x{e.count} "
                      f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.4f} ms ({card})")


def sass_counts(lib_path):
    """Per instantiation of wav_conv_fwd_kernel in the library: the count of
    each opcode of interest in its SASS."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    ops = ("HMMA.1688.F32.TF32", "FFMA", "FMUL", "FADD", "UBLKCP", "LDGSTS", "SYNCS")
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        if "wav_conv_fwd_kernel" not in name:
            continue
        counts = {op: len(re.findall(r"\b" + re.escape(op) + r"\b", part)) for op in ops}
        print(f"[sass] {name.strip()[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also list the kernels cuDNN runs for each conv")
    parser.add_argument("--no-recompute", action="store_true",
                        help="also time conv1 without its conv0 recompute")
    parser.add_argument("--phases", action="store_true",
                        help="also time the shipped kernel without its products, without its "
                             "weight copies, without its window transform, and without all three")
    parser.add_argument("--sass", action="store_true",
                        help="also count the shipped kernel's SASS instructions")
    parser.add_argument("--parent", metavar="DIR",
                        help="also time the forward conv of DIR's fused_wav.cu")
    args = parser.parse_args()
    card = chip_smoke.device_phase()
    sources = {"shipped": ((CSRC_DIR / "fused_wav.cu").read_text(), CSRC_DIR)}
    if args.parent:
        csrc = Path(args.parent).resolve() / "livelyspeaker_tpu_torch" / "csrc"
        sources["parent"] = ((csrc / "fused_wav.cu").read_text(), csrc)
    if args.phases:
        sources.update({k: (patched_source(sources["shipped"][0], v), CSRC_DIR)
                        for k, v in PHASES.items()})
    if args.no_recompute:
        sources.update({f"{k}, no conv0 recompute": (patched_source(text), inc)
                        for k, (text, inc) in list(sources.items()) if k in ("shipped", "parent")})
    libs = build(sources)
    if args.sass:
        sass_counts(OUT_DIR / "libshipped.so")
    builds = {k: bind(lib) for k, lib in libs.items()}
    full = {k: v for k, v in builds.items() if "no conv0" not in k}
    if args.phases:  # the phase builds at B=512 only
        turns(card, full, (1, 2, 3), (512,))
        return
    for b in (8, 512):
        turns(card, full, (2, 3), (b,))
        turns(card, builds, (1,), (b,))
    if args.profile:
        cudnn_kernels(card)


if __name__ == "__main__":
    main()
