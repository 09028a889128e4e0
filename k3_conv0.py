"""K3's two conv0 kernels alone, on the card: IN0's statistics
(``wav_stats0_kernel``) and conv0's backward through IN0
(``wav_wgrad0_kernel``).

    python3 k3_conv0.py [--other DIR ...] [--phases] [--sass [FILE]] [--clocks]

Builds ``csrc/fused_wav.cu`` and, at TED's waveform length (36,267
samples) and B in {8, 512}, runs ``chip_smoke.wav_conv0_turns``: the
statistics kernel on a seeded waveform, and the conv0 backward kernel with
and without d_wav on the gy1 and sums that a backward's conv1 data gradient
produced. Every result is held first against the plain version in f64 and
a second call against the first's bits; then all are replayed from CUDA
graphs and timed in turns, beside cuDNN doing the same work on
materialised tensors (for information), the table bound and the rounding
rule's instruction floor, with the card's name and power limit.

``--other DIR`` (repeatable) also builds
``DIR/livelyspeaker_tpu_torch/csrc/fused_wav.cu`` (a checkout of another
commit) into ``csrc/_build/k3_conv_fwd/`` and times its two kernels in the
same turns, under DIR's last name; it is called with this checkout's
interface and geometry.

``--phases`` instead builds text-patched copies of the shipped source into
``csrc/_build/k3_conv_fwd/`` (conv0 summed over one tap instead of fifteen
in both kernels; no dW0 products in the backward; no reads of gy1; none of
the three) and times them with the shipped build at B=512 only. Their
results are wrong and are not checked.

``--sass`` also counts the FP32, shared-memory, shuffle and global
instructions of the shipped build's two kernels (``cuobjdump -sass``), and
writes their SASS to FILE when one is given. ``--clocks`` also
replays each shipped kernel at B=512 for about two seconds while
``nvidia-smi`` samples the SM clock and the power draw every 100 ms, and
prints their medians: the clock the floor should be taken at.
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import k3_conv_fwd  # noqa: E402
from livelyspeaker_tpu_torch.ops import fused_wav as k3  # noqa: E402
from livelyspeaker_tpu_torch.ops._build import CSRC_DIR  # noqa: E402

# (anchor, text) pairs; a phase patches each anchor, which must be found once
NO_RECOMPUTE = [
    ("    for (int i = 0; i < kC0Group; ++i) m[i] = conv0_tap(m[i], w[k], x[kS0 * i + k]);",
     "    for (int i = 0; i < kC0Group && k == 0; ++i) m[i] = conv0_tap(m[i], w[k], x[kS0 * i + k]);"),
]
NO_DW0_SUMS = [
    ("              for (int q = 0; q < kK; ++q) acc[q] = fmaf(v[i], x[kS0 * i + q], acc[q]);",
     "              for (int q = 0; q < 0; ++q) acc[q] = fmaf(v[i], x[kS0 * i + q], acc[q]);"),
]
NO_GY1_READS = [
    ("        cp_async16(dst + r * kW0Row + col, gyb + (in ? (size_t)(t0 + r) * kC0 + col : 0), in);",
     "        if (false) cp_async16(dst + r * kW0Row + col, gyb, in);"),
]
PHASES = {"no conv0 recompute": NO_RECOMPUTE, "no dW0 sums": NO_DW0_SUMS,
          "no gy1 reads": NO_GY1_READS, "none of them": NO_RECOMPUTE + NO_DW0_SUMS + NO_GY1_READS}


def patched_source(src: str, pairs) -> str:
    """``src`` with each (anchor, text) of ``pairs`` replaced; raises
    SystemExit when an anchor is not found once."""
    for anchor, text in pairs:
        if src.count(anchor) != 1:
            raise SystemExit(f"k3_conv0: anchor not found once in fused_wav.cu: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def other_functions(lib):
    """(stats0, partials) of another build, with the signatures of
    ``k3.conv0_stats`` and ``k3.conv0_partials``."""
    p = ctypes.c_void_p
    stats0, wgrad0 = lib.fused_wav_stats0_launch, lib.fused_wav_wgrad0_launch
    for fn, kernel in ((stats0, "stats0"), (wgrad0, "wgrad0")):
        fn.argtypes, fn.restype = k3._launcher(kernel).argtypes, ctypes.c_int

    def call(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch of another build failed with cudaError {err}")

    def conv0_stats(wav, packed):
        b, length = wav.shape
        geo = k3.stats0_geometry(b, length)
        st0 = torch.empty(b, 2, 32, device=wav.device)
        call(stats0, wav.data_ptr(), packed["w0"].data_ptr(), packed["b0"].data_ptr(), length,
             k3.WavDims(length).T1, b, geo.cluster, geo.per, st0.data_ptr())
        return st0

    def conv0_partials(res, gy1, sums, packed, need_wav_grad=True):
        b, length = res.wav.shape
        geo = k3.wgrad0_geometry(b, length)
        part = torch.empty(geo.ctas, 32 * 15 + 32, device=gy1.device)
        d_wav = torch.empty(b, length, device=gy1.device) if need_wav_grad else None
        call(wgrad0, res.wav.data_ptr(), packed["w0"].data_ptr(), packed["b0"].data_ptr(),
             length, res.st0.data_ptr(), gy1.data_ptr(), sums.data_ptr(), sums.shape[1], b,
             k3.WavDims(length).T1, geo.splits, geo.per, part.data_ptr(), geo.ctas,
             None if d_wav is None else d_wav.data_ptr())
        return d_wav, part

    return conv0_stats, conv0_partials


def sass_counts(out_path=None):
    """Each conv0 kernel's count of the opcodes of interest in the shipped
    build's SASS; the SASS of both into ``out_path``, if given."""
    from livelyspeaker_tpu_torch.ops._build import _paths

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_paths("fused_wav")[1])], capture_output=True,
                          text=True, check=True).stdout
    ops = ("FFMA", "FMUL", "FADD", "LDS", "STS", "SHFL", "LDG", "STG", "LDGSTS", "BAR", "BRA")
    keep = []
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        if "stats0_kernel" not in name and "wgrad0_kernel" not in name:
            continue
        keep.append(part)
        counts = {op: len(re.findall(r"\b" + op + r"(?:\.[A-Z0-9.]+)?\b", part)) for op in ops}
        print(f"[sass] {name.strip()[:80]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text("".join(keep))


def clocks_under_load(card, seconds=2.0):
    """The median SM clock (MHz) and power draw (W) nvidia-smi reads while
    each shipped conv0 kernel runs back to back at TED B=512."""
    import time

    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_

    g = torch.Generator().manual_seed(130)
    packed = k3.pack_wav_params(random_normal_(WavEncoder(), g).cuda(), differentiable=False)
    length = audio_samples_for_frames(34)
    d = k3.WavDims(length)
    wav = (0.1 * torch.randn(512, length, generator=g)).cuda()
    _, res = k3.fused_wav_forward(wav, packed)
    cot = torch.randn(512, d.T4, 256, generator=g).cuda()
    _, gy1, sums = k3._stack_backward(res, cot, packed, 0.3, d)
    runs = {"stats0": lambda: k3.conv0_stats(wav, packed),
            "wgrad0": lambda: k3.conv0_partials(res, gy1, sums, packed, False),
            "wgrad0+d_wav": lambda: k3.conv0_partials(res, gy1, sums, packed, True)}
    for name, fn in runs.items():
        replay = chip_smoke.graphed_reps(fn, 20)
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "100"],
                               stdout=subprocess.PIPE, text=True)
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                replay()
                torch.cuda.synchronize()
        finally:
            smi.terminate()
            out = smi.communicate(timeout=30)[0]
        rows = [line.split(",") for line in out.strip().splitlines()[2:-1] if "," in line]
        mhz = [float(r[0]) for r in rows]
        watts = [float(r[1]) for r in rows]
        print(f"[clocks] {name} at B=512, back to back for {seconds:.1f} s: SM clock median "
              f"{sorted(mhz)[len(mhz) // 2]:.0f} MHz (range {min(mhz):.0f}-{max(mhz):.0f}), power "
              f"median {sorted(watts)[len(watts) // 2]:.1f} W, {len(rows)} samples ({card})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", metavar="DIR", action="append", default=[],
                        help="also time the two kernels of DIR's fused_wav.cu (repeatable)")
    parser.add_argument("--sass", nargs="?", const="", metavar="FILE",
                        help="also count the shipped kernels' SASS instructions (and write "
                             "their SASS to FILE)")
    parser.add_argument("--clocks", action="store_true",
                        help="also sample the SM clock while each kernel runs at B=512")
    parser.add_argument("--phases", action="store_true",
                        help="instead time the shipped kernels without parts of their work, "
                             "at B=512")
    args = parser.parse_args()
    card = chip_smoke.device_phase()
    chip_smoke.build_phase()
    if args.sass is not None:
        sass_counts(args.sass)
    if args.clocks:
        clocks_under_load(card)
    sources = {}
    for d in args.other:
        csrc = Path(d).resolve() / "livelyspeaker_tpu_torch" / "csrc"
        sources[Path(d).resolve().name] = ((csrc / "fused_wav.cu").read_text(), csrc)
    if args.phases:
        shipped = (CSRC_DIR / "fused_wav.cu").read_text()
        sources.update({k: (patched_source(shipped, v), CSRC_DIR)
                        for k, v in PHASES.items()})
    libs = k3_conv_fwd.build(sources) if sources else {}
    others = {name: other_functions(lib) for name, lib in libs.items()}
    if args.phases:
        chip_smoke.wav_conv0_turns(card, 512, others, unchecked=tuple(PHASES))
        return
    for b in (8, 512):
        chip_smoke.wav_conv0_turns(card, b, others)


if __name__ == "__main__":
    main()
