"""Where the time of K3's weight-gradient kernel goes, by job, on the card.

    python3 k3_wgrad_phases.py

Builds ``livelyspeaker_tpu_torch/csrc/fused_wav.cu`` four times into
``csrc/_build/k3_wgrad_phases/``, text-patched (the shipped source has no
switches): as shipped; without the tensor-core products; without the split
of each stage (the products then read the first stage again and again);
and with neither, which leaves the copies, the barriers and the loop. It
times each build's ``wav_wgrad_kernel`` launch for convs 1..3 at TED's
clip length and B=512 (CUDA graphs, the builds in turns) and prints ms per
launch and microseconds per 32-row stage of a CTA, with the card's name
and power limit. Only the shipped build's results are right; compare the
builds with each other, not with ``chip_smoke.py``'s times.
"""

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

OUT_DIR = CSRC_DIR / "_build" / "k3_wgrad_phases"
# (anchor in the source, text put in its place); every anchor must be found once
PATCHES = [
    ('#include "tf32_mma.cuh"  // cp.async, the 3xTF32 mma.sync\n',
     '#include "tf32_mma.cuh"  // cp.async, the 3xTF32 mma.sync\n'
     "#ifdef K3_NO_PRODUCTS\n#define PRODUCTS if (false)\n#else\n#define PRODUCTS\n#endif\n"
     "#ifdef K3_NO_SPLIT\n#define SPLIT if (false)\n#define SPLITBUF(i) 0\n"
     "#define NEXT r_next = min(hi, r_this + kGRows)\n"
     "#else\n#define SPLIT\n#define SPLITBUF(i) (i)\n#define NEXT (void)0\n#endif\n"),
    ("    const int r_this = r_next;\n", "    const int r_this = r_next;\n    NEXT;\n"),
    ("    if (more && split_first)\n      r_next = transform(",
     "    if (more && split_first)\n      SPLIT r_next = transform("),
    ("    if (more && !split_first)\n      r_next = transform(",
     "    if (more && !split_first)\n      SPLIT r_next = transform("),
    ("    products(split + (i % 2) * kGSplitFloats);",
     "    PRODUCTS products(split + SPLITBUF(i % 2) * kGSplitFloats);"),
]
VARIANTS = {"as shipped": [], "no products": ["-DK3_NO_PRODUCTS"], "no split": ["-DK3_NO_SPLIT"],
            "copies only": ["-DK3_NO_PRODUCTS", "-DK3_NO_SPLIT"]}


def patched_source():
    src = (CSRC_DIR / "fused_wav.cu").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"k3_wgrad_phases: the kernel changed; anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def build():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / "fused_wav_phases.cu"
    cu.write_text(patched_source())
    procs = {}
    for name, flags in VARIANTS.items():
        so = OUT_DIR / f"lib{name.replace(' ', '_')}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", *flags, "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    k3._launcher("wgrad")  # the shipped library's binding: its argument types
    argtypes = k3._bound["wgrad"].argtypes
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k3_wgrad_phases: nvcc failed on {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).fused_wav_wgrad_launch
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main():
    card = chip_smoke.device_phase()
    fns = build()
    from livelyspeaker_tpu_torch.models import WavEncoder, audio_samples_for_frames
    from livelyspeaker_tpu_torch.models.initializers import random_normal_

    b, length = chip_smoke.TRAIN_BATCH, audio_samples_for_frames(34)
    g = torch.Generator().manual_seed(70)
    packed = k3.pack_wav_params(random_normal_(WavEncoder(), g).cuda(), differentiable=False)
    wav = (0.1 * torch.randn(b, length, generator=g)).cuda()
    _, res = k3.fused_wav_forward(wav, packed)
    d = k3.WavDims(length)
    t = (d.T1, d.T2, d.T3, d.T4)
    shipped = k3._bound["wgrad"]
    for i in (1, 2, 3):
        cot = torch.randn(b, t[i], k3.CHANNELS[i + 1], generator=g).cuda()
        runs = {}
        for name, fn in fns.items():
            k3._bound["wgrad"] = fn
            runs[name] = chip_smoke.graphed(lambda: k3.wgrad_partials(i, res, cot, packed))
        k3._bound["wgrad"] = shipped
        times = chip_smoke.time_turns(runs, 10)
        geo = k3.wgrad_geometry(b, t[i], k3.CHANNELS[i], k3.CHANNELS[i + 1])
        stages = geo.rows_per_split // k3.WGRAD_STAGE
        print(f"[k3-phases] conv{i} B={b}: {geo.tiles} tiles x {geo.nsplit} chunks of {stages} "
              "stages; ms a launch (us a stage): " + ", ".join(
                  f"{k} {v:.4f} ({1e3 * v / stages:.2f})" for k, v in times.items())
              + f" ({card})")


if __name__ == "__main__":
    main()
