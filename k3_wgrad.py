"""K3's weight-gradient kernel alone, conv by conv, on the card.

    python3 k3_wgrad.py [--profile]

Builds ``csrc/fused_wav.cu`` and, at TED's waveform length (36,267
samples) and B in {8, 512}, times each conv's launch of the
weight-gradient kernel against cuDNN's weight gradient of the same conv on
the materialised activation (``chip_smoke.wav_wgrad_turns``: CUDA graphs,
in turns, each result checked first), with the card's name and power
limit. ``--profile`` also lists the kernels cuDNN runs for each conv
(torch.profiler over one call).
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402


def cudnn_kernels(card):
    """The device kernels of one cuDNN weight-gradient call a conv, B=512."""
    from torch.profiler import ProfilerActivity, profile

    from livelyspeaker_tpu_torch.ops import fused_wav as k3

    g = torch.Generator().manual_seed(60)
    d = k3.WavDims(36_267)
    t = (d.T1, d.T2, d.T3, d.T4)
    for i in (1, 2, 3):
        cin, cout = k3.CHANNELS[i], k3.CHANNELS[i + 1]
        a = torch.randn(512, cin, t[i - 1], generator=g).cuda()
        gt = torch.randn(512, cout, t[i], generator=g).cuda()
        w = torch.randn(cout, cin, 15, generator=g).cuda()
        call = lambda: torch.ops.aten.convolution_backward(
            gt, a, w, [cout], [6], [0], [1], False, [0], 1, [False, True, True])
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
    args = parser.parse_args()
    card = chip_smoke.device_phase()
    from livelyspeaker_tpu_torch.ops._build import load_library

    load_library("fused_wav")
    for b in (8, 512):
        chip_smoke.wav_wgrad_turns(card, b)
    if args.profile:
        cudnn_kernels(card)


if __name__ == "__main__":
    main()
