"""K3's two reductions alone, on the card: the InstanceNorm statistics
kernel and the reduce kernel.

    python3 k3_reductions.py [--other DIR ...]

Builds ``csrc/fused_wav.cu`` and, at TED's waveform length (36,267
samples) and B in {8, 512}, runs ``chip_smoke.wav_stats_turns`` (the two
statistics launches of a forward on the m1 and m2 a forward produced,
against torch.var_mean then rsqrt, and var_mean alone) and
``chip_smoke.wav_reduce_turns`` (each of a backward's four reduce launches
against part.sum(0) on the same partials). Every result is held first
against f64 and a second call against the first's bits; then all are
replayed from CUDA graphs and timed in turns, with the card's name and
power limit.

``--other DIR`` (repeatable) also builds
``DIR/livelyspeaker_tpu_torch/csrc/fused_wav.cu`` (a checkout of another
commit, whose two launch functions take the same arguments) into
``csrc/_build/k3_conv_fwd/`` and times its two kernels in the same turns,
under DIR's last name.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import k3_conv_fwd  # noqa: E402
from livelyspeaker_tpu_torch.ops import fused_wav as k3  # noqa: E402


def other_functions(lib):
    """(stats, reduce) of another build, with the signatures of
    ``k3.norm_stats`` and ``k3.reduce_partials``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    stats, red = lib.fused_wav_stats_launch, lib.fused_wav_reduce_launch
    stats.argtypes, stats.restype = [p, i, i, i, p, p], ctypes.c_int
    red.argtypes, red.restype = [p, i, i, p, p], ctypes.c_int

    def call(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch of another build failed with cudaError {err}")

    def norm_stats(m):
        b, t, c = m.shape
        st = torch.empty(b, 2, c, device=m.device)
        call(stats, m.data_ptr(), b, t, c, st.data_ptr())
        return st

    def reduce_partials(part, i):
        cout, cin = k3.CHANNELS[i + 1], k3.CHANNELS[i]
        flat = torch.empty(part.shape[1], device=part.device)
        call(red, part.data_ptr(), part.shape[0], flat.numel(), flat.data_ptr())
        return flat[:cout * cin * 15].view(cout, cin, 15), flat[cout * cin * 15:]

    return norm_stats, reduce_partials


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", metavar="DIR", action="append", default=[],
                        help="also time the two kernels of DIR's fused_wav.cu (repeatable)")
    args = parser.parse_args()
    card = chip_smoke.device_phase()
    chip_smoke.build_phase()
    stats, reduce = {}, {}
    csrc = {Path(d).resolve().name: Path(d).resolve() / "livelyspeaker_tpu_torch" / "csrc"
            for d in args.other}
    libs = k3_conv_fwd.build({k: ((v / "fused_wav.cu").read_text(), v) for k, v in csrc.items()})
    for name, lib in libs.items():
        stats[name], reduce[name] = other_functions(lib)
    for b in (8, 512):
        chip_smoke.wav_stats_turns(card, b, stats)
        chip_smoke.wav_reduce_turns(card, b, reduce)


if __name__ == "__main__":
    main()
