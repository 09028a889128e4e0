"""The benchmark's yardstick: peaks, roofline bounds, FLOP counts and the
reading of a profiler trace.

Frozen copies, so that a change to the program cannot move its own ruler:

- :func:`k1_cost` and :func:`k2_cost` follow ``chip_smoke.k1_cost`` and
  ``chip_smoke.k2_cost``, taking shapes in place of tensors;
- :func:`denoiser_matmul_flops`, :func:`wav_encoder_flops` and
  :func:`train_step_matmul_flops` follow ``scripts/bench_train.py``;
- :func:`trace_summary` follows ``chip_smoke.trace_summary``, counts the
  driver API's launches beside the runtime's, and adds each profiler
  annotation's host and device time (:func:`span_times`).

Every bound and every ``mfu`` is taken against the H100's dense TF32
tensor-core peak and HBM3's bandwidth (NVIDIA's data sheet, SXM part, at
700 W): the configurations state float32, no implementation that the
correctness check admits runs faster than TF32's rate, and a step taken
against the 67 TFLOP/s f32 peak could read over 100% once a product moves
onto the tensor cores.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

PEAK_TF32 = 495e12  # FLOP/s, dense TF32 on the tensor cores, H100 SXM
PEAK_BYTES = 3.35e12  # bytes/s, HBM3, H100 SXM
F32 = 4  # bytes an element

# (c_in, c_out, kernel, stride, padding) of the WavEncoder's four convs
WAV_CONVS = ((1, 32, 15, 5, 1600), (32, 64, 15, 6, 0), (64, 128, 15, 6, 0), (128, 256, 15, 6, 0))


def bound_s(flop: float, nbytes: float) -> float:
    """The least seconds the card could take for ``flop`` operations and
    ``nbytes`` of device memory traffic."""
    return max(flop / PEAK_TF32, nbytes / PEAK_BYTES)


def k1_cost(b: int, s: int, d: int, layers: int, f: int = 0) -> Tuple[float, float]:
    """(FLOP, bytes) of one K1 call on B sequences of [S, D] with LN2
    folded (the sampler's pack) and, with ``f``, the pose projection fused:
    the token mix, channel mix and pose products (the LayerNorms,
    activations and residuals left out); every input read once, the output
    written once, in f32."""
    flop = b * (layers * (2 * s * d * d + 2 * s * s * d) + 2 * s * d * f)
    weights = layers * (2 * d + s * s + s + d * d + d) + (d * f + f if f else 0)
    nbytes = F32 * (b * s * d + b * d + weights + b * s * (f or d))
    return float(flop), float(nbytes)


def k2_cost(b: int, s: int, d: int, layers: int) -> Dict[str, Tuple[float, float]]:
    """(operations, bytes) of each K2 kernel over one training forward and
    one backward call (all its launches), from the shapes: the products'
    FLOPs (the LayerNorms and activations left out), each kernel's inputs
    read once and its outputs written once."""
    act = b * s * d  # one [B, S, D] tensor, in floats
    weights = layers * (d * d + 5 * d + s * s + s)
    part = b * (5 * d + s + s * s)
    fwd = (b * layers * (2 * s * d * d + 2 * s * s * d),
           4 * (2 * act + b * d + weights + layers * act))
    # per layer: the channel mix recomputed and g_m2 @ ch_w^T (two D x D
    # products), the token mix, its data and weight gradients (three S x S);
    # it reads the stash, g and emb and writes g_a, h2 and g_m2, d emb and part
    blk = (b * (4 * s * d * d + 6 * s * s * d),
           4 * (5 * act + 2 * b * d + weights // layers + part))
    wgr = (3 * 2 * b * s * d * d, 4 * (2 * act + d * d))  # reads h2, g_m2; writes d ch_w
    red = (part, 4 * (part + 5 * d + s + s * s))  # reads part; writes 7 gradients
    cost = {"fwd": (float(fwd[0]), float(fwd[1]))}
    for k, (f, n) in (("bwd_block", blk), ("wgrad", wgr), ("reduce", red)):
        cost[k] = (float(layers * f), float(layers * n))
    return cost


def wav_encoder_flops(n_samples: int, batch: int) -> float:
    """Matmul-equivalent FLOPs of the WavEncoder conv stack: 2 * L_out * k *
    c_in * c_out a conv."""
    total = 0.0
    length = n_samples
    for cin, cout, k, s, pad in WAV_CONVS:
        length = (length + 2 * pad - k) // s + 1
        total += 2.0 * length * k * cin * cout
    return total * batch


def audio_samples_for_frames(n_frames: int, fps: int = 15, sr: int = 16000) -> int:
    return int(round(n_frames / fps * sr))


def denoiser_matmul_flops(rag: Dict, batch: int) -> float:
    """Matmul FLOPs of one denoiser forward at ``batch`` (the audio frontend,
    the LayerNorms and the activations left out). ``rag``: the
    configuration file's ``rag`` group."""
    t, d = rag["nframes"], rag["latent_dim"]
    s = t + 1 + (1 if rag["num_emotions"] else 0)
    nif = rag["njoints"] * rag["nfeats"]
    in_feats = 2 * nif + 1 + rag["audio_feat_dim"]
    return (2.0 * batch * t * in_feats * d  # input_mapping
            + 2.0 * batch * rag["speaker_dim"] * d * 2  # speaker mu/logvar heads
            + 2.0 * batch * d * d * 2  # timestep-embed MLP
            + rag["num_layers"] * (2.0 * batch * s * s * d + 2.0 * batch * s * d * d)
            + 2.0 * batch * t * d * nif)  # pose_final


def train_step_matmul_flops(rag: Dict, batch: int) -> float:
    """One training step: the forward at ``batch`` (with the WavEncoder) and
    a backward of twice its work."""
    fwd = denoiser_matmul_flops(rag, batch) + wav_encoder_flops(
        audio_samples_for_frames(rag["nframes"]), batch)
    return 3.0 * fwd


def sample_batch_flops(rag: Dict, batch: int, steps: int) -> float:
    """One CFG sampling batch of ``batch`` clips over ``steps`` denoiser
    calls: the audio encoded once, each call a forward of 2 * batch rows."""
    return (wav_encoder_flops(audio_samples_for_frames(rag["nframes"]), batch)
            + steps * denoiser_matmul_flops(rag, 2 * batch))


def clip_text_flops(clip: Dict, batch: int) -> float:
    """The CLIP text tower's matmul FLOPs over ``batch`` sequences of the
    full context: per layer the QKV and output projections, the two MLP
    products and attention's two products; then the text projection of one
    token a sequence."""
    n, w = clip["context_length"], clip["width"]
    layer = 2.0 * n * w * (4 * w + 8 * w) + 4.0 * n * n * w
    return batch * (clip["layers"] * layer + 2.0 * w * clip["embed_dim"])


def sag_decode_flops(sag: Dict, nframes: int, batch: int) -> float:
    """The SAG decoder's matmul FLOPs over ``batch`` clips of ``nframes``:
    the input mapping, per layer self-attention (projections and its two
    products), cross-attention to one memory token (its value and output
    projections of that token, the query side's projections of every
    frame), the feed-forward pair; then the final layer."""
    t, d, ff = nframes, sag["latent_dim"], sag["ff_size"]
    nif = sag["njoints"] * sag["nfeats"]
    self_attn = 2.0 * t * d * 4 * d + 4.0 * t * t * d
    cross = 2.0 * t * d * 2 * d + 2.0 * d * 2 * d + 4.0 * t * d
    layer = self_attn + cross + 4.0 * t * d * ff
    return batch * (2.0 * t * (nif + 1) * d + sag["num_layers"] * layer + 2.0 * t * d * nif)


# ---------------------------------------------------------------- traces
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_trace(path: str) -> List[Dict]:
    """The complete ('X') events of a torch.profiler Chrome trace."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def trace_summary(events: List[Dict], k1_name: str = "fused_transmlp_cluster_kernel") -> Dict:
    """What a trace shows: the span of its events, the card's busy time (the
    union of the intervals of its kernels, copies and sets), K1's time and
    launches, the host's kernel-launch calls (runtime and driver API; a
    graph launch counts once), kernel time by name, the idle gaps by what
    the host was doing, each annotation's times. Times in seconds."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    if not kernels:
        return {}
    merged = _merged([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(hi - lo for lo, hi in merged)
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    by_name: Dict[str, float] = {}
    n_by_name: Dict[str, int] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        n_by_name[e["name"]] = n_by_name.get(e["name"], 0) + 1
    k1 = [e["dur"] for e in kernels if k1_name in e["name"]]
    launches = sum(1 for e in events if e.get("cat") in LAUNCH_CATS
                   and "Launch" in e.get("name", ""))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"span_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "idle_share": 1.0 - busy / (t1 - t0),
            "k1_s": sum(k1) / 1e6, "k1_kernels": len(k1), "kernels": len(kernels),
            "launch_calls": launches,
            "by_name_s": {n: t / 1e6 for n, t in top}, "n_by_name": n_by_name,
            "idle_gaps_s": idle_gaps(events, merged, t0, t1), "spans": span_times(events)}


def span_times(events: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Each profiler annotation (``record_function``: category
    ``user_annotation``) by name: how often it ran, its host seconds, and
    the device seconds of the kernels, copies and sets launched inside it
    (a launch call on the annotation's thread within its interval, joined to
    its device operation by the trace's correlation id). Nested
    annotations of one name count their interval once."""
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    if not ann:
        return {}
    device: Dict[int, float] = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and corr is not None:
            device[corr] = device.get(corr, 0.0) + e["dur"]
    calls: Dict[Tuple, List[Dict]] = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            calls.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for v in calls.values():
        v.sort(key=lambda e: e["ts"])
    starts = {k: [e["ts"] for e in v] for k, v in calls.items()}
    out: Dict[str, Dict[str, float]] = {}
    for e in ann:
        rec = out.setdefault(e["name"], {"count": 0, "ivs": {}})
        rec["count"] += 1
        rec["ivs"].setdefault((e.get("pid"), e.get("tid")), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    for rec in out.values():
        host = dev = 0.0
        for thread, ivs in rec.pop("ivs").items():
            for lo, hi in _merged(ivs):
                host += hi - lo
                ts = starts.get(thread, [])
                for c in calls.get(thread, [])[bisect.bisect_left(ts, lo):
                                                bisect.bisect_right(ts, hi)]:
                    dev += device.get((c.get("args") or {}).get("correlation"), 0.0)
        rec["host_s"], rec["device_s"] = host / 1e6, dev / 1e6
    return out


# The port's kernels by their demangled names (a template's begins "void ",
# the sources keep them in an anonymous namespace), anchored so that PyTorch's own at::native::reduce_kernel<...> and K3's
# wav_wgrad_kernel do not match.
_OWN = r"(void )?(\(anonymous namespace\)::)?"
K1_KERNELS = _OWN + r"fused_transmlp_cluster_kernel[<(]"
K2_KERNELS = _OWN + r"(fused_transmlp_cluster_kernel|bwd_block_kernel|wgrad_kernel|reduce_kernel)[<(]"


def kernel_time_s(summary: Dict, pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name matches
    ``pattern`` from its start."""
    hit = [n for n in summary.get("by_name_s", {}) if re.match(pattern, n)]
    return (sum(summary["by_name_s"][n] for n in hit),
            sum(summary["n_by_name"][n] for n in hit))


def idle_gaps(events: List[Dict], merged: List[Tuple[float, float]], t0: float,
              t1: float) -> Dict[str, float]:
    """Idle device time by what the host was doing: each gap between busy
    intervals (and before the first, after the last) goes to the shortest
    host operation or CUDA API call that covers its midpoint, or to
    ``host: none``."""
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                  "python_function") + LAUNCH_CATS]
    host.sort(key=lambda e: e["ts"])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    out: Dict[str, float] = {}
    active: List[Dict] = []  # host operations begun before the midpoint
    nxt = 0
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        while nxt < len(host) and host[nxt]["ts"] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [e for e in active if e["ts"] + e["dur"] >= mid]
        best: Optional[Dict] = min(active, key=lambda e: e["dur"], default=None)
        name = f"host: {best['name']}" if best is not None else "host: none"
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
    return out
