"""The frozen copies of the program's arithmetic give the same numbers as
their sources at the cells' shapes (the peak aside)."""

import json

import pytest
import torch

import chip_smoke
from benchmark import arith, harness
from livelyspeaker_tpu_torch.models import RAG, RAGConfig
from livelyspeaker_tpu_torch.ops.fused_mlp import pack_out_proj, pack_transmlp_params
from livelyspeaker_tpu_torch.scripts import bench_train

CONFIGS = ("livelyspeaker-ted", "livelyspeaker-beat")


def _rag(name):
    spec = harness.load_spec()
    return harness.load_json(harness.config_file(spec, name))["rag"]


def _port_cfg(rag):
    return RAGConfig(**{k: rag[k] for k in ("njoints", "nfeats", "nframes", "latent_dim",
                                            "num_layers", "n_speakers", "num_emotions")})


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("b2", [64, 128, 512])
def test_k1_cost(config, b2):
    rag = _rag(config)
    model = RAG(_port_cfg(rag))
    s = model.cfg.seq_len
    packed = pack_transmlp_params(model.backbone, fold_ln2=True)
    op = pack_out_proj(model.pose_final)
    x = torch.empty(b2, s, rag["latent_dim"])
    emb = torch.empty(b2, rag["latent_dim"])
    want = chip_smoke.k1_cost(x, emb, packed, op)
    got = arith.k1_cost(b2, s, rag["latent_dim"], rag["num_layers"],
                        rag["njoints"] * rag["nfeats"])
    assert got == (float(want[0]), float(want[1]))


@pytest.mark.parametrize("config", CONFIGS)
def test_k2_cost(config):
    rag = _rag(config)
    s = _port_cfg(rag).seq_len
    want = chip_smoke.k2_cost(512, s, rag["latent_dim"], rag["num_layers"])
    got = arith.k2_cost(512, s, rag["latent_dim"], rag["num_layers"])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == (float(want[k][0]), float(want[k][1]))


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("batch", [64, 256, 512])
def test_flops(config, batch):
    rag = _rag(config)
    cfg = _port_cfg(rag)
    assert arith.denoiser_matmul_flops(rag, batch) == bench_train.denoiser_matmul_flops(cfg, batch)
    assert arith.train_step_matmul_flops(rag, batch) == \
        bench_train.train_step_matmul_flops(cfg, batch)
    assert arith.wav_encoder_flops(36267, batch) == bench_train.wav_encoder_flops(36267, batch)


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary(tmp_path):
    k1 = "void (anonymous namespace)::fused_transmlp_cluster_kernel<0>(ClusterParams)"
    events = [_event("cpu_op", "aten::mm", 0.0, 50.0),
              _event("cuda_runtime", "cudaLaunchKernel", 1.0, 2.0),
              _event("kernel", k1, 10.0, 20.0),
              _event("cuda_runtime", "cudaLaunchKernelExC", 12.0, 2.0),
              _event("kernel", "gemm", 25.0, 15.0),
              _event("kernel", k1, 60.0, 10.0),
              _event("cuda_runtime", "cudaMemcpyAsync", 70.0, 5.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    want = chip_smoke.trace_summary(str(path))
    got = arith.trace_summary(arith.load_trace(str(path)))
    assert got["span_s"] * 1e3 == pytest.approx(want["span_ms"])
    assert got["busy_s"] * 1e3 == pytest.approx(want["busy_ms"])
    assert got["idle_share"] == pytest.approx(want["idle_share"])
    assert got["k1_s"] * 1e3 == pytest.approx(want["k1_ms"])
    assert (got["k1_kernels"], got["kernels"], got["launch_calls"]) == \
        (want["k1_kernels"], want["kernels"], want["launch_calls"])
    # the copy counts the driver API's launches too, a graph launch once
    events += [_event("cuda_driver", "cuLaunchKernel", 80.0, 1.0),
               _event("cuda_runtime", "cudaGraphLaunch", 82.0, 1.0)]
    assert arith.trace_summary(events)["launch_calls"] == want["launch_calls"] + 2
    assert arith.kernel_time_s(got, arith.K1_KERNELS) == (pytest.approx(30e-6), 2)
    assert got["idle_gaps_s"] == {"host: aten::mm": pytest.approx(30e-6),
                                  "host: cudaMemcpyAsync": pytest.approx(5e-6)}


def test_span_times():
    """An annotation's host time, and the device time of what was launched
    inside it on its own thread, joined by correlation id."""
    def ev(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [ev("user_annotation", "step", 0.0, 100.0),
              ev("user_annotation", "step", 10.0, 20.0),  # nested: counted once
              ev("cuda_runtime", "cudaLaunchKernel", 5.0, 2.0, corr=1),
              ev("kernel", "a", 20.0, 30.0, tid=7, corr=1),
              ev("cuda_runtime", "cudaMemcpyAsync", 50.0, 2.0, corr=2),
              ev("gpu_memcpy", "Memcpy HtoD", 60.0, 4.0, tid=8, corr=2),
              ev("cuda_runtime", "cudaLaunchKernel", 50.0, 2.0, tid=2, corr=3),  # other thread
              ev("kernel", "b", 70.0, 9.0, tid=7, corr=3),
              ev("cuda_runtime", "cudaLaunchKernel", 150.0, 2.0, corr=4),  # after it
              ev("kernel", "c", 160.0, 5.0, tid=7, corr=4)]
    spans = arith.span_times(events)
    assert spans == {"step": {"count": 2, "host_s": pytest.approx(100e-6),
                              "device_s": pytest.approx(34e-6)}}
    assert arith.trace_summary(events)["spans"] == spans
    assert arith.span_times([e for e in events if e["cat"] != "user_annotation"]) == {}


def test_every_metric_has_a_reader():
    """Each per-layer metric finds its reader, by its whole name or its
    stem, and a reader given nothing to read returns nothing."""
    spec = harness.load_spec()
    for m in spec["per_layer"]:
        assert harness.reader(m["name"])({}, None) is None, m["name"]
