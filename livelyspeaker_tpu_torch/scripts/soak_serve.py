"""Serving integration soak: a real server process under mixed traffic.

Port of the JAX package's ``scripts/soak_serve.py``. Everything the HTTP
front end offers, exercised together against one live server process
(``python -m livelyspeaker_tpu_torch.scripts.serve``, not an in-process
harness): short requests with mixed speakers and guidance, long-form
stitching, chunked NDJSON streaming, checkpoint hot-reloads racing the
traffic, /stats and /metrics scrapes, backpressure, and a graceful SIGTERM at
the end. The reference has no serving path at all; this is the production
rehearsal for ours.

Asserts: zero transport errors, all motion finite, stitched long-form frame
counts exactly match the submitted audio duration, param_version == number
of reloads, and the server exits 0 on SIGTERM within the drain window.
Prints one JSON summary line. The two checkpoints (seeded random weights,
the second scaled by 1.01) are written as the JAX package's npz with their
args.json; the server's output goes to ``<out>/server.log``.

    python -m livelyspeaker_tpu_torch.scripts.soak_serve [--seconds 120] [--clients 6]

The server runs on the card unless ``--device`` says otherwise (``--device
cpu`` serves the plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np

__all__ = ["main", "write_checkpoints"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def http_json(port, path, payload=None, timeout=600.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if payload is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(payload),
                         headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        body = r.read()
        return r.status, json.loads(body) if body else {}
    finally:
        conn.close()


def write_checkpoints(out: str, latent_dim: int, layers: int, composition: bool):
    """The serveable RAG checkpoint, its 1.01-scaled second version and
    their args.json (and a SAG with ``composition``), written once into
    ``out``. Returns (rag, rag_v2, sag or None)."""
    import torch

    from ..models import RAG, SAG, RAGConfig
    from ..training.checkpoints import save_args, save_params_npz

    ckpt = os.path.join(out, "model.npz")
    ckpt2 = os.path.join(out, "model_v2.npz")
    if not (os.path.exists(ckpt) and os.path.exists(ckpt2)):
        model = RAG(RAGConfig.ted(latent_dim=latent_dim, num_layers=layers),
                    generator=torch.Generator().manual_seed(0))
        sd = model.state_dict()
        save_params_npz(ckpt, sd, model)
        save_params_npz(ckpt2, {k: v * 1.01 for k, v in sd.items()}, model)
        save_args(out, {"latent_dim": latent_dim, "layers": layers})
    sag_ckpt = os.path.join(out, "sag.npz")
    if composition and not os.path.exists(sag_ckpt):
        sag = SAG(njoints=9, nfeats=3, latent_dim=512, generator=torch.Generator().manual_seed(9))
        save_params_npz(sag_ckpt, sag.state_dict(), sag)
    return ckpt, ckpt2, sag_ckpt if composition else None


def main(argv: Optional[List[str]] = None) -> dict:
    """Soak as ``argv`` says; returns the summary printed (the asserts
    have passed)."""
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=120.0)
    p.add_argument("--clients", type=int, default=6)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="the server's dispatch pipeline depth")
    p.add_argument("--reload_every", type=float, default=15.0)
    p.add_argument("--composition", action="store_true",
                   help="attach a (seeded random) SAG composition and carry text on about "
                        "half the requests: soaks the per-kind batch split, the composition's "
                        "warm-up and per-window sketches under concurrent load")
    p.add_argument("--out", type=str,
                   default=os.path.join(tempfile.gettempdir(), "ls_torch_soak_serve"))
    p.add_argument("--device", type=str, default=None,
                   help="passed to the server: 'cpu' serves the plain versions on the CPU; "
                        "the default is the card")
    a = p.parse_args(argv)

    os.makedirs(a.out, exist_ok=True)
    ckpt, ckpt2, sag_ckpt = write_checkpoints(a.out, a.latent_dim, a.layers, a.composition)

    # --- launch the real server process ---------------------------------
    port = free_port()
    token = "soak-token"
    serve_cmd = [
        sys.executable, "-m", "livelyspeaker_tpu_torch.scripts.serve", "--model_path", ckpt,
        "--host", "127.0.0.1", "--port", str(port), "--max_batch", str(a.max_batch),
        "--pipeline_depth", str(a.pipeline_depth), "--reload_token", token,
    ]
    if a.device:
        serve_cmd += ["--device", a.device]
    if a.composition:
        serve_cmd += ["--sag_path", sag_ckpt, "--guidance_schedule", "cosine"]
    log = open(os.path.join(a.out, "server.log"), "wb")
    proc = subprocess.Popen(serve_cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        t0 = time.time()
        while True:  # the server warms both routes before it binds
            try:
                st, _ = http_json(port, "/healthz", timeout=5.0)
                if st == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, f"server died during warm-up (see {log.name})"
            assert time.time() - t0 < 3600, "server never came up"
            time.sleep(0.5)
        print(f"server up in {time.time() - t0:.0f}s", file=sys.stderr)

        # --- mixed traffic -----------------------------------------------
        sr = 16000
        stop = time.time() + a.seconds
        counts = {"short": 0, "text": 0, "long": 0, "stream": 0,
                  "reload": 0, "overloaded": 0}
        errors = []
        lock = threading.Lock()

        def bump(k):
            with lock:
                counts[k] += 1

        def client(idx):
            import http.client

            r = np.random.default_rng(idx)
            while time.time() < stop:
                try:
                    kind = ["short", "short", "short", "long", "stream"][
                        int(r.integers(0, 5))
                    ]
                    with_text = a.composition and bool(r.integers(0, 2))
                    if kind == "short":
                        wav = r.normal(size=sr // 4).astype(np.float32)
                        body = {
                            "audio_b64": base64.b64encode(
                                wav.tobytes()).decode(),
                            "speaker": int(r.integers(0, 1400)),
                            "guidance": float(r.choice([1.0, 1.5, 2.0])),
                        }
                        if with_text:
                            body["text"] = "a person waves both hands"
                        st, out = http_json(port, "/v1/generate", body)
                        if st == 503:
                            bump("overloaded")
                            continue
                        assert st == 200, out
                        m = np.asarray(out["motion"])
                        assert np.isfinite(m).all()
                        if with_text:
                            # composition is attached: text must route
                            # through it, never be silently dropped
                            assert "text_ignored" not in out, out.keys()
                            bump("text")
                        else:
                            bump("short")
                    elif kind == "long":
                        secs = float(r.uniform(3.0, 6.0))
                        wav = r.normal(size=int(secs * sr)).astype(np.float32)
                        body = {
                            "audio_b64": base64.b64encode(
                                wav.tobytes()).decode(),
                            "speaker": int(r.integers(0, 1400)),
                            "long": True,
                        }
                        if with_text:
                            body["text"] = "a person points to the left"
                        st, out = http_json(port, "/v1/generate", body)
                        if st == 503:
                            bump("overloaded")
                            continue
                        assert st == 200, out
                        m = np.asarray(out["motion"])
                        assert np.isfinite(m).all()
                        assert m.shape[-1] == int(len(wav) * 15 / sr), (
                            m.shape, len(wav)
                        )
                        bump("long")
                    else:  # chunked NDJSON stream
                        secs = float(r.uniform(3.0, 5.0))
                        wav = r.normal(size=int(secs * sr)).astype(np.float32)
                        conn = http.client.HTTPConnection(
                            "127.0.0.1", port, timeout=600.0
                        )
                        conn.request(
                            "POST", "/v1/generate",
                            body=json.dumps({
                                "audio_b64": base64.b64encode(
                                    wav.tobytes()).decode(),
                                "long": True, "stream": True,
                            }),
                            headers={"Content-Type": "application/json"},
                        )
                        resp = conn.getresponse()
                        if resp.status == 503:
                            resp.read()
                            conn.close()
                            bump("overloaded")
                            continue
                        assert resp.status == 200
                        total = 0
                        for line in resp.read().splitlines():
                            if not line.strip():
                                continue
                            obj = json.loads(line)
                            assert "error" not in obj, obj
                            total += obj["frames"]
                        conn.close()
                        assert total == int(len(wav) * 15 / sr)
                        bump("stream")
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")
                    return

        threads = [
            threading.Thread(target=client, args=(i,))
            for i in range(a.clients)
        ]
        for t in threads:
            t.start()

        # hot-reloads racing the traffic, alternating checkpoints
        reloads = 0
        next_reload = time.time() + a.reload_every
        while time.time() < stop:
            time.sleep(1.0)
            if time.time() >= next_reload:
                st, out = http_json(port, "/v1/reload", {
                    "model_path": ckpt2 if reloads % 2 == 0 else ckpt,
                    "token": token,
                })
                assert st == 200, out
                reloads += 1
                bump("reload")
                next_reload += a.reload_every
        for t in threads:
            t.join(timeout=900)

        st, stats = http_json(port, "/stats")
        assert st == 200
        st, _ = http_json(port, "/healthz")
        assert st == 200
        assert not errors, errors[:5]
        assert stats["param_version"] == reloads, (stats, reloads)
        assert stats["requests_served"] > 0

        # --- graceful termination ---------------------------------------
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)

        summary = {
            "seconds": a.seconds,
            "clients": a.clients,
            **counts,
            "requests_served": stats["requests_served"],
            "batches_served": stats["batches_served"],
            "mean_batch_occupancy": round(stats["mean_batch_occupancy"], 2),
            "latency_ms_p50": stats["latency_ms_p50"],
            "latency_ms_p99": stats["latency_ms_p99"],
            "param_version": stats["param_version"],
            "sigterm_exit_code": rc,
            "errors": len(errors),
        }
        print(json.dumps(summary))
        assert rc == 0, f"server exited {rc} on SIGTERM"
        return summary
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


if __name__ == "__main__":
    main()
