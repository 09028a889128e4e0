"""HTTP gesture-generation server of the port, on the card.

A JSON API over the standard library's ThreadingHTTPServer; the device work
runs through the dynamic batcher (``serving.GestureBatcher``: batches padded
to ``max_batch``, per-sample guidance, text requests through the two-stage
composition in batches of their own). Port of the JAX package's
``scripts/serve.py``; it reads the same checkpoints (the flat ``.npz`` of
``save_params_npz`` and its ``args.json``).

    POST /v1/generate   {"audio": [f32...] | "audio_b64": base64 f32le,
                         "speaker": 0, "guidance": 1.5, "text": "...",
                         "emotion": 0, "long": false, "stream": false}
        -> {"motion": [[...]...], "shape": [J, F, T], "batch_size": n,
            "latency_ms": ...}
        "emotion" conditions BEAT models (num_emotions > 0 in args.json).
        "text" goes through the composition when the server has one
        (--sag_path); otherwise the answer says "text_ignored".
        "long": true covers the whole audio with one continuous stream of
        windows chained by their seed frames; with "stream": true the answer
        is chunked NDJSON, a line a window ({"window", "frames", "motion"}).
        503 + {"error": ...} when the queue is full or too many long
        requests are in flight.
    GET  /healthz       {"ok": true, "devices": [...]}
    GET  /stats         occupancy, pending/rejected, long_active, latency
                        p50/p95/p99, param_version
    GET  /metrics       the same numbers in Prometheus text format
    POST /v1/reload     {"model_path": "...npz", "token": "..."}
        Swaps the RAG weights between batches (same shapes, else 400).
        Disabled unless the server was started with --reload_token, and the
        request must carry the token (403 otherwise).

Run:

    python -m livelyspeaker_tpu_torch.scripts.serve --model_path ckpts/TED/RAG.npz --port 8000
    curl -s localhost:8000/v1/generate -d '{"audio": [0.0], "speaker": 3}'

It serves on the card and stops without one; ``--device cpu`` runs the plain
versions of the kernels on the CPU (for tests).
"""

from __future__ import annotations

import argparse
import base64
import hmac
import itertools
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..serving import GestureBatcher, ServerOverloaded

__all__ = ["make_handler", "build_server", "main"]


def _load_state_dict(path: str):
    from ..utils import convert
    from ..utils.checkpoints import load_params_npz

    return convert.jax_params_to_state_dict(load_params_npz(path))


def make_handler(batcher: GestureBatcher, reload_token: str = ""):
    """The request handler class of a server in front of ``batcher``."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # required for chunked streaming

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # no access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "devices": [str(batcher.device)]})
            elif self.path == "/stats":
                self._json(200, batcher.stats())
            elif self.path == "/metrics":
                counters = {"batches_served", "requests_served", "rejected"}
                lines = []
                for k, v in batcher.stats().items():
                    name = f"livelyspeaker_{k}"
                    lines.append(f"# TYPE {name} {'counter' if k in counters else 'gauge'}")
                    lines.append(f"{name} {float(v)}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def _reload(self):
            try:
                # read the body before any answer: an unread body would be
                # taken for the next request on a keep-alive connection
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                if not reload_token:
                    self._json(403, {"error": "reload disabled: start the server with "
                                              "--reload_token"})
                    return
                req = json.loads(body or b"{}")
                if not hmac.compare_digest(str(req.get("token", "")), reload_token):
                    self._json(403, {"error": "bad reload token"})
                    return
                version = batcher.reload_params(_load_state_dict(req["model_path"]))
                self._json(200, {"ok": True, "param_version": version,
                                 "model_path": req["model_path"]})
            except Exception as e:  # noqa: BLE001 (reported to the client)
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def _stream_long(self, gen, text_ignored: bool) -> None:
            # pull the first window before the status line: a rejected
            # admission must still be a clean 503
            first = next(gen, None)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(obj):
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            # the 200 is sent: an error from here on goes into the stream
            try:
                for w, chunk in itertools.chain([first] if first is not None else [], gen):
                    line = {"window": w, "frames": int(chunk.shape[-1]),
                            "motion": chunk.tolist()}
                    if w == 0 and text_ignored:
                        line["text_ignored"] = True
                    write_chunk(line)
            except Exception as e:  # noqa: BLE001
                try:
                    write_chunk({"error": f"{type(e).__name__}: {e}"})
                except OSError:
                    return  # the client went away
            self.wfile.write(b"0\r\n\r\n")

        def do_POST(self):
            if self.path == "/v1/reload":
                self._reload()
                return
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if "audio_b64" in req:
                    audio = np.frombuffer(base64.b64decode(req["audio_b64"]), np.float32)
                else:
                    audio = np.asarray(req.get("audio", []), np.float32)
                t0 = time.monotonic()
                kw = dict(speaker=int(req.get("speaker", 0)),
                          emotion=int(req.get("emotion", 0)),
                          guidance=float(req["guidance"]) if "guidance" in req else None)
                text_ignored = bool(req.get("text") and batcher.composition is None)
                if req.get("long"):
                    # one sentence for every window, as a short request has
                    sentences = [str(req["text"])] if req.get("text") else None
                    if req.get("stream"):
                        self._stream_long(batcher.long_form_stream(audio, sentences=sentences,
                                                                   **kw), text_ignored)
                        return
                    motion = batcher.long_form(audio, sentences=sentences, **kw)
                    batch_size = 1
                else:
                    r = batcher.submit(audio, text=req.get("text"), **kw)
                    motion = r.wait(timeout=float(req.get("timeout", 300.0)))
                    batch_size = r.batch_size
                resp = {"motion": motion.tolist(), "shape": list(motion.shape),
                        "batch_size": batch_size,
                        "latency_ms": (time.monotonic() - t0) * 1e3}
                if text_ignored:
                    resp["text_ignored"] = True
                self._json(200, resp)
            except ServerOverloaded as e:
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 (reported to the client)
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_path", type=str, required=True,
                   help="RAG parameters (.npz); args.json beside it gives the configuration")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="dispatched-but-uncollected batches that may queue; 0 finishes "
                        "each batch before the next")
    p.add_argument("--max_queue", type=int, default=128,
                   help="pending-request cap; beyond it requests get 503")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--timestep_respacing", type=str, default="ddim20")
    p.add_argument("--sampler", type=str, default="dpmpp",
                   choices=["ddpm", "ddim", "plms", "dpmpp"])
    p.add_argument("--no_fused", action="store_true",
                   help="run the eager modules instead of the fused TransMLP kernel")
    p.add_argument("--guidance", type=float, default=1.5)
    p.add_argument("--sag_path", type=str, default="",
                   help="SAG parameters (.npz): enables text requests (the composition)")
    p.add_argument("--clip_path", type=str, default="",
                   help="OpenAI CLIP checkpoint for the text tower (random weights without)")
    p.add_argument("--bpe_path", type=str, default="",
                   help="CLIP BPE vocabulary (the hash tokenizer without)")
    p.add_argument("--skip_steps", type=int, default=80)
    p.add_argument("--guidance_schedule", type=str, default=None,
                   help="per-step CFG decay for composition requests "
                        "('const'|'linear'|'cosine'|'step:<t0>')")
    p.add_argument("--composition_respacing", type=str, default="ddim100",
                   help="respacing of text requests' refinement, apart from "
                        "--timestep_respacing: --skip_steps counts steps of this grid")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="devices each batch is split over: the first N cards, or the CPU N "
                        "times with --device cpu (max_batch must be a multiple of it)")
    p.add_argument("--reload_token", type=str, default="",
                   help="enables POST /v1/reload for requests that carry this token")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the plain versions of the kernels on the CPU; "
                        "the default is the card")
    return p


def build_server(argv: Optional[List[str]] = None) -> Tuple[ThreadingHTTPServer, GestureBatcher]:
    """Load the checkpoints named by ``argv``, build the batcher (and the
    composition with ``--sag_path``), warm the plain and the text route
    through the batcher, and bind the HTTP server; ``serve_forever`` is the
    caller's."""
    from ..data import CLIPTokenizer, HashTokenizer
    from ..models import SAG, CLIPTextEncoder, RAG, RAGConfig
    from ..pipeline import LivelySpeakerPipeline
    from ..serving import ServeConfig, build_rag_server, serving_mesh
    from ..training.checkpoints import load_args
    from ..utils.convert import clip_text_state_dict_from_openai

    args = _parser().parse_args(argv)
    try:
        saved = load_args(args.model_path)
    except FileNotFoundError:
        saved = {}
    cfg = RAGConfig(
        njoints=saved.get("njoints", 9),
        nfeats=saved.get("nfeats", 3),
        nframes=saved.get("n_poses", 34),
        latent_dim=saved.get("latent_dim", 512),
        num_layers=saved.get("layers", 8),
        mlpact=saved.get("mlpact", "silu"),
        n_speakers=saved.get("n_speakers", 1400),
        num_emotions=saved.get("num_emotions", 0),
        cond_mask_prob=saved.get("cond_mask_prob", 0.1),
    )
    model = RAG(cfg)
    model.load_state_dict(_load_state_dict(args.model_path))
    serve_cfg = ServeConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        default_guidance=args.guidance,
        steps=args.steps,
        timestep_respacing=args.timestep_respacing or None,
        sampler=args.sampler,
        use_fused=not args.no_fused,
        pipeline_depth=args.pipeline_depth,
        data_parallel=args.data_parallel,
    )
    try:
        # one mesh for the batcher's sampler and the composition: text
        # batches shard exactly like plain ones
        mesh = serving_mesh(serve_cfg, args.device)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"--data_parallel {args.data_parallel}: {e}") from e
    device = None if mesh is not None else args.device

    composition = None
    if args.sag_path:
        sag = SAG(njoints=cfg.njoints, nfeats=cfg.nfeats, latent_dim=512)
        sag.load_state_dict(_load_state_dict(args.sag_path))
        if args.clip_path:
            clip = CLIPTextEncoder()
            sd = torch.load(args.clip_path, map_location="cpu", weights_only=False)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            clip.load_state_dict(clip_text_state_dict_from_openai(sd, layers=clip.cfg.layers))
        else:
            clip = CLIPTextEncoder(generator=torch.Generator().manual_seed(1))
        tok = CLIPTokenizer(args.bpe_path) if args.bpe_path else HashTokenizer()
        # the refinement drives the batcher's RAG module, so a reload
        # reaches both
        composition = LivelySpeakerPipeline(
            model, sag, clip, tok, steps=args.steps,
            timestep_respacing=args.composition_respacing, skip_timesteps=args.skip_steps,
            guidance_schedule=args.guidance_schedule, use_fused=not args.no_fused,
            device=device, mesh=mesh)
        n_spaced = composition.rag_sampler.sched.num_timesteps
        if not 0 < n_spaced - args.skip_steps:
            raise SystemExit(
                f"--skip_steps {args.skip_steps} leaves no refinement steps on the "
                f"{args.composition_respacing} grid ({n_spaced} steps); lower --skip_steps "
                "or use a finer --composition_respacing")

    batcher = build_rag_server(model, serve_cfg, composition=composition, device=device,
                               mesh=mesh)
    try:
        # warm both routes through the batcher (cuBLAS, cuDNN, the kernel's
        # build and the allocator) before the first client waits on them
        batcher.generate(np.zeros(16000, np.float32), timeout=3600.0)
        if composition is not None:
            batcher.generate(np.zeros(16000, np.float32), text="warmup", timeout=3600.0)
        srv = ThreadingHTTPServer((args.host, args.port),
                                  make_handler(batcher, reload_token=args.reload_token))
    except BaseException:
        batcher.close()
        raise
    return srv, batcher


def main(argv: Optional[List[str]] = None) -> None:
    srv, batcher = build_server(argv)
    host, port = srv.server_address[:2]
    print(f"warm; serving on http://{host}:{port}", flush=True)

    def _shutdown(signum, frame):  # SIGTERM: stop accepting, then drain
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        batcher.close()
        print("server stopped; batcher closed")


if __name__ == "__main__":
    main()
