"""HTTP server of the PyTorch port: POST /bark {"text": ...} -> audio/wav.

The counterpart of `bark_tpu.cli.server`, on the port's context and the
card (`--device`, default cuda; it refuses to start without a GPU unless
given `--device cpu`):

    python -m bark_tpu_torch.cli.server -m ggml_weights.bin --batch 40

Mirrors examples/server/server.cpp:96-188: model loaded once at startup,
`GET /` placeholder, `POST /bark` parses JSON, generates under a global lock
(the reference serializes with a mutex), responds with an IEEE-float WAV.
Unlike the reference it streams from memory instead of bouncing through
/tmp/bark_tmp.wav, and returns proper 4xx errors for malformed requests.

Beyond-reference: `--batch N` turns on request batching — concurrent
requests arriving within `--batch-window-ms` are generated together through
the batched pipeline (BarkContext.generate_audio_batch: the batched
kernels K8-K10, in groups of 32 lanes for a larger N), amortizing the
weight streaming across up to N requests. The reference server can only
serialize (SURVEY §2.10).
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ProgressStore:
    """Bounded request-id -> progress-state map.

    Entries normally die on the final read after completion, but a client
    that fires a request with an "id" and never polls must not leak its
    entry: entries expire after `ttl_s`, and the store is hard-capped at
    `cap` entries (oldest evicted first). All methods are thread-safe.
    """

    def __init__(self, ttl_s: float = 600.0, cap: int = 256):
        self.ttl_s = ttl_s
        self.cap = cap
        self._lock = threading.Lock()
        self._d: "dict[str, tuple[float, dict]]" = {}

    def _prune_locked(self):
        now = _time.monotonic()
        dead = [k for k, (ts, _) in self._d.items() if now - ts > self.ttl_s]
        for k in dead:
            del self._d[k]
        while len(self._d) > self.cap:
            oldest = min(self._d, key=lambda k: self._d[k][0])
            del self._d[oldest]

    def set(self, rid: str, state: dict):
        with self._lock:
            self._d[rid] = (_time.monotonic(), state)
            self._prune_locked()

    def get(self, rid: str):
        with self._lock:
            self._prune_locked()
            entry = self._d.get(rid)
            return entry[1] if entry is not None else None

    def pop(self, rid: str):
        with self._lock:
            self._d.pop(rid, None)

    def __len__(self):
        with self._lock:
            return len(self._d)


class BatchWorker:
    """Collects concurrent requests into batches for generate_audio_batch.

    Generation holds the server's global ctx lock: voice/long/stream
    requests bypass the batcher and generate under that lock, so the
    batcher must serialize against them — the context's token buffers and
    stats are per-context, not per-call.
    """

    def __init__(self, ctx, max_batch: int, window_ms: float,
                 lock: "threading.Lock | None" = None):
        self.ctx = ctx
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.lock = lock if lock is not None else threading.Lock()
        # batches that failed as a whole and were retried request by
        # request (each such batch also prints a line to stderr)
        self.fallbacks = 0
        self.q: "queue.Queue[tuple]" = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, text: str):
        """Blocking: returns the PCM array (or None on failure)."""
        done = threading.Event()
        slot = {}
        self.q.put((text, slot, done))
        done.wait()
        return slot.get("audio")

    def _generate(self, texts):
        """One batch, with per-request error isolation: if the batched
        pipeline fails as a whole, fall back to generating each request
        individually so one poisoned request cannot 500 its batchmates."""
        try:
            with self.lock:
                return self.ctx.generate_audio_batch(texts)
        except Exception as e:
            self.fallbacks += 1
            print(f"server: batch generation failed ({e}); retrying "
                  f"requests individually", file=sys.stderr)
        outs = []
        for text in texts:
            try:
                with self.lock:
                    ok = self.ctx.generate_audio(text)
                    outs.append(
                        self.ctx.generated_audio.copy() if ok else None
                    )
            except Exception as e:
                print(f"server: request failed: {e}", file=sys.stderr)
                outs.append(None)
        return outs

    def _run(self):
        while True:
            batch = [self.q.get()]
            # fill until the batch is full or the window closes; a full
            # batch dispatches immediately instead of sleeping out the window
            deadline = _time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            outs = self._generate([b[0] for b in batch])
            for (_, slot, done), audio in zip(batch, outs):
                slot["audio"] = audio
                done.set()


class Server(ThreadingHTTPServer):
    """ThreadingHTTPServer whose listen backlog holds a batch's worth of
    clients connecting at once (the default of 5 resets the connections
    past it)."""

    request_queue_size = 256


def device_name(ctx) -> str:
    """The context's device for /health: "cuda:<the card's name>" or
    "cpu"."""
    import torch

    if ctx.device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(ctx.device)}"
    return ctx.device.type


def make_handler(ctx, lock: threading.Lock, n_threads: int,
                 batcher: "BatchWorker | None" = None,
                 web_root: str = "", voices_dir: str = ""):
    from bark_tpu_torch.api import context as api
    from bark_tpu_torch.params import EncodingStep
    from bark_tpu_torch.utils.wav import wav_bytes, wav_stream_header

    # request-id -> {"stage", "percent"}; written by the generation
    # callback, read by GET /progress?id=... (the browser demo's per-stage
    # progress bar — the reference's wasm helpers.js shows progress the
    # same way). Bounded: the final read after completion cleans up, and a
    # TTL + hard cap cover clients that never poll (see ProgressStore).
    progress_store = ProgressStore()
    step_names = {int(s): s.name.lower() for s in EncodingStep}

    started = _time.monotonic()
    counters = {"requests": 0, "failed": 0}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # the reference uses 600 s read/write timeouts (server.cpp:29-30)
        timeout = 600

        def log_message(self, fmt, *args):
            print(f"server: {fmt % args}", file=sys.stderr)

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj):
            self._reply(
                code, json.dumps(obj).encode(), "application/json"
            )

        def do_GET(self):
            if self.path.startswith("/progress"):
                from urllib.parse import parse_qs, urlparse

                rid = parse_qs(urlparse(self.path).query).get("id", [""])[0]
                state = progress_store.get(rid)
                if state is None:
                    self._reply_json(404, {"error": "unknown request id"})
                else:
                    if state.get("stage") == "done":
                        progress_store.pop(rid)  # final read cleans up
                    self._reply_json(200, state)
                return
            if self.path == "/health":
                # liveness + serving config + lifetime counters; eval stats
                # are the context's cumulative bark_statistics mirror
                self._reply_json(200, {
                    "status": "ok",
                    "uptime_s": round(_time.monotonic() - started, 1),
                    "device": device_name(ctx),
                    "model": {
                        "semantic": f"{ctx.semantic_cfg.n_layer}L/"
                                    f"{ctx.semantic_cfg.n_embd}D",
                        "compute_dtype": ctx.params.compute_dtype,
                        "packed": {
                            stage: "wte_q" in getattr(ctx, f"{stage}_params")
                            for stage in ("semantic", "coarse", "fine")},
                    },
                    "batching": (
                        {"max_batch": batcher.max_batch,
                         "window_ms": batcher.window_s * 1e3,
                         "queue_depth": batcher.q.qsize()}
                        if batcher is not None else None
                    ),
                    "requests": counters["requests"],
                    "progress_entries": len(progress_store),
                    "failed": counters["failed"],
                    "load_time_ms": round(ctx.get_load_time() / 1e3, 1),
                })
                return
            if self.path == "/voices":
                # names accepted in POST /bark's "voice" field; [] when the
                # server has no --voices-dir
                import os

                names = []
                if voices_dir:
                    try:
                        names = sorted(
                            n for n in os.listdir(voices_dir)
                            if n.endswith(".npz")
                        )
                    except OSError:
                        pass
                self._reply_json(200, {"voices": names})
                return
            if self.path == "/" or (web_root and "/" not in self.path[1:]):
                # static serving from --web root (index.html at /, plus the
                # demo's sw.js service worker etc.); basename-only paths, so
                # requests cannot traverse the filesystem
                if web_root:
                    import os

                    name = "index.html" if self.path == "/" else self.path[1:]
                    page = os.path.join(web_root, os.path.basename(name))
                    # only the file read is guarded: a send error (client
                    # gone) must not fall through to a second response
                    try:
                        with open(page, "rb") as fh:
                            body = fh.read()
                    except OSError:
                        body = None
                    if body is not None:
                        ctype = {
                            ".html": "text/html",
                            ".js": "text/javascript",
                            ".css": "text/css",
                        }.get(os.path.splitext(page)[1], "application/octet-stream")
                        self._reply(200, body, ctype)
                        return
                if self.path == "/":
                    self._reply(
                        200,
                        b"<html><body><h1>bark-tpu-torch server</h1>"
                        b"<p>POST /bark with {\"text\": ...}</p></body></html>",
                        "text/html",
                    )
                else:
                    self._reply_json(404, {"error": "not found"})
            else:
                self._reply_json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/bark":
                self._reply_json(404, {"error": "not found"})
                return
            counters["requests"] += 1
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._reply_json(400, {"error": "invalid JSON body"})
                return
            text = payload.get("text")
            if not isinstance(text, str) or not text:
                self._reply_json(
                    400, {"error": 'missing required string field "text"'}
                )
                return
            try:
                voice = self._resolve_voice(payload.get("voice"))
            except ValueError as e:
                self._reply_json(400, {"error": str(e)})
                return

            rid = payload.get("id")
            if rid is not None and not isinstance(rid, str):
                self._reply_json(400, {"error": '"id" must be a string'})
                return
            if rid:
                progress_store.set(rid, {"stage": "queued", "percent": 0})

            long_form = bool(payload.get("long"))
            if payload.get("stream"):
                self._stream(text, voice, rid, long_form)
                return

            if batcher is not None and voice is None and not long_form:
                # the batched pipeline has no per-request callbacks; an id
                # still resolves, reporting queued -> done
                audio = batcher.submit(text)
                if rid:
                    progress_store.set(
                        rid, {"stage": "done", "percent": 100}
                    )
                if audio is None or audio.size == 0:
                    counters["failed"] += 1
                    self._reply_json(500, {"error": "generation failed"})
                    return
            else:
                # serialize like the reference mutex (server.cpp:130)
                with lock:
                    old_cb = ctx.params.progress_callback
                    if rid:
                        ctx.params.progress_callback = (
                            lambda c, step, pct, ud: progress_store.set(
                                rid,
                                {"stage": step_names.get(int(step), "?"),
                                 "percent": int(pct)},
                            )
                        )
                    try:
                        if long_form:
                            # sentence-chained long-form script generation
                            ok = ctx.generate_audio_long(text, voice=voice)
                        else:
                            ok = api.bark_generate_audio(
                                ctx, text, n_threads, voice=voice
                            )
                    finally:
                        ctx.params.progress_callback = old_cb
                        if rid:
                            progress_store.set(
                                rid, {"stage": "done", "percent": 100}
                            )
                    if not ok:
                        counters["failed"] += 1
                        self._reply_json(500, {"error": "generation failed"})
                        return
                    audio = api.bark_get_audio_data(ctx).copy()

            self._reply(
                200, wav_bytes(audio, ctx.params.sample_rate), "audio/wav"
            )

        def _resolve_voice(self, name):
            """Look a requested voice up in --voices-dir (basename only —
            requests must not traverse the filesystem)."""
            if name is None:
                return None
            import os

            if not voices_dir:
                raise ValueError("server has no --voices-dir configured")
            if not isinstance(name, str) or os.path.basename(name) != name:
                raise ValueError("voice must be a bare preset filename")
            path = os.path.join(voices_dir, name)
            if not os.path.exists(path):
                raise ValueError(f"unknown voice {name!r}")
            return path

        def _stream(self, text, voice, rid=None, long_form=False):
            """Chunked-transfer WAV: audio flows as coarse windows complete
            (BarkContext.generate_audio_stream) instead of after the whole
            utterance. A request id additionally publishes per-stage
            progress (the stream path reports it per window)."""
            import numpy as np

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(b: bytes):
                self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

            try:
                chunk(wav_stream_header(ctx.params.sample_rate))
                with lock:
                    old_cb = ctx.params.progress_callback
                    if rid:
                        ctx.params.progress_callback = (
                            lambda c, step, pct, ud: progress_store.set(
                                rid,
                                {"stage": step_names.get(int(step), "?"),
                                 "percent": int(pct)},
                            )
                        )
                    try:
                        gen = (
                            ctx.generate_audio_stream_long(text, voice=voice)
                            if long_form
                            else ctx.generate_audio_stream(text, voice=voice)
                        )
                        for pcm in gen:
                            chunk(
                                np.ascontiguousarray(pcm, "<f4").tobytes()
                            )
                    finally:
                        ctx.params.progress_callback = old_cb
                        if rid:
                            progress_store.set(
                                rid, {"stage": "done", "percent": 100}
                            )
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                print("server: stream client disconnected", file=sys.stderr)

    return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bark-tpu-torch-server")
    ap.add_argument("-m", "--model", default="./ggml_weights.bin")
    ap.add_argument("-H", "--host", default="127.0.0.1")
    ap.add_argument("-P", "--port", type=int, default=8080)
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=0,
                    help="max requests generated together (0 = serialize "
                         "like the reference)")
    ap.add_argument("--batch-window-ms", type=float, default=50.0,
                    help="how long the batcher waits to fill a batch")
    ap.add_argument("--web", default="",
                    help="directory with an index.html to serve at GET / "
                         "(e.g. examples/web — the browser demo)")
    ap.add_argument("--voices-dir", default="",
                    help="directory of .npz speaker presets selectable via "
                         'the request\'s "voice" field')
    ap.add_argument("--packed", action="store_true",
                    help="serve quantized weights packed on the card, "
                         "decoded by the packed kernels (requires a "
                         "q4/q5/q8 model) — same flag as cli/main.py")
    ap.add_argument("--kv", default="params", choices=["params", "int8"],
                    help="KV-cache storage dtype; int8 pays off for "
                         "batched serving (see README)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default), or cpu for the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)

    from bark_tpu_torch.cli import device_error

    err = device_error(args.device)
    if err:
        print(f"server: {err}", file=sys.stderr)
        return 1

    from bark_tpu_torch.api import context as api
    from bark_tpu_torch.params import BarkContextParams

    print(f"server: loading model from {args.model}", file=sys.stderr)
    params = BarkContextParams(compute_dtype=args.dtype,
                               dequantize_on_load=not args.packed,
                               kv_cache_dtype=args.kv)
    ctx = api.bark_load_model(args.model, params, args.seed,
                              device=args.device)
    print(
        f"server: model loaded in "
        f"{api.bark_get_load_time(ctx) / 1000.0:.0f} ms",
        file=sys.stderr,
    )

    # one lock serializes ALL generation on the context: the batcher's
    # batches and the voice/long/stream requests that bypass it
    lock = threading.Lock()
    batcher = BatchWorker(ctx, args.batch, args.batch_window_ms, lock) \
        if args.batch > 0 else None
    if batcher:
        print(f"server: batching up to {args.batch} requests "
              f"({args.batch_window_ms:.0f} ms window)", file=sys.stderr)
    handler = make_handler(ctx, lock, args.threads, batcher,
                           web_root=args.web, voices_dir=args.voices_dir)
    httpd = Server((args.host, args.port), handler)
    print(f"server: listening on http://{args.host}:{args.port}",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("server: shutting down", file=sys.stderr)
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
