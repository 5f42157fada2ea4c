"""The port's command-line tools and HTTP server on the tiny model, on the
CPU (`--device cpu`; the kernels' plain versions run), in-process:

- `main`: text -> WAV with the progress and timing lines, its audio the
  library's for the same seed; `--long`; `--save-voice` then `-v`; a
  missing model; `quantize` (files byte-equal to bark_tpu's CLI's, a bad
  type refused); `voice info` and `voice from-wav` (the preset the
  library makes from the same waveform); `convert` on a synthetic HF
  snapshot (the file the library writes);
- every tool that runs the model refuses to start on `--device cuda`
  (the default) when PyTorch sees no GPU, and loads nothing;
- the server on `ThreadingHTTPServer(("127.0.0.1", 0))`: `/bark`, the
  chunked stream, long-form (plain and streamed), `/health`, `/voices`,
  `/progress` (read from inside the generation, at each callback, so no
  test waits on a clock), the web root, its errors, `ProgressStore`'s
  bounds, and
  `BatchWorker` with a batch over the batched kernels' lane cap (split
  into groups) and its per-request fallback."""

import json
import os
import struct
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import bark_tpu_torch
from bark_tpu.cli import quantize as jquantize_cli
from bark_tpu_torch import params as tparams
from bark_tpu_torch.api import context as tcontext
from bark_tpu_torch.cli import convert as convert_cli
from bark_tpu_torch.cli import main as main_cli
from bark_tpu_torch.cli import precompile as precompile_cli
from bark_tpu_torch.cli import quantize as quantize_cli
from bark_tpu_torch.cli import server as srv
from bark_tpu_torch.cli import voice as voice_cli
from bark_tpu_torch.io import ggml
from bark_tpu_torch.kernels import bdecode as kbdec
from bark_tpu_torch.pipeline import voice as tvoice
from bark_tpu_torch.utils.wav import read_wav, write_wav

import torch_jax_reference as ref
from test_torch_e2e import one_torch_thread
from test_torch_streaming import make_voice
from tiny_model import tiny_params

CPU = ["--device", "cpu"]
SAMPLES = 18 * 320  # the tiny params' 12 semantic steps: 18 frames


@pytest.fixture
def tiny_cli_params(monkeypatch):
    """The CLIs' BarkContextParams take the tiny model's token space (the
    tools build the default params, which do not fit the tiny model)."""
    monkeypatch.setattr(tparams, "BarkContextParams",
                        lambda **kw: tiny_params(**kw))


def run_main(capsys, *argv):
    rc = main_cli.main([*argv, *CPU, "--dtype", "float32"])
    return rc, capsys.readouterr().err


def test_main_writes_the_librarys_audio(tiny_cli_params, tmp_path, capsys):
    out = str(tmp_path / "out.wav")
    rc, err = run_main(capsys, "-m", ref.weights(), "-p", "hello world",
                       "-s", "3", "-o", out)
    assert rc == 0, err
    for line in ("Generating semantic tokens: 100%",
                 "Generating coarse tokens: 100%",
                 "Generating fine tokens: 100%", f"Wrote {SAMPLES} frames",
                 "semantic time", "load time", "eval time", "total time"):
        assert line in err, line
    audio, sr = read_wav(out)
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                         seed=3, device="cpu")
    assert ctx.generate_audio("hello world")
    assert sr == 24000
    np.testing.assert_array_equal(audio, ctx.get_audio_data())


def test_main_long_and_voices(tiny_cli_params, tmp_path, capsys):
    """--long over two sentences, --save-voice, then the saved voice
    passed back with -v."""
    out, preset = str(tmp_path / "long.wav"), str(tmp_path / "v.npz")
    rc, err = run_main(capsys, "-m", ref.weights(), "-p",
                       "hello world. the a!", "--long", "-o", out,
                       "--save-voice", preset, "--no-progress")
    assert rc == 0, err
    assert "Generating" not in err and f"Saved voice preset to {preset}" \
        in err
    audio, _ = read_wav(out)
    assert audio.shape == (2 * SAMPLES + 6000,)
    assert not audio[SAMPLES:SAMPLES + 6000].any()
    assert tvoice.load_voice_preset(preset).fine.shape == (8, 18)
    rc, err = run_main(capsys, "-m", ref.weights(), "-p", "hello", "-v",
                       preset, "-o", out)
    assert rc == 0, err
    assert read_wav(out)[0].shape == (SAMPLES,)


def test_main_missing_model(tmp_path, capsys):
    rc, err = run_main(capsys, "-m", str(tmp_path / "nope.bin"))
    assert rc == 1 and "failed to load model" in err


@pytest.mark.parametrize("tool", ["main", "voice", "server", "precompile"])
def test_tools_refuse_a_missing_gpu(tool, tmp_path, capsys, monkeypatch):
    """`--device cuda`, the default: without a GPU each tool that runs the
    model stops with a message before loading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tcontext, "bark_load_model",
                        lambda *a, **kw: pytest.fail("loaded a model"))
    wav = str(tmp_path / "a.wav")
    write_wav(wav, np.zeros(3200, np.float32))
    argv = {"main": ["-m", ref.weights()],
            "voice": ["from-wav", wav, "-m", ref.weights(), "-o",
                      str(tmp_path / "v.npz")],
            "server": ["-m", ref.weights(), "-P", "0"],
            "precompile": ["-m", ref.weights()]}[tool]
    module = {"main": main_cli, "voice": voice_cli, "server": srv,
              "precompile": precompile_cli}[tool]
    assert module.main(argv) == 1
    assert "no CUDA GPU is available" in capsys.readouterr().err
    assert not (tmp_path / "v.npz").exists()


@pytest.mark.parametrize("qtype", ["q4_0", "q5_1", "q8_0"])
def test_quantize_cli_equals_bark_tpus(qtype, tmp_path, capsys):
    out, jout = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    assert quantize_cli.main([ref.weights(), out, qtype]) == 0
    assert "quantize time" in capsys.readouterr().err
    assert jquantize_cli.main([ref.weights(), jout, qtype]) == 0
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    ftype = ggml.read_model_file(out).coarse.hparams.base_ftype
    assert ftype == quantize_cli.FTYPE_BY_NAME[qtype]


def test_quantize_cli_refuses(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        quantize_cli.main([ref.weights(), str(tmp_path / "q.bin"), "q9_9"])
    assert e.value.code == 2  # argparse rejects the choice
    assert quantize_cli.main([str(tmp_path / "nope.bin"),
                              str(tmp_path / "q.bin"), "q4_0"]) == 1
    assert "quantize: failed" in capsys.readouterr().err


def test_voice_cli_info_and_from_wav(tmp_path, capsys):
    preset = make_voice()
    path = str(tmp_path / "v.npz")
    tvoice.save_voice_preset(path, preset)
    assert voice_cli.main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "semantic_prompt: 40 tokens" in out and "60 frames" in out
    wav = str(tmp_path / "a.wav")
    audio = (0.3 * np.sin(np.arange(320 * 12 + 7) * 0.05)).astype(np.float32)
    write_wav(wav, audio)
    made = str(tmp_path / "made.npz")
    assert voice_cli.main(["from-wav", wav, "-m", ref.weights(), "-o", made,
                           "--semantic-from", path, *CPU]) == 0
    assert f"Wrote {made}: 13 frames" in capsys.readouterr().err
    got = tvoice.load_voice_preset(made)
    ctx = bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                         device="cpu")
    want = tvoice.preset_from_audio(ctx.codec_params, audio, ctx.params,
                                    semantic_donor=preset)
    for k in ("semantic", "coarse", "fine"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_convert_cli(tmp_path, capsys):
    """The CLI on a synthetic HF snapshot writes the file the library
    writes; the port's files read back, and a missing dir is refused."""
    from test_torch_shared_copies import hf_snapshot

    snap = hf_snapshot(tmp_path / "hf")
    assert convert_cli.main(["--dir-model", str(snap), "--out-dir",
                             str(tmp_path / "out")]) == 0
    assert "convert: wrote" in capsys.readouterr().err
    from bark_tpu_torch.io.convert import convert

    want = convert(str(snap), str(tmp_path / "lib.bin"))
    with open(tmp_path / "out" / "ggml_weights.bin", "rb") as a, \
            open(want, "rb") as b:
        assert a.read() == b.read()
    assert ggml.read_model_file(want).fine.hparams.n_wtes == 8
    assert convert_cli.main(["--dir-model", str(tmp_path / "nope")]) == 1


# ------------------------------------------------------------ the server


class SignallingLock:
    """The server's one generation lock, which also tells a test that a
    thread reached it (`waiting`)."""

    def __init__(self):
        self.lock, self.waiting = threading.Lock(), threading.Event()

    def __enter__(self):
        self.waiting.set()
        self.lock.acquire()
        return self

    def __exit__(self, *exc):
        self.lock.release()


def serve(ctx, lock=None, **kw):
    """The port's handler on a free localhost port: (base url, server)."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(
        ctx, lock or threading.Lock(), 1, **kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd


def call(url, payload=None, raw=None):
    """(status, body) of a GET (no payload) or a POST of JSON."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def pcm(body: bytes, streamed: bool = False) -> np.ndarray:
    """The samples of a WAV reply (58-byte header; a stream's is 46 bytes,
    with no fact chunk, and unknown sizes)."""
    if streamed:
        assert struct.unpack("<I", body[4:8])[0] == 0xFFFFFFFF
    return np.frombuffer(body[46 if streamed else 58:], "<f4")


@pytest.fixture(scope="module")
def context():
    return bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                          seed=0, device="cpu")


@pytest.fixture(scope="module")
def server(context):
    url, httpd = serve(context)
    yield url
    httpd.shutdown()


def test_server_bark_and_stream(server):
    code, body = call(server + "/bark", {"text": "hello world"})
    assert code == 200 and body[:4] == b"RIFF"
    audio = pcm(body)
    assert audio.shape == (SAMPLES,) and np.isfinite(audio).all()
    code, body = call(server + "/bark", {"text": "hello world",
                                         "stream": True})
    assert code == 200 and body[:4] == b"RIFF"
    assert pcm(body, streamed=True).shape == (SAMPLES,)


@pytest.mark.parametrize("stream", [False, True])
def test_server_long_form(server, stream):
    code, body = call(server + "/bark", {"text": "Hello world. The a!",
                                         "long": True, "stream": stream})
    assert code == 200
    audio = pcm(body, streamed=stream)
    assert audio.shape == (2 * SAMPLES + 6000,)
    assert not audio[SAMPLES:SAMPLES + 6000].any()


def test_server_health_and_voices(server, context, tmp_path):
    code, body = call(server + "/health")
    h = json.loads(body)
    assert code == 200 and h["status"] == "ok" and h["device"] == "cpu"
    assert h["model"] == {"semantic": "2L/32D", "compute_dtype": "float32",
                          "packed": {"semantic": False, "coarse": False,
                                     "fine": False}}
    assert h["batching"] is None and h["failed"] == 0
    before = h["requests"]
    assert call(server + "/bark", {"text": "hello"})[0] == 200
    assert json.loads(call(server + "/health")[1])["requests"] == before + 1
    assert json.loads(call(server + "/voices")[1]) == {"voices": []}

    tvoice.save_voice_preset(str(tmp_path / "speaker_a.npz"), make_voice())
    tvoice.save_voice_preset(str(tmp_path / "b.npz"), make_voice(seed=2))
    (tmp_path / "notes.txt").write_text("not a preset")
    url, httpd = serve(context, voices_dir=str(tmp_path))
    try:
        assert json.loads(call(url + "/voices")[1]) == {
            "voices": ["b.npz", "speaker_a.npz"]}
        code, body = call(url + "/bark", {"text": "hello world",
                                          "voice": "speaker_a.npz"})
        assert code == 200 and pcm(body).shape == (SAMPLES,)
        code, body = call(url + "/bark", {"text": "hi", "voice": "x.npz"})
        assert code == 400 and b"unknown voice" in body
    finally:
        httpd.shutdown()


def test_server_errors(server):
    assert call(server + "/")[0] == 200
    code, body = call(server + "/bark", raw=b"not json")
    assert code == 400 and b"invalid JSON" in body
    code, body = call(server + "/bark", {"nope": 1})
    assert code == 400 and b"text" in body
    code, body = call(server + "/bark", {"text": "hi", "voice": "x.npz"})
    assert code == 400 and b"voices-dir" in body
    assert call(server + "/nothere", {})[0] == 404
    assert call(server + "/progress?id=unknown")[0] == 404


def test_server_web_root(context):
    """GET / serves the browser demo from the web root, its other files by
    basename only (no path out of the root)."""
    web = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "web")
    url, httpd = serve(context, web_root=web)
    try:
        code, body = call(url + "/")
        assert code == 200 and b'fetch("/bark"' in body
        code, body = call(url + "/sw.js")
        assert code == 200 and b"caches.open" in body
        for bad in ("/../setup.py", "/%2e%2e/secrets"):
            assert call(url + bad)[0] == 404, bad
    finally:
        httpd.shutdown()


def test_server_progress(context):
    """A request with an id: "queued" while it waits for the lock, each
    stage's progress as the generation reports it (read over HTTP from
    inside the callback), then "done", which the final read removes."""
    lock, rid = SignallingLock(), "r-1"
    url, httpd = serve(context, lock)
    seen, real = [], context._progress

    def progress(step, percent):
        real(step, percent)
        seen.append(json.loads(call(url + f"/progress?id={rid}")[1]))

    context._progress = progress
    reply = {}
    t = threading.Thread(target=lambda: reply.update(
        r=call(url + "/bark", {"text": "hello", "id": rid})))
    try:
        with lock.lock:  # the request waits for it
            t.start()
            lock.waiting.wait(timeout=300)
            assert json.loads(call(url + f"/progress?id={rid}")[1]) == {
                "stage": "queued", "percent": 0}
        t.join(timeout=300)
        assert reply["r"][0] == 200
        assert json.loads(call(url + f"/progress?id={rid}")[1]) == {
            "stage": "done", "percent": 100}
        assert call(url + f"/progress?id={rid}")[0] == 404
    finally:
        del context._progress
        httpd.shutdown()
    assert seen[0] == {"stage": "semantic", "percent": 0}
    assert {s["stage"] for s in seen} == {"semantic", "coarse", "fine"}
    assert seen[-1]["percent"] == 100


def test_batch_worker_splits_a_batch_over_the_lane_cap(context,
                                                       monkeypatch):
    """Three concurrent requests in one batch of the worker (its window
    long; a full batch leaves at once) over a lane cap of 2: one
    generate_audio_batch of 3 in groups of 2 and 1, each reply its lane's
    audio, and no fallback."""
    monkeypatch.setattr(kbdec, "MAX_LANES", 2)
    groups, real = [], context._generate_group

    def group(texts, presets, first):
        groups.append((len(texts), first))
        return real(texts, presets, first)

    monkeypatch.setattr(context, "_generate_group", group)
    worker = srv.BatchWorker(context, 3, 600_000.0)
    url, httpd = serve(context, worker.lock, batcher=worker)
    texts = ["hello world", "the a", "world hello the"]
    replies = {}
    try:
        threads = [threading.Thread(target=lambda t=t: replies.update(
            {t: call(url + "/bark", {"text": t})})) for t in texts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        health = json.loads(call(url + "/health")[1])
    finally:
        httpd.shutdown()
    assert groups == [(2, 0), (1, 2)] and worker.fallbacks == 0
    assert health["batching"] == {"max_batch": 3, "window_ms": 600_000.0,
                                  "queue_depth": 0}
    for t in texts:
        code, body = replies[t]
        assert code == 200 and pcm(body).shape == (SAMPLES,)


def test_batch_worker_falls_back_per_request():
    """One poisoned request fails the batch: the worker counts the
    fallback and retries each request alone, so the others get audio."""
    class Stub:
        generated_audio = np.ones(16, np.float32)

        def generate_audio_batch(self, texts):
            if "poison" in texts:
                raise RuntimeError("bad request in batch")
            return [np.ones(16, np.float32) for _ in texts]

        def generate_audio(self, text):
            if text == "poison":
                raise RuntimeError("bad request")
            return True

    worker = srv.BatchWorker(Stub(), max_batch=3, window_ms=600_000.0)
    results = {}
    threads = [threading.Thread(target=lambda t=t: results.update(
        {t: worker.submit(t)})) for t in ("good-1", "poison", "good-2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results["poison"] is None and worker.fallbacks == 1
    assert results["good-1"].size == results["good-2"].size == 16


def test_progress_store_ttl_and_cap(monkeypatch):
    store = srv.ProgressStore(ttl_s=100.0, cap=5)
    now = [1000.0]
    monkeypatch.setattr(srv._time, "monotonic", lambda: now[0])
    for i in range(8):  # the cap evicts the oldest
        store.set(f"r{i}", {"stage": "queued", "percent": 0})
    assert len(store) == 5
    assert store.get("r0") is None and store.get("r7") is not None
    now[0] += 101.0  # everything expires
    assert store.get("r7") is None and len(store) == 0
    store.set("live", {"stage": "semantic", "percent": 50})
    now[0] += 50.0
    assert store.get("live")["percent"] == 50
