"""bark_tpu's runs that the port's tests of voices, filters, the stepped
path, streaming and long-form (tests/test_torch_voice.py,
test_torch_filters.py, test_torch_stepped.py, test_torch_streaming.py,
test_torch_longform.py) hold the port against, shared by those modules
within one process.

One tiny weights file of each kind (f32, and q8_0 quantized by the port's
`bark_model_quantize`) and one bark_tpu context that serves both.
bark_tpu keys its programs by temp, top_k, top_p, the step counts and the
coarse window (sliding_window_size), so a request at new params compiles
only the programs those params change, and
a program compiled for one module serves the next. Its programs take the
weights as arguments, and bark_tpu loads the q8_0 file dequantized, into
arrays of the f32 file's shapes and dtypes: a request on the q8_0 file
runs the same context with that file's arrays in place of its own, and
compiles nothing more. Before each request the context's key restarts at
the request's seed, so `test_torch_e2e.replay_bark_tpu_noise(seed)`
replays its noise into the port."""

import atexit
import dataclasses
import functools
import shutil
import tempfile

import jax
import numpy as np

import bark_tpu
import bark_tpu_torch
from bark_tpu.io import ggml

from tiny_model import build_tiny_model, tiny_params

# the params a request may set; every other field stays tiny_params()'s
REQUEST_PARAMS = ("temp", "fine_temp", "top_k", "top_p",
                  "n_steps_text_encoder", "detailed_stats",
                  "sliding_window_size")


@functools.lru_cache(maxsize=None)
def weights(kind: str = "f32") -> str:
    """The tiny model's file: "f32", or "q8_0" (MOSTLY_Q8_0, which
    bark_tpu dequantizes at load and the port may load packed)."""
    d = tempfile.mkdtemp(prefix="bark_tiny_")
    atexit.register(shutil.rmtree, d, True)
    path = f"{d}/w.bin"
    ggml.write_model_file(path, build_tiny_model())
    if kind == "f32":
        return path
    assert bark_tpu_torch.bark_model_quantize(path, f"{d}/q.bin",
                                              ggml.GGMLFType.MOSTLY_Q8_0)
    return f"{d}/q.bin"


WEIGHTS = ("semantic_params", "coarse_params", "fine_params",
           "codec_params")


@functools.lru_cache(maxsize=None)
def _context():
    return bark_tpu.bark_load_model(weights("f32"), tiny_params(), seed=0)


@functools.lru_cache(maxsize=None)
def arrays(kind: str = "f32") -> dict:
    """bark_tpu's stage and codec arrays of `weights(kind)`, as it loads
    them."""
    jctx = (_context() if kind == "f32" else
            bark_tpu.bark_load_model(weights(kind), tiny_params(), seed=0))
    return {name: getattr(jctx, name) for name in WEIGHTS}


def context(kind: str = "f32"):
    """The one bark_tpu context, holding `kind`'s weights."""
    jctx = _context()
    for name, value in arrays(kind).items():
        setattr(jctx, name, value)
    return jctx


def _run(run, seed: int, kind: str, progress: bool, params: dict):
    """run(jctx) on the one context at tiny_params(**params)
    (REQUEST_PARAMS only) with its key at `seed`; returns (run's result,
    the progress callbacks as (step, percent) pairs when `progress`)."""
    jctx = context(kind)
    base = tiny_params(**params)
    for k in REQUEST_PARAMS:
        setattr(jctx.params, k, getattr(base, k))
    calls = []
    if progress:
        jctx.params.progress_callback = (
            lambda ctx, step, percent, user: calls.append((int(step),
                                                           percent)))
    jctx.rng_key = jax.random.PRNGKey(seed)
    try:
        return run(jctx), calls
    finally:
        jctx.params.progress_callback = None


def _result(jctx, calls) -> dict:
    return dict(semantic=np.array(jctx.semantic_tokens),
                coarse=np.array(jctx.coarse_tokens),
                fine=np.array(jctx.fine_tokens),
                audio=np.array(jctx.generated_audio), calls=calls,
                stats=dataclasses.replace(jctx.stats))


def request(text: str, seed: int, kind: str = "f32", voice=None,
            **params) -> dict:
    """bark_tpu's generate_audio at tiny_params(**params) (REQUEST_PARAMS
    only) with its key at `seed`: its semantic, coarse and fine tokens,
    audio, statistics and, on the stepped path (detailed_stats), its
    progress callbacks as (step, percent) pairs."""
    ok, calls = _run(lambda j: j.generate_audio(text, voice=voice), seed,
                     kind, tiny_params(**params).detailed_stats, params)
    assert ok
    return _result(context(kind), calls)


def stream(text: str, seed: int, kind: str = "f32", voice=None,
           **params) -> dict:
    """bark_tpu's generate_audio_stream, as `request`: also its chunks,
    and its progress callbacks always."""
    chunks, calls = _run(
        lambda j: [np.array(c) for c in j.generate_audio_stream(
            text, voice=voice)], seed, kind, True, params)
    return dict(_result(context(kind), calls), chunks=chunks)


def long_form(text: str, seed: int, streamed: bool = False, voice=None,
              **params) -> dict:
    """bark_tpu's generate_audio_long (or, `streamed`,
    generate_audio_stream_long) on the f32 weights, as `request`: also
    each sentence's tokens (`sentences`: dicts of semantic, coarse, fine)
    and, streamed, the chunks."""
    sentences = []

    def keep(j):
        sentences.append({k: np.array(getattr(j, f"{k}_tokens"))
                          for k in ("semantic", "coarse", "fine")})

    def run(j):
        if streamed:
            inner = j.generate_audio_stream

            def each(*a, **kw):
                yield from inner(*a, **kw)
                keep(j)

            j.generate_audio_stream = each
            try:
                return [np.array(c) for c in j.generate_audio_stream_long(
                    text, voice=voice)]
            finally:
                del j.generate_audio_stream
        inner = j.generate_audio

        def each(*a, **kw):
            ok = inner(*a, **kw)
            keep(j)
            return ok

        j.generate_audio = each
        try:
            assert j.generate_audio_long(text, voice=voice)
        finally:
            del j.generate_audio
        return None

    chunks, calls = _run(run, seed, "f32", False, params)
    return dict(_result(context(), calls), chunks=chunks,
                sentences=sentences)
