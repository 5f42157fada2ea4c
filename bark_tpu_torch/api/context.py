"""The bark.h-shaped public API on the PyTorch port.

The counterpart of `bark_tpu.api.context` for the fused single-request
path: `bark_load_model(path, params, seed, device)` -> BarkContext,
`bark_generate_audio(ctx, text)`, `bark_get_audio_data(_size)`,
`bark_get_load_time`, `bark_get_eval_time`, `bark_reset_statistics`,
`bark_free`, `bark_model_quantize`, `bark_save_voice`. Text -> tokens ->
semantic (K2 + K3) -> coarse (K2 + K4 per window) -> fine -> EnCodec ->
24 kHz PCM, all on `device`.

Packed-quantized serving: with `dequantize_on_load=False`, every GPT
section of the file that is block-quantized in a packable format
(`io.loader.section_is_quantized`) loads as a qpack (int8 values + block
scales [+ mins]); the causal stages then decode through the packed kernel
(K5) and prefill and the fine stage run on a per-call dense copy. Any
other section loads dense.

Batched serving: `BarkContext.generate_audio_batch(texts)` runs up to
32 prompts through one batched pipeline (K8 prefills, K9 semantic chunks
and K10 coarse windows, each one launch of the batched decode step K7 in
a loop with the sampler inside; K7 reads each weight once per step for
every lane), then the fine stage with each block's forwards batched over
the lanes and the codec with each group of lanes of one decode length
batched; a larger batch runs as groups of 32, one after another.
Packed stages take the same path: K9 and K10 then decode
through the packed batched step (K5-batched), and the prefills and the
fine stage read a dense copy made once per group and stage.

Randomness: every stage takes its Gumbel noise as a tensor. The context
draws it on the device from a `torch.Generator` seeded with `seed`, in the
stage order semantic, coarse, fine (`noise_source(stage, shape)`, and
`lane_noise_source(stage, lane, shape)` for a batch lane; a test may
replace either to replay another implementation's noise). temp = 0 stages
take no noise and are deterministic.

The int8 KV cache: `kv_cache_dtype="int8"` gives every causal stage, on
the single-request, packed and batched paths alike, the JAX package's
int8 cache (`gpt.init_kv_cache(quant=True)`), read and written by the
int8 kernels K6 (`kernels.kv8`) inside K1/K5/K7 and K2/K8.

Cold start: `BarkContext.warmup()` builds and loads the kernel library
and launches every kernel of the context's configuration once, so the
first request pays no first-use cost (`cli/precompile.py` runs it).

Sampling filters: `top_k` / `top_p` at temp > 0 make the semantic and
coarse stages sample each token with `ops.sampling.sample` on the device
and decode it with one launch of the single step (K1, K5, K7,
K5-batched), as the JAX package leaves its chunk and window kernels for
single steps (pipeline/semantic.py, pipeline/coarse.py).

The stepped path: with `detailed_stats` or a `progress_callback`,
`generate_audio` syncs the device at the end of every stage, and a
callback is called after the semantic stage and, after a sync, after
every coarse window and fine block, as the JAX package's
`_generate_stepped` calls it; the programs are the fused path's, so the
tokens are too. `profile_dir` wraps a request in a `torch.profiler` trace
written under that directory.

Voice presets (`pipeline.voice`, suno's .npz speaker files): `voice=` on
`generate_audio` and `voices=` on `generate_audio_batch` feed the
semantic, coarse and fine histories; `save_voice` keeps the last
generation as a preset, and `voice.preset_from_audio` makes one from a
waveform through the EnCodec encoder (`models.encodec.encode_audio`).

Streaming and long-form: `generate_audio_stream(text, voice)` yields PCM
chunks as coarse windows complete (each window one K2 + K4, then one fine
block over the new frames and a decode of the causal prefix);
`generate_audio_long` and `generate_audio_stream_long` split a text into
sentences (`text.longform`) and chain each on the previous one's
generation as its voice.

Multi-GPU serving (`bark_tpu_torch.parallel.sharding`): on a context
that `shard_context_dp` or `shard_context` placed on a mesh of ranks,
`generate_audio_batch` runs this rank's slice of each group's lanes
(`_generate_group`), the batched stage programs on `self._forward` (the
kernels, or the tensor-parallel forward), and every rank returns every
lane.

The command-line tools and the HTTP server (`bark_tpu_torch.cli`: `main`,
`quantize`, `voice`, `convert`, `server`, `precompile`) run on the card
(`--device cuda`, the default) and refuse to start without one; the CPU
tests pass `--device cpu`, where the kernels' plain versions run. On a
GPU machine, e.g. `python -m bark_tpu_torch.cli.main -m
ggml_weights.bin -p "hello" -o out.wav` or `python -m
bark_tpu_torch.cli.server -m ggml_weights.bin --batch 40`.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from bark_tpu_torch.io import ggml, loader, quantize
from bark_tpu_torch.kernels import _build
from bark_tpu_torch.kernels import bdecode as kbdec
from bark_tpu_torch.models import encodec
from bark_tpu_torch.models.config import CodecConfig
from bark_tpu_torch.ops import sampling
from bark_tpu_torch.params import BarkContextParams, EncodingStep, Verbosity
from bark_tpu_torch.pipeline import coarse as coarse_pipe
from bark_tpu_torch.pipeline import fine as fine_pipe
from bark_tpu_torch.pipeline.forward import KERNELS
from bark_tpu_torch.pipeline import semantic as semantic_pipe
from bark_tpu_torch.pipeline import voice as voice_mod
from bark_tpu_torch.text import longform, tokenizer

# codec frames are decoded in multiples of this (as bark_tpu does, where it
# bounds the compiled programs); the causal decoder makes the right padding
# invisible to the kept samples
CODEC_FRAME_CHUNK = 128

# coarse context: 256 semantic slots + 1 infer token + max_coarse_history
COARSE_CTX_SIZE = 887

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BarkStatistics:
    """Field-for-field mirror of bark_statistics (bark.h:60-79), in µs."""

    t_load_us: int = 0
    t_eval_us: int = 0
    t_semantic_us: int = 0
    t_coarse_us: int = 0
    t_fine_us: int = 0
    n_sample_semantic: int = 0
    n_sample_coarse: int = 0
    n_sample_fine: int = 0


class BarkContext:
    """Owns the three GPT stages, the codec, the generator and the output
    audio, all on one `device`."""

    def __init__(self, model: ggml.ModelFile,
                 params: Optional[BarkContextParams] = None, seed: int = 0,
                 device="cuda"):
        t0 = time.perf_counter()
        self.params = params or BarkContextParams()
        self.device = torch.device(device)
        dtype = _DTYPES[self.params.compute_dtype]
        self.vocab = tokenizer.Vocab.from_tokens(model.vocab)
        if self.params.verbosity >= Verbosity.MEDIUM:
            # per-model hparams report, like bark_model_load
            # (bark.cpp:713-725), from the file's own hparams
            for name in ("semantic", "coarse", "fine"):
                hp = getattr(model, name).hparams
                print(
                    f"bark_model_load ({name}): n_in_vocab={hp.n_in_vocab}, "
                    f"n_out_vocab={hp.n_out_vocab}, "
                    f"block_size={hp.block_size}, n_embd={hp.n_embd}, "
                    f"n_head={hp.n_head}, n_layer={hp.n_layer}, "
                    f"n_lm_heads={hp.n_lm_heads}, n_wtes={hp.n_wtes}, "
                    f"ftype={hp.base_ftype}, qntvr={hp.qntvr}",
                    file=sys.stderr,
                )
        self.semantic_cfg, self.semantic_params = self._load_stage(
            model.semantic, dtype)
        self.coarse_cfg, self.coarse_params = self._load_stage(
            model.coarse, dtype)
        self.fine_cfg, self.fine_params = self._load_stage(model.fine, dtype)
        self.codec_cfg = loader.codec_config_from_hparams(model.codec.hparams)
        # the codec stays float32, as the reference keeps it
        self.codec_params = loader.codec_params_from_section(model.codec,
                                                             self.device)
        self._finish_init(seed)
        self.stats.t_load_us = int((time.perf_counter() - t0) * 1e6)

    @classmethod
    def from_parts(cls, *, vocab_tokens, semantic, coarse, fine,
                   codec_cfg: CodecConfig, codec_params,
                   params: Optional[BarkContextParams] = None, seed: int = 0,
                   device="cuda") -> "BarkContext":
        """A context from (GPTConfig, params dict) pairs and codec params
        already on `device` (synthetic runs, tests)."""
        ctx = cls.__new__(cls)
        ctx.params = params or BarkContextParams()
        ctx.device = torch.device(device)
        ctx.vocab = tokenizer.Vocab.from_tokens(vocab_tokens)
        ctx.semantic_cfg, ctx.semantic_params = semantic
        ctx.coarse_cfg, ctx.coarse_params = coarse
        ctx.fine_cfg, ctx.fine_params = fine
        ctx.codec_cfg = codec_cfg
        ctx.codec_params = codec_params
        ctx._finish_init(seed)
        return ctx

    def _load_stage(self, sec, dtype):
        """(cfg, params): a qpack when dequantize_on_load is False and the
        section is block-quantized in a packable format, dense otherwise
        (what the file holds). A qpack whose shapes the packed kernel does
        not take raises at its first launch on the GPU; nothing falls back
        to dense."""
        if not self.params.dequantize_on_load and \
                loader.section_is_quantized(sec):
            return loader.gpt_qparams_from_section(sec, dtype, self.device)
        return loader.gpt_params_from_section(sec, dtype, self.device)

    def _finish_init(self, seed: int) -> None:
        self._validate()
        p = self.params
        if p.kv_cache_dtype not in ("params", "int8"):
            raise ValueError(f"kv_cache_dtype {p.kv_cache_dtype!r}: want "
                             f"'params' or 'int8'")
        self.kv_quant = p.kv_cache_dtype == "int8"
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise_source = self._gumbel
        self.lane_noise_source = self._lane_gumbel
        self.stats = BarkStatistics()
        self.tokens = np.zeros((0,), np.int32)
        self.semantic_tokens = np.zeros((0,), np.int32)
        self.coarse_tokens = np.zeros((0, 0), np.int32)
        self.fine_tokens = np.zeros((0, 0), np.int32)
        self.generated_audio: Optional[np.ndarray] = None
        self._programs = {}
        # set by parallel.sharding.shard_context_dp and shard_context: the
        # mesh whose dp axis splits a batch's lanes, and the forward the
        # batched stage programs run
        self._dp_mesh = None
        self._forward = KERNELS

    def _validate(self) -> None:
        """Fail fast when the generation params do not fit the model's
        token space (the checks of bark_tpu's context)."""
        p = self.params
        checks = [
            (p.semantic_infer_token < self.semantic_cfg.n_in_vocab,
             "semantic_infer_token >= semantic input vocab"),
            (p.semantic_vocab_size <= self.semantic_cfg.n_out_vocab,
             "semantic_vocab_size > semantic output vocab"),
            (p.coarse_infer_token < self.coarse_cfg.n_in_vocab,
             "coarse_infer_token >= coarse input vocab"),
            (p.semantic_vocab_size + p.n_coarse_codebooks * p.codebook_size
             <= self.coarse_cfg.n_out_vocab,
             "coarse output vocab too small for the codebook windows"),
            (p.codebook_size < self.fine_cfg.n_in_vocab,
             "codebook_size (pad id) >= fine input vocab"),
            (self.fine_cfg.n_wtes >= p.n_fine_codebooks,
             "fine model has fewer wtes than n_fine_codebooks"),
            (self.semantic_cfg.block_size >= semantic_pipe.PROMPT_ROWS,
             "semantic block_size < 257 (merged prompt length)"),
        ]
        errors = [msg for ok, msg in checks if not ok]
        if errors:
            raise ValueError("model/params mismatch: " + "; ".join(errors))

    # ------------------------------------------------------------ programs

    def _gumbel(self, stage: str, shape):
        del stage
        return sampling.gumbel(shape, self.generator, self.device)

    def _lane_gumbel(self, stage: str, lane: int, shape):
        del lane
        return self._gumbel(stage, shape)

    def _program(self, name: str):
        if name not in self._programs:
            p = self.params
            if name == "semantic":
                prog = semantic_pipe.make_semantic_program(
                    self.semantic_cfg, temp=p.temp,
                    max_steps=p.n_steps_text_encoder,
                    semantic_vocab_size=p.semantic_vocab_size,
                    kv_quant=self.kv_quant, top_k=p.top_k, top_p=p.top_p,
                )
            elif name == "coarse":
                prog = coarse_pipe.make_coarse_stage_program(
                    self.coarse_cfg, p, ctx_size=self._ctx_size(),
                    kv_quant=self.kv_quant)
            elif name == "coarse_windows":
                prog = coarse_pipe.make_coarse_windows(
                    self.coarse_cfg, p, ctx_size=self._ctx_size(),
                    kv_quant=self.kv_quant)
            elif name == "fine_block":
                prog = fine_pipe.make_fine_block_program(
                    self.fine_cfg, p, forward=self._forward)
            else:
                prog = fine_pipe.make_fine_stage_program(
                    self.fine_cfg, p, forward=self._forward)
            self._programs[name] = prog
        return self._programs[name]

    def _ctx_size(self) -> int:
        return min(COARSE_CTX_SIZE, self.coarse_cfg.block_size)

    def _single_request(self) -> None:
        """Refuse a single request on a tensor-parallel context: its
        stages hold this rank's shards, which only the batched programs
        run (as `generate_audio_batch`)."""
        if self._forward is not KERNELS:
            raise ValueError(
                f"a {self._forward.name} context serves "
                f"generate_audio_batch; a single request is a batch of one")

    def _sync(self, force: bool = False) -> None:
        if (force or self.params.stage_sync) and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ pipeline

    def generate_audio(self, text: str, voice=None) -> bool:
        """Text -> 24 kHz waveform (bark_generate_audio,
        bark.cpp:2125-2172). Returns True on success; the audio is then
        available through `get_audio_data`. `voice`: a speaker preset (a
        suno-format .npz path or a `pipeline.voice.VoicePreset`) whose
        histories condition the three stages, or None for the reference's
        empty history. With `detailed_stats` or a `progress_callback` the
        stepped path runs; with `profile_dir` the request is traced."""
        self._single_request()
        p = self.params
        preset = self._resolve_voice(voice)
        self.reset_statistics()
        t_start = time.perf_counter()
        prompt = tokenizer.tokenize_input(
            self.vocab, text, p, block_size=self.semantic_cfg.block_size,
            semantic_history=voice_mod.semantic_history_tokens(preset, p),
        )
        self.tokens = np.asarray(prompt, np.int32)
        if p.verbosity >= Verbosity.LOW:
            print(f"bark_tokenize_input: prompt: '{text}'", file=sys.stderr)
            head = " ".join(str(t) for t in self.tokens[:8])
            print(
                f"bark_tokenize_input: number of tokens in prompt = "
                f"{len(self.tokens)}, first 8 tokens: {head}",
                file=sys.stderr,
            )
        hist = self._voice_args(preset)
        if p.profile_dir:
            with self._trace(p.profile_dir):
                ok = self._generate(p, *hist)
        else:
            ok = self._generate(p, *hist)
        if ok:
            self.stats.t_eval_us += int((time.perf_counter() - t_start) * 1e6)
        return ok

    def _trace(self, profile_dir: str):
        """A torch.profiler session over one request (host ops, and the
        device's kernels on CUDA), written as a Chrome trace
        (`<host>_<pid>.<ms>.pt.trace.json`) under profile_dir on exit."""
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        os.makedirs(profile_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(profile_dir))

    def _semantic(self, p: BarkContextParams):
        """The semantic stage of one request: (tokens on the device,
        count)."""
        noise = (None if p.temp == 0.0 else self.noise_source(
            "semantic", (p.n_steps_text_encoder,
                         self.semantic_cfg.n_out_vocab)))
        return self._program("semantic")(
            self.semantic_params,
            torch.as_tensor(self.tokens, device=self.device), noise,
            p.min_eos_p,
        )

    def _coarse_noise(self, count: int, lane=None):
        """The coarse stage's (n_windows, sws, codebook_size) noise for
        `count` semantic tokens (None at temp 0), from `noise_source`, or
        from `lane_noise_source` for a batch lane."""
        p = self.params
        if p.temp == 0.0:
            return None
        shape = (coarse_pipe.coarse_schedule(count, p)[3],
                 p.sliding_window_size, p.codebook_size)
        if lane is None:
            return self.noise_source("coarse", shape)
        return self.lane_noise_source("coarse", lane, shape)

    def _generate(self, p: BarkContextParams, sem_hist, coarse_hist,
                  fine_hist) -> bool:
        """Each stage one program on the device, nothing read back between
        its windows or blocks. The stepped path (`detailed_stats` or a
        `progress_callback`; bark_tpu's `_generate_stepped`) runs the same
        programs: every stage timed to its end on the device, and the
        callback after the semantic stage and after every coarse window
        and fine block, each after a sync."""
        stepped = p.detailed_stats or p.progress_callback is not None

        def progress(step):
            if p.progress_callback is None:
                return None

            def cb(percent):
                self._sync(force=True)
                self._progress(step, percent)
            return cb

        # --- semantic: prefill (K2) + chunks (K3)
        t0 = time.perf_counter()
        self._progress(EncodingStep.SEMANTIC, 0)
        sem_out, count = self._semantic(p)
        self._sync(force=stepped)
        self._progress(EncodingStep.SEMANTIC, 100)
        self.stats.t_semantic_us += int((time.perf_counter() - t0) * 1e6)
        if count == 0:
            print("bark_generate_audio: no semantic tokens generated",
                  file=sys.stderr)
            return False

        # --- coarse: per window, prefill (K2) + window (K4)
        t0 = time.perf_counter()
        codes, n_steps = self._program("coarse")(
            self.coarse_params, sem_out[:count], self._coarse_noise(count),
            sem_hist, coarse_hist, progress(EncodingStep.COARSE),
        )
        self._sync(force=stepped)
        self.stats.t_coarse_us += int((time.perf_counter() - t0) * 1e6)

        # --- fine: plain PyTorch block refinement
        t0 = time.perf_counter()
        n_frames = n_steps // p.n_coarse_codebooks
        fine_buf = self._program("fine")(
            self.fine_params, [codes], [n_frames],
            [self._fine_noise(n_frames, n_hist=len(fine_hist))],
            [torch.from_numpy(fine_hist)], progress(EncodingStep.FINE))[0]
        self._sync(force=stepped)
        self.stats.t_fine_us += int((time.perf_counter() - t0) * 1e6)

        audio = self._decode_codec(fine_buf, n_frames)
        self.semantic_tokens = sem_out[:count].cpu().numpy()
        self.coarse_tokens = codes.cpu().numpy()
        self.fine_tokens = fine_buf[:n_frames].cpu().numpy()
        self.generated_audio = audio.cpu().numpy()
        self.stats.n_sample_semantic += count
        self.stats.n_sample_coarse += n_steps
        self.stats.n_sample_fine += int(self.fine_tokens.size)
        return True

    def _progress(self, step: EncodingStep, percent: int) -> None:
        cb = self.params.progress_callback
        if cb is not None:
            cb(self, step, percent, self.params.progress_callback_user_data)

    def generate_audio_stream(self, text: str, voice=None):
        """Text -> 24 kHz PCM in chunks, one as each coarse window
        completes (bark_tpu's `generate_audio_stream`): the first chunk
        comes after the semantic stage, one coarse window (K2 + K4), one
        fine block and a short codec decode. Yields f32 numpy arrays; once
        the generator is exhausted, `get_audio_data()` returns their
        concatenation and the tokens and statistics are set as by
        `generate_audio`. `voice` as for `generate_audio`.

        After each window that ends on a whole frame, the new frames are
        refined by one fine block over up to block_size final rows of left
        context (a voice's fine history counts as context and is never
        emitted), then the whole causal prefix is decoded and only the new
        samples are emitted: the SEANet decoder is causal, so a sample once
        emitted is what a decode of the final tokens gives. The coarse
        tokens are the fused path's; the fine ones differ from it once the
        utterance spans more than one window (the fused fine stage also
        sees half a block of future context).

        Randomness, in bark_tpu's order: `noise_source("semantic", ...)`,
        `noise_source("coarse", (n_windows, sws, codebook_size))` as for
        `generate_audio`, then one `noise_source("fine", (1, n_fine -
        n_coarse, block_size, codebook_size))` per refined window, each the
        next block of the fine stage's noise (bark_tpu splits its fine key
        once per window, then once per codebook). The coarse stage's dense
        copy of a qpack is made once per call, and so is the fine stage's."""
        self._single_request()
        p = self.params
        preset = self._resolve_voice(voice)
        sem_hist, coarse_hist, fine_hist = self._voice_args(preset)
        self.reset_statistics()
        t_start = time.perf_counter()
        self.tokens = np.asarray(tokenizer.tokenize_input(
            self.vocab, text, p, block_size=self.semantic_cfg.block_size,
            semantic_history=voice_mod.semantic_history_tokens(preset, p),
        ), np.int32)

        t0 = time.perf_counter()
        self._progress(EncodingStep.SEMANTIC, 0)
        sem_out, count = self._semantic(p)
        self.semantic_tokens = sem_out[:count].cpu().numpy()
        self._progress(EncodingStep.SEMANTIC, 100)
        self.stats.t_semantic_us += int((time.perf_counter() - t0) * 1e6)
        self.stats.n_sample_semantic += count
        if count == 0:
            self.generated_audio = np.zeros((0,), np.float32)
            return

        dev, n_cc, n_fine = self.device, p.n_coarse_codebooks, \
            p.n_fine_codebooks
        cbs, block = p.codebook_size, self.fine_cfg.block_size
        hop = self.codec_cfg.hop_length
        n_steps = coarse_pipe.coarse_schedule(count, p)[2]
        windows = self._program("coarse_windows")(
            self.coarse_params, sem_out[:count], self._coarse_noise(count),
            sem_hist, coarse_hist)
        refine = self._program("fine_block")
        fine_dense = loader.densify(self.fine_cfg, self.fine_params)
        n_fh = len(fine_hist)
        # the final fine rows: the voice's history first (context only),
        # then every refined frame
        rows = torch.from_numpy(fine_hist).to(dev)
        chunks, prev, emitted = [], 0, 0  # emitted: frames yielded
        t0 = time.perf_counter()
        for done, codes in windows:
            self._sync()
            self.stats.t_coarse_us += int((time.perf_counter() - t0) * 1e6)
            self.stats.n_sample_coarse += done - prev
            percent = min(100, 100 * done // n_steps)
            self._progress(EncodingStep.COARSE, percent)
            whole, prev = (done - prev) % n_cc == 0, done
            if not whole:  # only whole frames feed the fine stage and codec
                t0 = time.perf_counter()
                continue

            t0 = time.perf_counter()
            new = codes[len(rows) - n_fh:]
            n_new = len(new)
            # the block: up to block - n_new final rows, then the new frames
            # (their fine columns at the pad id)
            kept = rows[max(0, len(rows) + n_new - block):]
            rel = len(kept)
            buf = torch.full((block, n_fine), cbs, dtype=torch.int32,
                             device=dev)
            buf[:rel] = kept
            buf[rel:rel + n_new, :n_cc] = new
            noise = None if p.fine_temp == 0.0 else self.noise_source(
                "fine", (1, n_fine - n_cc, block, cbs))[0]
            rows = torch.cat([rows, refine(
                fine_dense, buf[None], [rel],
                None if noise is None else [noise])[0, rel:rel + n_new]])
            self._sync()
            self.stats.t_fine_us += int((time.perf_counter() - t0) * 1e6)
            self.stats.n_sample_fine += n_new * n_fine
            self._progress(EncodingStep.FINE, percent)

            # the causal prefix decode; only the new samples are emitted
            n_frames = len(rows) - n_fh
            chunk = self._decode_codec(rows[n_fh:], n_frames)[
                emitted * hop:].cpu().numpy()
            chunks.append(chunk)
            emitted = n_frames
            yield chunk
            t0 = time.perf_counter()

        self.coarse_tokens = codes.cpu().numpy()
        self.fine_tokens = rows[n_fh:].cpu().numpy()
        self.generated_audio = (np.concatenate(chunks) if chunks
                                else np.zeros((0,), np.float32))
        self.stats.t_eval_us += int((time.perf_counter() - t_start) * 1e6)

    def generate_audio_long(self, text: str, voice=None,
                            silence_s: float = 0.25) -> bool:
        """Long-form text (bark_tpu's `generate_audio_long`, suno's recipe):
        the text is split into sentences (`text.longform.split_sentences`),
        each generated by `generate_audio` with the previous sentence's
        generation as its voice (`voice.preset_from_generation`), and the
        pieces joined with `silence_s` of silence between them. `voice`
        conditions the first sentence. The statistics add up over the
        sentences; `get_audio_data()` returns the whole text's audio."""
        pieces = longform.split_sentences(text)
        if not pieces:
            return False
        current = self._resolve_voice(voice)
        silence = np.zeros((int(silence_s * self.params.sample_rate),),
                           np.float32)
        parts, totals = [], BarkStatistics(t_load_us=self.stats.t_load_us)
        for i, piece in enumerate(pieces):
            if not self.generate_audio(piece, voice=current):
                return False
            parts.append(self.generated_audio)
            if i < len(pieces) - 1:
                parts.append(silence)
                current = self._next_voice()
            self._add_statistics(totals)
        self.stats = totals
        self.generated_audio = np.concatenate(parts)
        return True

    def generate_audio_stream_long(self, text: str, voice=None,
                                   silence_s: float = 0.25):
        """Long-form text streamed (bark_tpu's
        `generate_audio_stream_long`): sentence-chained as
        `generate_audio_long`, each sentence streamed by
        `generate_audio_stream`, the silence between sentences yielded as a
        chunk of its own. Yields f32 numpy chunks; afterwards
        `get_audio_data()` returns their concatenation."""
        pieces = longform.split_sentences(text)
        current = self._resolve_voice(voice)
        silence = np.zeros((int(silence_s * self.params.sample_rate),),
                           np.float32)
        parts, totals = [], BarkStatistics(t_load_us=self.stats.t_load_us)
        for i, piece in enumerate(pieces):
            for chunk in self.generate_audio_stream(piece, voice=current):
                parts.append(chunk)
                yield chunk
            if i < len(pieces) - 1:
                parts.append(silence)
                yield silence
                current = self._next_voice()
            self._add_statistics(totals)
        self.stats = totals
        self.generated_audio = (np.concatenate(parts) if parts
                                else np.zeros((0,), np.float32))

    def _next_voice(self):
        """The last generation as the next sentence's voice."""
        return voice_mod.preset_from_generation(
            self.semantic_tokens, self.coarse_tokens, self.fine_tokens,
            self.params)

    def _add_statistics(self, totals: BarkStatistics) -> None:
        """Add this request's times and counts to `totals`."""
        for f in ("t_eval_us", "t_semantic_us", "t_coarse_us", "t_fine_us",
                  "n_sample_semantic", "n_sample_coarse", "n_sample_fine"):
            setattr(totals, f, getattr(totals, f) + getattr(self.stats, f))

    def _resolve_voice(self, voice):
        """None | .npz path | VoicePreset -> a validated VoicePreset or
        None."""
        if voice is None:
            return None
        if isinstance(voice, str):
            voice = voice_mod.load_voice_preset(voice)
        voice.validate(self.params)
        return voice

    def _voice_args(self, preset):
        """The histories a preset gives the coarse and fine stages (empty
        for None): (coarse semantic history, offset-carrying coarse
        history, (n_hist, n_fine) fine rows), numpy int32."""
        p = self.params
        sem_hist, coarse_hist = voice_mod.coarse_history(preset, p)
        return sem_hist, coarse_hist, voice_mod.fine_history(preset, p)

    def generate_audio_batch(self, texts, voices=None) -> list:
        """Generate B utterances through one batched pipeline (the JAX
        package's `generate_audio_batch`, its server's batching path):
        one K8 prefill and K9 chunks for every lane's semantic stage, one
        K8 prefill and one K10 window per shared coarse window, then one
        fine stage program over every lane (each block's forwards once for
        the lanes still refining) and one codec decode for each group of
        lanes of one decode length (`_decode_codecs`), as the JAX package
        runs its vmapped fine and codec programs. Returns one f32 PCM array per
        prompt, in order (empty for a lane that generated no semantic
        token). Adds to the aggregate statistics; keeps no per-utterance
        tokens. `voices`: None, or one speaker preset (None, .npz path or
        VoicePreset) per prompt, each conditioning its own lane. With
        top-k or top-p the semantic and coarse steps run as single batched
        steps (K7, K5-batched) in place of K9 and K10.

        Any number of prompts, dense or packed-quantized stages: the
        batched kernels take at most `bdecode.MAX_LANES` lanes, so a larger
        batch runs as groups of that many prompts, one after another, and
        the outputs are concatenated in order.

        Randomness: each lane takes the noise of the single-request path,
        drawn stage-major within its group (every lane's semantic noise,
        then every lane's coarse noise, then every lane's fine noise)
        through `lane_noise_source(stage, lane, shape)`, `lane` the
        prompt's index in the whole batch, which a test may replace to
        replay another implementation's noise per lane. The JAX package
        pads the batch to a power of two, which bounds what it compiles;
        the port has nothing to compile and runs exactly B lanes."""
        return [lane["audio"] for lane in self._generate_batch(texts, voices)]

    def _generate_batch(self, texts, voices=None) -> list:
        """`generate_audio_batch`, returning for each lane a dict of numpy
        arrays: its semantic tokens, coarse codes (n_frames, n_coarse),
        fine codes (n_frames, n_fine) and audio (all empty for a lane with
        no semantic token)."""
        t_start = time.perf_counter()
        B = len(texts)
        if voices is not None and len(voices) != B:
            raise ValueError(f"voices: want one per prompt ({B}), got "
                             f"{len(voices)}")
        presets = [self._resolve_voice(v) for v in voices or [None] * B]
        outs = []
        for first in range(0, B, kbdec.MAX_LANES):
            last = first + kbdec.MAX_LANES
            outs += self._generate_group(texts[first:last],
                                         presets[first:last], first)
        if B:
            self.stats.t_eval_us += int((time.perf_counter() - t_start)
                                        * 1e6)
        return outs

    def _generate_group(self, texts, presets, first: int) -> list:
        """`_generate_batch` for at most `bdecode.MAX_LANES` prompts, the
        first of them prompt `first` of the batch (the lane index its
        noise is drawn for). Adds to the statistics, apart from t_eval.

        On a data-parallel context (`parallel.sharding.shard_context_dp`,
        `shard_context`) this rank runs its contiguous slice [lo, hi) of
        the group's lanes (`Mesh.lanes`) and the ranks go through the
        stages in lockstep: every rank draws every lane's noise in the
        unsharded order and keeps its own lanes' (a lane's coarse and fine
        noise shapes follow from the semantic counts of every lane, which
        the ranks gather), and at the end every rank gathers every lane,
        so each lane is the unsharded group's under the same noise
        source."""
        p = self.params
        B = len(texts)
        mesh = self._dp_mesh
        lo, hi = (0, B) if mesh is None else mesh.lanes(B)
        mine = range(lo, hi)
        hists = [self._voice_args(v) for v in presets]
        dev = self.device
        prompts = torch.as_tensor(np.stack([
            np.asarray(tokenizer.tokenize_input(
                self.vocab, t, p, block_size=self.semantic_cfg.block_size,
                semantic_history=voice_mod.semantic_history_tokens(v, p)),
                np.int32)
            for t, v in zip(texts[lo:hi], presets[lo:hi])]),
            device=dev) if mine else None

        # --- semantic: one batched prefill (K8) + lockstep chunks (K9)
        t0 = time.perf_counter()
        noise = None
        if p.temp != 0.0:
            shape = (p.n_steps_text_encoder, self.semantic_cfg.n_out_vocab)
            noise = torch.empty((len(mine), *shape), dtype=torch.float32,
                                device=dev)
            for b in range(B):
                lane = self.lane_noise_source("semantic", first + b, shape)
                if b in mine:
                    noise[b - lo] = lane
        sem_out, counts = None, []
        if mine:
            sem_out, counts = semantic_pipe.make_semantic_program_batched(
                self.semantic_cfg, temp=p.temp,
                max_steps=p.n_steps_text_encoder,
                semantic_vocab_size=p.semantic_vocab_size,
                kv_quant=self.kv_quant, top_k=p.top_k, top_p=p.top_p,
                forward=self._forward,
            )(self.semantic_params, prompts, noise, p.min_eos_p)
        del noise
        self._sync()
        self.stats.t_semantic_us += int((time.perf_counter() - t0) * 1e6)
        if mesh is not None:
            counts = mesh.gather_lanes(counts)
        live = [b for b in range(B) if counts[b] > 0]
        n_steps = [coarse_pipe.coarse_schedule(counts[b], p)[2]
                   for b in live]

        # --- coarse: per shared window, K8 + K10 over the running lanes
        t0 = time.perf_counter()
        noises = [self._coarse_noise(counts[b], lane=first + b)
                  for b in live]
        ours = [i for i, b in enumerate(live) if b in mine]
        codes = {}  # by index in `live`
        if ours:
            coarse = coarse_pipe.make_coarse_stage_program_batched(
                self.coarse_cfg, p, ctx_size=self._ctx_size(),
                kv_quant=self.kv_quant, forward=self._forward)
            codes = dict(zip(ours, coarse(
                self.coarse_params,
                [sem_out[live[i] - lo, :counts[live[i]]] for i in ours],
                [noises[i] for i in ours], [hists[live[i]][0] for i in ours],
                [hists[live[i]][1] for i in ours])[0]))
        del noises
        self._sync()
        self.stats.t_coarse_us += int((time.perf_counter() - t0) * 1e6)

        # --- fine: every lane's noise in the unsharded order, then one
        # stage program over this rank's lanes (one dense copy of a qpack)
        t0 = time.perf_counter()
        n_frames = [s // p.n_coarse_codebooks for s in n_steps]
        noises = [self._fine_noise(n, lane=first + b,
                                   n_hist=len(hists[b][2]))
                  for b, n in zip(live, n_frames)]
        fine = {}
        if ours:
            fine = dict(zip(ours, self._program("fine")(
                self.fine_params, [codes[i] for i in ours],
                [n_frames[i] for i in ours], [noises[i] for i in ours],
                [torch.from_numpy(hists[live[i]][2]) for i in ours])))
        del noises
        self._sync()
        self.stats.t_fine_us += int((time.perf_counter() - t0) * 1e6)

        # --- codec: one decode a group of lanes of one decode length
        audio = dict(zip(ours, self._decode_codecs(
            [fine[i] for i in ours], [n_frames[i] for i in ours])))
        empty = np.zeros((0,), np.int32)
        outs = [dict(semantic=empty, coarse=empty.reshape(0, 0),
                     fine=empty.reshape(0, 0),
                     audio=np.zeros((0,), np.float32)) for _ in mine]
        for i, buf in fine.items():
            b, n = live[i], n_frames[i]
            outs[b - lo] = dict(
                semantic=sem_out[b - lo, :counts[b]].cpu().numpy(),
                coarse=codes[i].cpu().numpy(), fine=buf[:n].cpu().numpy(),
                audio=audio[i].cpu().numpy())
        if mesh is not None:
            outs = mesh.gather_lanes(outs)
        self.stats.n_sample_semantic += sum(counts)
        self.stats.n_sample_coarse += sum(n_steps)
        self.stats.n_sample_fine += sum(n_frames) * p.n_fine_codebooks
        return outs

    def warmup(self) -> float:
        """Pay a cold process's first-use costs before the first request,
        without generating audio: build and load the kernel library (its
        missing objects compile all at once), then run the semantic,
        coarse and fine programs of `_program` once at this context's
        shapes (a pad prompt, one semantic chunk, one coarse window, one
        fine block) and the codec at every CODEC_FRAME_CHUNK bucket up to
        the pipeline's most frames. So each kernel of this configuration
        has launched (under CUDA_MODULE_LOADING=LAZY a kernel loads at its
        first launch), and cuBLAS, cuDNN and cuDNN's per-shape plans of the
        codec exist. Returns wall seconds.

        The counterpart of bark_tpu's `warmup`, which compiles the same
        programs and buckets ahead of time (its `parallel` option overlaps
        those compiles); the port has nothing to compile per shape, and so
        no such option. It draws nothing from `self.generator`: its Gumbel
        noise comes from a scratch generator (so PyTorch's random kernels
        load too), and the semantic chunk stops at once (min_eos_p 0). It
        leaves the statistics, tokens and audio as they were. On the CPU
        it runs the plain programs the same way."""
        self._single_request()
        p, dev = self.params, self.device
        t0 = time.perf_counter()
        if dev.type == "cuda":
            _build.lib()
        scratch = torch.Generator(device=dev).manual_seed(0)

        def noise(temp, *shape):  # none at temp 0
            return (None if temp == 0.0
                    else sampling.gumbel(shape, scratch, dev))

        prompt = torch.tensor(
            [p.text_pad_token] * 256 + [p.semantic_pad_token] * 256
            + [p.semantic_infer_token], dtype=torch.int32, device=dev)
        self._program("semantic")(
            self.semantic_params, prompt,
            noise(p.temp, p.n_steps_text_encoder,
                  self.semantic_cfg.n_out_vocab),
            0.0)
        # the fewest semantic tokens that give coarse steps: one window
        num, den = coarse_pipe.stc_fraction(p)
        n_cc = p.n_coarse_codebooks
        sem = torch.zeros((-(-den * n_cc // num),), dtype=torch.int32,
                          device=dev)
        n_windows = coarse_pipe.coarse_schedule(sem.numel(), p)[3]
        codes, n_steps = self._program("coarse")(
            self.coarse_params, sem,
            noise(p.temp, n_windows, p.sliding_window_size,
                  p.codebook_size))
        n_frames = n_steps // n_cc
        n_loops = fine_pipe.fine_schedule(n_frames,
                                          self.fine_cfg.block_size)[1]
        self._program("fine")(self.fine_params, [codes], [n_frames], [noise(
            p.fine_temp, n_loops, p.n_fine_codebooks - n_cc,
            self.fine_cfg.block_size, p.codebook_size)])
        max_frames = coarse_pipe.max_coarse_steps(
            p.n_steps_text_encoder, p) // n_cc
        for padded in range(CODEC_FRAME_CHUNK, -(-max_frames //
                            CODEC_FRAME_CHUNK) * CODEC_FRAME_CHUNK + 1,
                            CODEC_FRAME_CHUNK):
            pads = torch.full((padded, p.n_fine_codebooks),
                              self.codec_cfg.n_bins, dtype=torch.int32,
                              device=dev)
            self._decode_codec(pads, padded)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def _fine_noise(self, n_frames: int, lane=None, n_hist: int = 0):
        """The fine stage's (n_loops, n_fine - n_coarse, block_size,
        codebook_size) noise for n_frames after n_hist history rows (None
        at fine_temp 0), from `noise_source`, or from `lane_noise_source`
        for a batch lane."""
        p = self.params
        if p.fine_temp == 0.0:
            return None
        _, n_loops = fine_pipe.fine_schedule(n_hist + n_frames,
                                             self.fine_cfg.block_size)
        shape = (n_loops, p.n_fine_codebooks - p.n_coarse_codebooks,
                 self.fine_cfg.block_size, p.codebook_size)
        if lane is None:
            return self.noise_source("fine", shape)
        return self.lane_noise_source("fine", lane, shape)

    def _decode_codec(self, fine_buf, n_frames: int):
        """RVQ decode + SEANet synthesis of the first n_frames rows
        (bark.cpp:2146-2167) -> (n_frames * hop,) f32 PCM on the device:
        `_decode_codecs` of one lane."""
        return self._decode_codecs([fine_buf], [n_frames])[0]

    def _codec_frames(self, n_frames: int) -> int:
        """The frames a lane of n_frames is decoded at: a multiple of
        CODEC_FRAME_CHUNK when n_frames >= kernel_size, as bark_tpu pads
        them; else n_frames itself (at least 1), since shorter inputs
        would reflect the pad rows into the first conv's left padding."""
        if n_frames >= self.codec_cfg.kernel_size:
            return max(CODEC_FRAME_CHUNK,
                       -(-n_frames // CODEC_FRAME_CHUNK) * CODEC_FRAME_CHUNK)
        return max(n_frames, 1)

    def _decode_codecs(self, fine_bufs, n_frames) -> list:
        """Each lane's RVQ decode + SEANet synthesis of its first
        n_frames rows -> (n_frames * hop,) f32 PCM on the device, a lane.
        The lanes are grouped by `_codec_frames`, and each group is one
        `encodec.decode_codes` call over its lanes (a group of one: the
        lane's (T, n_q) codes). bark_tpu pads every lane to the longest
        lane's bucket; the decoder is causal, so a lane's kept samples are
        the same at its own bucket, where it also gives a single
        request's bits. Pad rows hold the pad id, which
        `encodec.rvq_decode` maps to a zero latent."""
        cfg, p = self.codec_cfg, self.params
        n_q = cfg.n_q_for_bandwidth(p.target_bandwidth)
        groups = {}
        for j, n in enumerate(n_frames):
            groups.setdefault(self._codec_frames(n), []).append(j)
        out = [None] * len(fine_bufs)
        for padded, lanes in groups.items():
            codes = torch.full((len(lanes), padded, n_q), cfg.n_bins,
                               dtype=torch.int32, device=self.device)
            for g, j in enumerate(lanes):
                codes[g, :n_frames[j]] = fine_bufs[j][:n_frames[j], :n_q]
            audio = encodec.decode_codes(
                self.codec_params, codes[0] if len(lanes) == 1 else codes)
            audio = audio.reshape(len(lanes), -1)
            for g, j in enumerate(lanes):
                out[j] = audio[g, :n_frames[j] * cfg.hop_length]
        return out

    # ------------------------------------------------------------ getters

    def get_audio_data(self) -> Optional[np.ndarray]:
        return self.generated_audio

    def get_audio_data_size(self) -> int:
        return 0 if self.generated_audio is None else int(
            self.generated_audio.size)

    def save_voice(self, path: str) -> None:
        """Save the last generation's tokens as a suno-format voice preset
        (.npz), suno's save_as_prompt: pass the file back as `voice=` to
        keep the speaker."""
        if self.semantic_tokens.size == 0 or self.fine_tokens.size == 0:
            raise ValueError(
                "save_voice: no finished generation in this context")
        voice_mod.save_voice_preset(path, voice_mod.preset_from_generation(
            self.semantic_tokens, self.coarse_tokens, self.fine_tokens,
            self.params))

    def get_load_time(self) -> int:
        return self.stats.t_load_us

    def get_eval_time(self) -> int:
        return self.stats.t_eval_us

    def reset_statistics(self) -> None:
        self.stats = BarkStatistics(t_load_us=self.stats.t_load_us)

    def print_statistics(self) -> None:
        """Per-stage report, like bark_print_statistics
        (bark.cpp:176-182)."""
        s = self.stats
        for name, t_us, n in (
            ("semantic", s.t_semantic_us, s.n_sample_semantic),
            ("coarse", s.t_coarse_us, s.n_sample_coarse),
            ("fine", s.t_fine_us, s.n_sample_fine),
        ):
            per = t_us / 1000.0 / max(n, 1)
            print(f"bark_tpu_torch: {name:>9} time = {t_us / 1000.0:8.2f} "
                  f"ms / {n} tokens ({per:.2f} ms per token)",
                  file=sys.stderr)


# ---------------------------------------------------------------- functions


def bark_load_model(model_path: str,
                    params: Optional[BarkContextParams] = None,
                    seed: int = 0, device="cuda") -> BarkContext:
    """Load ggml_weights.bin (the port's `io.ggml` reader) onto `device`
    (bark_load_model, bark.cpp:1165-1184)."""
    t0 = time.perf_counter()
    ctx = BarkContext(ggml.read_model_file(model_path), params, seed, device)
    ctx.stats.t_load_us = int((time.perf_counter() - t0) * 1e6)
    return ctx


def bark_generate_audio(ctx: BarkContext, text: str, n_threads: int = 0,
                        voice=None) -> bool:
    del n_threads  # PyTorch and the kernels own threading
    return ctx.generate_audio(text, voice=voice)


def bark_save_voice(ctx: BarkContext, path: str) -> None:
    """Keep the context's last generation as a voice preset (.npz)."""
    ctx.save_voice(path)


def bark_get_audio_data(ctx: BarkContext) -> Optional[np.ndarray]:
    return ctx.get_audio_data()


def bark_get_audio_data_size(ctx: BarkContext) -> int:
    return ctx.get_audio_data_size()


def bark_get_load_time(ctx: BarkContext) -> int:
    return ctx.get_load_time()


def bark_get_eval_time(ctx: BarkContext) -> int:
    return ctx.get_eval_time()


def bark_reset_statistics(ctx: BarkContext) -> None:
    ctx.reset_statistics()


def bark_free(ctx: Optional[BarkContext]) -> None:
    """Drop the context's references; PyTorch frees the tensors."""
    if ctx is not None:
        ctx._programs.clear()


def bark_model_quantize(fname_inp: str, fname_out: str, ftype) -> bool:
    """Rewrite a model file with block-quantized GPT weights (bark.cpp
    bark_model_quantize); `ftype` is a `ggml.GGMLFType` value. The codec
    stays f32."""
    return quantize.model_quantize(fname_inp, fname_out, int(ftype))
