"""The bark.h-shaped public API on the PyTorch port.

The counterpart of `bark_tpu.api.context` for the fused single-request
path: `bark_load_model(path, params, seed, device)` -> BarkContext,
`bark_generate_audio(ctx, text)`, `bark_get_audio_data(_size)`,
`bark_get_load_time`, `bark_get_eval_time`, `bark_reset_statistics`,
`bark_free`, `bark_model_quantize`. Text -> tokens -> semantic (K2 + K3)
-> coarse (K2 + K4 per window) -> fine -> EnCodec -> 24 kHz PCM, all on
`device`.

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
every lane), then the fine stage and the codec
per lane. Packed stages take the same path: K9 and K10 then decode
through the packed batched step (K5-batched), and the prefills and the
fine stage read a dense copy made once per batch and stage.

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

Not ported yet: the stepped path and progress callbacks, streaming,
long-form, voice presets, the server's batch worker.
"""

from __future__ import annotations

import dataclasses
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
from bark_tpu_torch.params import BarkContextParams, Verbosity
from bark_tpu_torch.pipeline import coarse as coarse_pipe
from bark_tpu_torch.pipeline import fine as fine_pipe
from bark_tpu_torch.pipeline import semantic as semantic_pipe
from bark_tpu_torch.text import tokenizer

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
        if p.top_k or p.top_p:
            raise NotImplementedError(
                "top_k/top_p sampling is not ported to bark_tpu_torch yet"
            )
        # the reference takes its stepped path for the first two and traces
        # under the third; the port has only the fused path, which would
        # ignore them
        for name, unported in (
                ("progress_callback", p.progress_callback is not None),
                ("detailed_stats", p.detailed_stats),
                ("profile_dir", p.profile_dir)):
            if unported:
                raise NotImplementedError(
                    f"{name} is not ported to bark_tpu_torch yet: it needs "
                    f"the stepped path (or its profiler trace), which is "
                    f"not ported"
                )
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
                    kv_quant=self.kv_quant,
                )
            elif name == "coarse":
                prog = coarse_pipe.make_coarse_stage_program(
                    self.coarse_cfg, p,
                    ctx_size=min(COARSE_CTX_SIZE, self.coarse_cfg.block_size),
                    kv_quant=self.kv_quant,
                )
            else:
                prog = fine_pipe.make_fine_stage_program(self.fine_cfg, p)
            self._programs[name] = prog
        return self._programs[name]

    def _sync(self) -> None:
        if self.params.stage_sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ pipeline

    def generate_audio(self, text: str) -> bool:
        """Text -> 24 kHz waveform (bark_generate_audio,
        bark.cpp:2125-2172). Returns True on success; the audio is then
        available through `get_audio_data`."""
        p = self.params
        self.reset_statistics()
        t_start = time.perf_counter()
        prompt = tokenizer.tokenize_input(
            self.vocab, text, p, block_size=self.semantic_cfg.block_size
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
        ok = self._generate(p)
        if ok:
            self.stats.t_eval_us += int((time.perf_counter() - t_start) * 1e6)
        return ok

    def _generate(self, p: BarkContextParams) -> bool:
        dev = self.device
        # --- semantic: prefill (K2) + chunks (K3)
        t0 = time.perf_counter()
        max_steps = p.n_steps_text_encoder
        noise = (None if p.temp == 0.0 else self.noise_source(
            "semantic", (max_steps, self.semantic_cfg.n_out_vocab)))
        sem_out, count = self._program("semantic")(
            self.semantic_params, torch.as_tensor(self.tokens, device=dev),
            noise, p.min_eos_p,
        )
        self._sync()
        self.stats.t_semantic_us += int((time.perf_counter() - t0) * 1e6)
        if count == 0:
            print("bark_generate_audio: no semantic tokens generated",
                  file=sys.stderr)
            return False

        # --- coarse: per window, prefill (K2) + window (K4)
        t0 = time.perf_counter()
        _, _, n_steps, n_windows = coarse_pipe.coarse_schedule(count, p)
        noise = (None if p.temp == 0.0 else self.noise_source(
            "coarse", (n_windows, p.sliding_window_size, p.codebook_size)))
        codes, n_steps = self._program("coarse")(
            self.coarse_params, sem_out[:count], noise
        )
        self._sync()
        self.stats.t_coarse_us += int((time.perf_counter() - t0) * 1e6)

        # --- fine: plain PyTorch block refinement
        t0 = time.perf_counter()
        n_frames = n_steps // p.n_coarse_codebooks
        fine_buf = self._program("fine")(self.fine_params, codes, n_frames,
                                         self._fine_noise(n_frames))
        self._sync()
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

    def generate_audio_batch(self, texts, voices=None) -> list:
        """Generate B utterances through one batched pipeline (the JAX
        package's `generate_audio_batch`, its server's batching path):
        one K8 prefill and K9 chunks for every lane's semantic stage, one
        K8 prefill and one K10 window per shared coarse window, then the
        fine stage and the codec per lane. Returns one f32 PCM array per
        prompt, in order (empty for a lane that generated no semantic
        token). Adds to the aggregate statistics; keeps no per-utterance
        tokens.

        Randomness: each lane takes the noise of the single-request path,
        drawn stage-major (every lane's semantic noise, then every lane's
        coarse noise, then every lane's fine noise) through
        `lane_noise_source(stage, lane, shape)`, which a test may replace
        to replay another implementation's noise per lane. The JAX package
        pads the batch to a power of two, which bounds what it compiles;
        the port has nothing to compile and runs exactly B lanes.

        At most `bdecode.MAX_LANES` prompts, dense or packed-quantized
        stages; voice presets are not ported to this path and raise."""
        return [lane["audio"] for lane in self._generate_batch(texts, voices)]

    def _generate_batch(self, texts, voices=None) -> list:
        """`generate_audio_batch`, returning for each lane a dict of numpy
        arrays: its semantic tokens, coarse codes (n_frames, n_coarse),
        fine codes (n_frames, n_fine) and audio (all empty for a lane with
        no semantic token)."""
        p = self.params
        t_start = time.perf_counter()
        B = len(texts)
        if B == 0:
            return []
        if B > kbdec.MAX_LANES:
            raise ValueError(f"generate_audio_batch takes at most "
                             f"{kbdec.MAX_LANES} prompts, got {B}")
        if voices is not None:
            raise NotImplementedError("voice presets are not ported yet")
        dev = self.device
        prompts = torch.as_tensor(np.stack([
            np.asarray(tokenizer.tokenize_input(
                self.vocab, t, p, block_size=self.semantic_cfg.block_size),
                np.int32)
            for t in texts]), device=dev)

        # --- semantic: one batched prefill (K8) + lockstep chunks (K9)
        t0 = time.perf_counter()
        noise = None
        if p.temp != 0.0:
            shape = (p.n_steps_text_encoder, self.semantic_cfg.n_out_vocab)
            noise = torch.empty((B, *shape), dtype=torch.float32, device=dev)
            for b in range(B):
                noise[b] = self.lane_noise_source("semantic", b, shape)
        sem_out, counts = semantic_pipe.make_semantic_program_batched(
            self.semantic_cfg, temp=p.temp, max_steps=p.n_steps_text_encoder,
            semantic_vocab_size=p.semantic_vocab_size, kv_quant=self.kv_quant,
        )(self.semantic_params, prompts, noise, p.min_eos_p)
        del noise
        self._sync()
        self.stats.t_semantic_us += int((time.perf_counter() - t0) * 1e6)
        live = [b for b in range(B) if counts[b] > 0]

        # --- coarse: per shared window, K8 + K10 over the running lanes
        t0 = time.perf_counter()
        noises = None
        if p.temp != 0.0:
            noises = [self.lane_noise_source("coarse", b, (
                coarse_pipe.coarse_schedule(counts[b], p)[3],
                p.sliding_window_size, p.codebook_size)) for b in live]
        codes, n_steps = ([], []) if not live else \
            coarse_pipe.make_coarse_stage_program_batched(
                self.coarse_cfg, p,
                ctx_size=min(COARSE_CTX_SIZE, self.coarse_cfg.block_size),
                kv_quant=self.kv_quant,
            )(self.coarse_params, [sem_out[b, :counts[b]] for b in live],
              noises)
        self._sync()
        self.stats.t_coarse_us += int((time.perf_counter() - t0) * 1e6)

        # --- fine and codec, per lane, on one dense copy of a qpack
        t0 = time.perf_counter()
        n_frames = [s // p.n_coarse_codebooks for s in n_steps]
        noises = [self._fine_noise(n, lane=b) for b, n in zip(live, n_frames)]
        fine_params = loader.densify(self.fine_cfg, self.fine_params)
        fine = [self._program("fine")(fine_params, c, n, z)
                for c, n, z in zip(codes, n_frames, noises)]
        self._sync()
        self.stats.t_fine_us += int((time.perf_counter() - t0) * 1e6)
        empty = np.zeros((0,), np.int32)
        outs = [dict(semantic=empty, coarse=empty.reshape(0, 0),
                     fine=empty.reshape(0, 0),
                     audio=np.zeros((0,), np.float32)) for _ in range(B)]
        for i, (b, buf, n) in enumerate(zip(live, fine, n_frames)):
            outs[b] = dict(
                semantic=sem_out[b, :counts[b]].cpu().numpy(),
                coarse=codes[i].cpu().numpy(), fine=buf[:n].cpu().numpy(),
                audio=self._decode_codec(buf, n).cpu().numpy())
        self.stats.n_sample_semantic += sum(counts)
        self.stats.n_sample_coarse += sum(n_steps)
        self.stats.n_sample_fine += sum(n_frames) * p.n_fine_codebooks
        self.stats.t_eval_us += int((time.perf_counter() - t_start) * 1e6)
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
        self._program("fine")(self.fine_params, codes, n_frames, noise(
            p.fine_temp, n_loops, p.n_fine_codebooks - n_cc,
            self.fine_cfg.block_size, p.codebook_size))
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

    def _fine_noise(self, n_frames: int, lane=None):
        """The fine stage's (n_loops, n_fine - n_coarse, block_size,
        codebook_size) noise for n_frames (None at fine_temp 0), from
        `noise_source`, or from `lane_noise_source` for a batch lane."""
        p = self.params
        if p.fine_temp == 0.0:
            return None
        _, n_loops = fine_pipe.fine_schedule(n_frames,
                                             self.fine_cfg.block_size)
        shape = (n_loops, p.n_fine_codebooks - p.n_coarse_codebooks,
                 self.fine_cfg.block_size, p.codebook_size)
        if lane is None:
            return self.noise_source("fine", shape)
        return self.lane_noise_source("fine", lane, shape)

    def _decode_codec(self, fine_buf, n_frames: int):
        """RVQ decode + SEANet synthesis of the first n_frames rows
        (bark.cpp:2146-2167) -> (n_frames * hop,) f32 PCM on the device.
        Frames are padded to a multiple of CODEC_FRAME_CHUNK only when
        n_frames >= kernel_size, as bark_tpu does: shorter inputs would
        reflect the pad rows into the first conv's left padding. Pad rows
        hold the pad id, which `encodec.rvq_decode` maps to a zero latent."""
        cfg, p = self.codec_cfg, self.params
        n_q = cfg.n_q_for_bandwidth(p.target_bandwidth)
        if n_frames >= cfg.kernel_size:
            padded = max(CODEC_FRAME_CHUNK,
                         -(-n_frames // CODEC_FRAME_CHUNK) * CODEC_FRAME_CHUNK)
        else:
            padded = max(n_frames, 1)
        codes = torch.full((padded, n_q), cfg.n_bins, dtype=torch.int32,
                           device=self.device)
        codes[:n_frames] = fine_buf[:n_frames, :n_q]
        audio = encodec.decode_codes(self.codec_params, codes)
        return audio[: n_frames * cfg.hop_length]

    # ------------------------------------------------------------ getters

    def get_audio_data(self) -> Optional[np.ndarray]:
        return self.generated_audio

    def get_audio_data_size(self) -> int:
        return 0 if self.generated_audio is None else int(
            self.generated_audio.size)

    def get_load_time(self) -> int:
        return self.stats.t_load_us

    def get_eval_time(self) -> int:
        return self.stats.t_eval_us

    def reset_statistics(self) -> None:
        self.stats = BarkStatistics(t_load_us=self.stats.t_load_us)


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


def bark_generate_audio(ctx: BarkContext, text: str,
                        n_threads: int = 0) -> bool:
    del n_threads  # PyTorch and the kernels own threading
    return ctx.generate_audio(text)


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
