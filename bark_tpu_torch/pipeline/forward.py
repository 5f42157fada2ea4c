"""The forward that the batched stage programs run, as one object they
take (`forward=`), the way the JAX package's batched programs take
`decode_fn`.

`KERNELS` is the serving path: the hand-written batched kernels (K8
prefills, K9 semantic chunks, K10 coarse windows, the single steps K7 and
K5-batched on the filtered paths), each wrapper looked up at call time in
its module. `bark_tpu_torch.parallel.tp.TensorParallelForward` is the other
one, the plain PyTorch forward of a tensor-parallel context. The stage
programs (`pipeline/semantic.py`, `coarse.py`, `fine.py`) keep one
orchestration and call only these methods:

- `weights(cfg, params)` -> (dense, decode): what the prefills, the
  embeddings and the fine stage read (a qpack's dense copy), and what the
  decode steps read (the qpack itself on the kernels);
- `embed_prompt(cfg, dense, tokens513)`, `embed(cfg, dense, ids)`: the
  merged semantic prompt and the rows of wte table 0, (B, T, D);
- `kv_cache(cfg, dense, batch, quant)`: the (L, B, S, D) caches;
- `prefill`, `step`, `chunk`, `window`: the batched wrappers' signatures
  (`kernels.bprefill.prefill_fused_batched`,
  `bdecode.decode_step_fused_batched`,
  `bsemantic.semantic_chunk_fused_batched`,
  `bwindow.coarse_window_fused_batched`);
- `fine(cfg, params, tokens, codebook_idx)`: `gpt.fine_forward`'s, on
  (B, T, C) lanes (the fine stage's batch).
"""

from __future__ import annotations

from bark_tpu_torch.io import loader
from bark_tpu_torch.kernels import bdecode as kbdec
from bark_tpu_torch.kernels import bprefill as kbpre
from bark_tpu_torch.kernels import bsemantic as kbsem
from bark_tpu_torch.kernels import bwindow as kbwin
from bark_tpu_torch.models import gpt


class KernelForward:
    """The batched kernels (their plain versions on CPU tensors)."""

    name = "kernels"

    def weights(self, cfg, params):
        return loader.densify(cfg, params), params

    def embed_prompt(self, cfg, dense, tokens513):
        return gpt.embed_prompt_merged(cfg, dense, tokens513)

    def embed(self, cfg, dense, ids):
        return dense["wte"][0][ids.long()]

    def kv_cache(self, cfg, dense, batch: int, quant: bool):
        wpe = dense["wpe"]
        return gpt.init_kv_cache(cfg, wpe.dtype, wpe.device, batch=batch,
                                 quant=quant)

    def prefill(self, cfg, dense, x_emb, k_cache, v_cache, n_valid,
                lm_window=None):
        return kbpre.prefill_fused_batched(cfg, dense, x_emb, k_cache,
                                           v_cache, n_valid,
                                           lm_window=lm_window)

    def step(self, cfg, params, tokens, k_cache, v_cache, n_past,
             lm_window=None):
        return kbdec.decode_step_fused_batched(cfg, params, tokens, k_cache,
                                               v_cache, n_past,
                                               lm_window=lm_window)

    def chunk(self, cfg, params, logits, k_cache, v_cache, ctx_len: int,
              count0: int, noise, min_eos_p: float, **kw):
        return kbsem.semantic_chunk_fused_batched(
            cfg, params, logits, k_cache, v_cache, ctx_len, count0, noise,
            min_eos_p, **kw)

    def window(self, cfg, params, logits0, k_cache, v_cache, ctx_len,
               step_idx0: int, noise, **kw):
        return kbwin.coarse_window_fused_batched(
            cfg, params, logits0, k_cache, v_cache, ctx_len, step_idx0,
            noise, **kw)

    def fine(self, cfg, params, tokens, codebook_idx: int):
        return gpt.fine_forward(cfg, params, tokens, codebook_idx)


KERNELS = KernelForward()
