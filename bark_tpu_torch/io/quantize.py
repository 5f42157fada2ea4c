"""File-to-file model quantization (bark_model_quantize).

The port's copy of `bark_tpu.io.quantize` (tests/test_torch_shared_copies.py
holds the output files byte-equal). Mirrors bark.cpp:272-478 + 2234-2377:

- magic and vocab copied verbatim;
- per GPT section, hparams re-written with
  ftype = GGML_QNT_VERSION*1000 + target_ftype (bark.cpp:2268);
- only 2-D tensors whose names match the reference's regex list
  (bark.cpp:2283-2290) and whose source type is F32/F16 are re-quantized via
  the ggml block formats; everything else passes through;
- the EnCodec section is copied through unquantized byte-for-byte
  (bark.cpp:2366-2371 — codec quality rationale, README.md:128).
"""

from __future__ import annotations

import re
from typing import Iterable

import numpy as np

from bark_tpu_torch.io import ggml, quant

# bark.cpp:2283-2290
QUANTIZE_NAME_PATTERNS = (
    r"model/wte/.*",
    r"model/lm_head/.*",
    r"model/h.*/attn/c_attn/w",
    r"model/h.*/attn/c_proj/w",
    r"model/h.*/mlp/c_fc/w",
    r"model/h.*/mlp/c_proj/w",
)
_COMPILED = [re.compile(p + r"$") for p in QUANTIZE_NAME_PATTERNS]


def _should_quantize(rec: ggml.TensorRecord, ttype: ggml.GGMLType) -> bool:
    if len(rec.shape) != 2:  # bark.cpp:373 — only 2-D matmul weights
        return False
    if rec.ttype not in (ggml.GGMLType.F32, ggml.GGMLType.F16):
        return False
    # k-quant super-blocks cover 256 values and must not straddle rows
    # (ggml quantizes row-wise); incompatible tensors pass through, which
    # is what a "MOSTLY_*" ftype means
    if rec.shape[-1] % quant.BLOCK_ELEMS[ggml.QUANT_NAME[ttype]] != 0:
        return False
    return any(p.match(rec.name) for p in _COMPILED)


def quantize_section(
    sec: ggml.GPTSection, ttype: ggml.GGMLType, ftype_dst: int
) -> ggml.GPTSection:
    hp = ggml.GPTHParams(**{**sec.hparams.__dict__})
    hp.ftype = ggml.GGML_QNT_VERSION * 1000 + ftype_dst
    tensors = {}
    for name, rec in sec.tensors.items():
        if _should_quantize(rec, ttype):
            tensors[name] = ggml.TensorRecord.from_array(
                name, rec.to_float32(), ttype
            )
        else:
            tensors[name] = rec
    return ggml.GPTSection(hparams=hp, tensors=tensors)


def model_quantize(fname_inp: str, fname_out: str, ftype: int) -> bool:
    """Rewrite `fname_inp` with quantized GPT weights. `ftype` is a
    ggml_ftype value (GGMLFType); returns True on success."""
    ftype = ggml.GGMLFType(ftype)
    ttype = ggml.FTYPE_TO_TYPE.get(ftype)
    if ttype is None or ttype not in ggml.QUANT_NAME:
        raise ValueError(f"invalid quantization type {ftype}")
    model = ggml.read_model_file(fname_inp)
    out = ggml.ModelFile(
        vocab=model.vocab,
        semantic=quantize_section(model.semantic, ttype, int(ftype)),
        coarse=quantize_section(model.coarse, ttype, int(ftype)),
        fine=quantize_section(model.fine, ttype, int(ftype)),
        codec=model.codec,  # pass-through, bark.cpp:2366-2371
    )
    ggml.write_model_file(fname_out, out)
    return True
