"""HF suno/bark checkpoint -> single-file ggml_weights.bin converter.

Behavioral equivalent of the reference's convert.py (same output format,
byte-compatible with the reference loader):

- input dir: HF snapshot with `pytorch_model.bin`, `config.json`, `vocab.txt`
- vocab written verbatim (lines minus trailing newline), convert.py:310-322
- GPT sections for prefixes semantic / coarse_acoustics / fine_acoustics:
  hparams (num_layers, num_heads, hidden_size, block_size, bias [forced True
  for fine], input/output vocab, n_lm_heads = n_codes_total - n_codes_given,
  n_wtes = n_codes_total, ftype), convert.py:86-110; the per-layer causal
  `attn.bias` mask buffers are dropped, tensors renamed to the model/...
  scheme, 2-D /w + wte + lm_head stored f16 under --use-f16,
  convert.py:205-277
- codec section: weight-norm folded (weight_v x weight_g -> weight,
  convert.py:138-148), EMA bookkeeping dropped, conv/convtr/lstm/quantizer
  renames (convert.py:152-165), codebook embeds kept f32, bandwidth
  hardcoded 24 (convert.py:66)

torch is used only to deserialize the checkpoint; all math is numpy.

The port's copy of `bark_tpu.io.convert`, writing through the port's
`io.ggml`; tests/test_torch_shared_copies.py holds the files the two
write byte-equal.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict

import numpy as np

from bark_tpu_torch.io import ggml

GPT_PREFIXES = ("semantic", "coarse_acoustics", "fine_acoustics")

# decoder layers whose conv is a ConvTranspose1d (upsampling), convert.py:41-50
_CONVTR_RE = re.compile(r"decoder\.layers\.(3|6|9|12)\.conv\.(bias|weight)$")
_CONV_RE = re.compile(r"(encoder|decoder)\.layers\.(\d+)(.*?)\.conv\.(bias|weight)$")
_QUANT_RE = re.compile(r"quantizer\.layers\.(\d+)\.codebook\.(.+)$")

_GPT_RENAMES = [
    (re.compile(r"^layernorm_final\.weight$"), "model/ln_f/g"),
    (re.compile(r"^layernorm_final\.bias$"), "model/ln_f/b"),
    (re.compile(r"^input_embeds_layer\.weight$"), "model/wte/0"),
    (re.compile(r"^input_embeds_layers\.(\d+)\.weight$"), "model/wte/{0}"),
    (re.compile(r"^position_embeds_layer\.weight$"), "model/wpe"),
    (re.compile(r"^lm_head\.weight$"), "model/lm_head/0"),
    (re.compile(r"^lm_heads\.(\d+)\.weight$"), "model/lm_head/{0}"),
    (re.compile(r"^layers\.(\d+)\.layernorm_1\.weight$"), "model/h{0}/ln_1/g"),
    (re.compile(r"^layers\.(\d+)\.layernorm_1\.bias$"), "model/h{0}/ln_1/b"),
    (re.compile(r"^layers\.(\d+)\.layernorm_2\.weight$"), "model/h{0}/ln_2/g"),
    (re.compile(r"^layers\.(\d+)\.layernorm_2\.bias$"), "model/h{0}/ln_2/b"),
    (re.compile(r"^layers\.(\d+)\.attn\.att_proj\.weight$"),
     "model/h{0}/attn/c_attn/w"),
    (re.compile(r"^layers\.(\d+)\.attn\.att_proj\.bias$"),
     "model/h{0}/attn/c_attn/b"),
    (re.compile(r"^layers\.(\d+)\.attn\.out_proj\.weight$"),
     "model/h{0}/attn/c_proj/w"),
    (re.compile(r"^layers\.(\d+)\.attn\.out_proj\.bias$"),
     "model/h{0}/attn/c_proj/b"),
    (re.compile(r"^layers\.(\d+)\.mlp\.in_proj\.weight$"),
     "model/h{0}/mlp/c_fc/w"),
    (re.compile(r"^layers\.(\d+)\.mlp\.in_proj\.bias$"),
     "model/h{0}/mlp/c_fc/b"),
    (re.compile(r"^layers\.(\d+)\.mlp\.out_proj\.weight$"),
     "model/h{0}/mlp/c_proj/w"),
    (re.compile(r"^layers\.(\d+)\.mlp\.out_proj\.bias$"),
     "model/h{0}/mlp/c_proj/b"),
]


def _rename_gpt(name: str) -> str:
    for pat, fmt in _GPT_RENAMES:
        m = pat.match(name)
        if m:
            return fmt.format(*m.groups())
    raise ValueError(f"Unrecognized GPT variable name: {name}")


def weight_norm_fold(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """torch._weight_norm(v, g, dim=0): w = g * v / ||v||_{dims != 0}."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
    return (g.astype(np.float64) * v.astype(np.float64) / norm).astype(
        np.float32
    )


def _gpt_section(
    state: Dict[str, np.ndarray], config: dict, prefix: str, use_f16: bool
) -> ggml.GPTSection:
    hp_cfg = config[f"{prefix}_config"]
    # fine model always has layer-norm biases (convert.py:91-94)
    bias = True if prefix == "fine_acoustics" else bool(hp_cfg["bias"])
    if "n_codes_total" in hp_cfg:
        n_lm_heads = hp_cfg["n_codes_total"] - hp_cfg["n_codes_given"]
        n_wtes = hp_cfg["n_codes_total"]
    else:
        n_lm_heads, n_wtes = 1, 1
    hp = ggml.GPTHParams(
        n_layer=hp_cfg["num_layers"],
        n_head=hp_cfg["num_heads"],
        n_embd=hp_cfg["hidden_size"],
        block_size=hp_cfg["block_size"],
        bias=int(bias),
        n_in_vocab=hp_cfg["input_vocab_size"],
        n_out_vocab=hp_cfg["output_vocab_size"],
        n_lm_heads=n_lm_heads,
        n_wtes=n_wtes,
        ftype=int(use_f16),
    )

    tensors: Dict[str, ggml.TensorRecord] = {}
    for key in state:
        if not key.startswith(prefix + "."):
            continue
        if re.search(r"layers\.\d+\.attn\.bias", key):
            continue  # causal-mask buffer, not a weight
        arr = np.squeeze(state[key])
        name = _rename_gpt(key[len(prefix) + 1 :])
        f16 = (
            use_f16
            and arr.ndim == 2
            and (name.endswith("/w") or "wte" in name or "lm_head" in name)
        )
        ttype = ggml.GGMLType.F16 if f16 else ggml.GGMLType.F32
        tensors[name] = ggml.TensorRecord.from_array(name, arr, ttype)
    return ggml.GPTSection(hparams=hp, tensors=tensors)


def _codec_section(
    state: Dict[str, np.ndarray], config: dict, use_f16: bool
) -> ggml.CodecSection:
    cfg = config["codec_config"]
    hp = ggml.CodecHParams(
        in_channels=cfg["audio_channels"],
        hidden_dim=cfg["hidden_size"],
        n_filters=cfg["num_filters"],
        kernel_size=cfg["kernel_size"],
        residual_kernel_size=cfg["residual_kernel_size"],
        n_bins=cfg["codebook_size"],
        bandwidth=24,  # hardcoded upstream (convert.py:66)
        sample_rate=cfg["sampling_rate"],
        ftype=int(use_f16),
    )

    tensors: Dict[str, ggml.TensorRecord] = {}
    for key in state:
        if "codec_model" not in key:
            continue
        if key.endswith("weight_g"):
            continue  # folded together with weight_v
        if any(s in key for s in ("inited", "cluster_size", "embed_avg")):
            continue  # quantizer EMA bookkeeping, unused at inference
        clean = key.replace("codec_model.", "")
        if key.endswith("weight_v"):
            g = np.asarray(state[key.replace("weight_v", "weight_g")])
            arr = weight_norm_fold(np.asarray(state[key]), g)
            clean = clean.replace("weight_v", "weight")
        else:
            arr = np.squeeze(np.asarray(state[key]))

        if _CONVTR_RE.match(clean):
            clean = _CONVTR_RE.sub(
                r"decoder.model.\1.convtr.convtr.\2", clean
            )
        elif ("encoder" in clean or "decoder" in clean) and "conv" in clean:
            clean = _CONV_RE.sub(r"\1.model.\2\3.conv.conv.\4", clean)
        elif "lstm" in clean:
            clean = clean.replace("layers", "model")
        elif "quantizer" in clean:
            clean = _QUANT_RE.sub(r"quantizer.vq.layers.\1._codebook.\2", clean)
        else:
            raise ValueError(f"Unrecognized codec variable name: {clean}")

        # f16 for every *weight* tensor; codebook embeds stay f32 even under
        # --use-f16 (convert.py:169-183)
        f16 = use_f16 and "embed" not in clean and "weight" in clean
        ttype = ggml.GGMLType.F16 if f16 else ggml.GGMLType.F32
        tensors[clean] = ggml.TensorRecord.from_array(clean, arr, ttype)
    return ggml.CodecSection(hparams=hp, tensors=tensors)


def load_checkpoint(dir_model: Path) -> Dict[str, np.ndarray]:
    """torch.load the HF checkpoint into plain numpy arrays."""
    import torch  # local import: only the converter needs torch

    ckpt = torch.load(
        dir_model / "pytorch_model.bin", map_location="cpu",
        weights_only=True,
    )
    return {k: v.float().numpy() for k, v in ckpt.items()}


def convert(dir_model: str, out_path: str, use_f16: bool = False) -> str:
    """Convert an HF bark snapshot dir into ggml_weights.bin at out_path."""
    dir_model = Path(dir_model)
    config = json.loads((dir_model / "config.json").read_text())
    with open(dir_model / "vocab.txt", encoding="utf-8") as f:
        vocab = [line[:-1] if line.endswith("\n") else line for line in f]
    state = load_checkpoint(dir_model)

    sections = [
        _gpt_section(state, config, p, use_f16) for p in GPT_PREFIXES
    ]
    model = ggml.ModelFile(
        vocab=vocab,
        semantic=sections[0],
        coarse=sections[1],
        fine=sections[2],
        codec=_codec_section(state, config, use_f16),
    )
    ggml.write_model_file(out_path, model)
    return out_path
