"""Turn parsed ggml_weights.bin sections (the port's `io.ggml` reader) into
PyTorch params dicts laid out like the JAX package's.

ggml stores a matmul weight used as `ggml_mul_mat(W, x)` with numpy-order
shape (out_features, in_features); the compute path wants `x @ W`, so the
c_attn/c_proj/c_fc projection weights are transposed here, once, at load
(`bark_tpu.io.loader.gpt_params_from_section`). Embedding tables and LM
heads keep their file orientation.

A block-quantized section can instead load as a qpack (int8 values plus
per-32 block scales and, for the offset formats, mins), the layout of
`bark_tpu.io.loader.gpt_qparams_from_section`, which the packed decode
kernel (K5) reads as it is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bark_tpu_torch.io import quant
from bark_tpu_torch.io.ggml import (
    PACKABLE_TYPES,
    QUANT_NAME,
    CodecSection,
    GGMLType,
    GPTSection,
)
from bark_tpu_torch.models.config import RATIOS, CodecConfig, GPTConfig
from bark_tpu_torch.models.gpt import is_qpack


def gpt_config_from_hparams(hp) -> GPTConfig:
    return GPTConfig(
        n_layer=hp.n_layer,
        n_head=hp.n_head,
        n_embd=hp.n_embd,
        block_size=hp.block_size,
        n_in_vocab=hp.n_in_vocab,
        n_out_vocab=hp.n_out_vocab,
        n_lm_heads=hp.n_lm_heads,
        n_wtes=hp.n_wtes,
        bias=bool(hp.bias),
        n_codes_given=hp.n_codes_given,
    )


def codec_config_from_hparams(hp) -> CodecConfig:
    return CodecConfig(
        in_channels=hp.in_channels,
        hidden_dim=hp.hidden_dim,
        n_filters=hp.n_filters,
        kernel_size=hp.kernel_size,
        residual_kernel_size=hp.residual_kernel_size,
        n_bins=hp.n_bins,
        sample_rate=hp.sample_rate,
    )


def params_from_numpy(tree, dtype, device):
    """Carry a params tree of numpy arrays (a JAX params pytree brought to
    the host, or `init_params_numpy`) into torch tensors of `dtype` on
    `device`. Integer arrays keep their dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dtype, device) for v in tree]
    # a C-ordered copy: file-backed arrays are read-only views of the
    # weights file, and the loaded projections are transposed views
    t = torch.from_numpy(np.array(tree, order="C"))
    if t.is_floating_point():
        t = t.to(torch.float32).to(dtype)
    return t.to(device)


def gpt_params_from_section(
    sec: GPTSection, dtype, device
) -> Tuple[GPTConfig, Dict]:
    hp = sec.hparams
    cfg = gpt_config_from_hparams(hp)
    L, D = cfg.n_layer, cfg.n_embd

    def get(name: str, shape, transpose=False) -> np.ndarray:
        """`shape` is the on-file (ggml) shape; a transposed weight comes
        back as shape[::-1]. Absent tensors (biases of a bias-free model)
        load as zeros, which is numerically identical."""
        rec = sec.tensors.get(name)
        if rec is None:
            return np.zeros(shape[::-1] if transpose else shape, np.float32)
        if rec.ttype in (GGMLType.F16, GGMLType.F32):
            dt = np.float16 if rec.ttype == GGMLType.F16 else np.float32
            arr = np.frombuffer(rec.data, dt).reshape(rec.shape)
        else:
            arr = rec.to_float32()
        if arr.shape != tuple(shape):
            raise ValueError(
                f"tensor {name}: shape {arr.shape} != expected {tuple(shape)}"
            )
        return arr.T if transpose else arr

    def stack(fmt: str, n: int, shape, transpose=False) -> np.ndarray:
        return np.stack(
            [get(fmt.format(i=i), shape, transpose) for i in range(n)]
        )

    blocks = {
        "ln1_g": stack("model/h{i}/ln_1/g", L, (D,)),
        "ln1_b": stack("model/h{i}/ln_1/b", L, (D,)),
        "ln2_g": stack("model/h{i}/ln_2/g", L, (D,)),
        "ln2_b": stack("model/h{i}/ln_2/b", L, (D,)),
        "qkv_w": stack("model/h{i}/attn/c_attn/w", L, (3 * D, D), True),
        "qkv_b": stack("model/h{i}/attn/c_attn/b", L, (3 * D,)),
        "proj_w": stack("model/h{i}/attn/c_proj/w", L, (D, D), True),
        "proj_b": stack("model/h{i}/attn/c_proj/b", L, (D,)),
        "fc_w": stack("model/h{i}/mlp/c_fc/w", L, (4 * D, D), True),
        "fc_b": stack("model/h{i}/mlp/c_fc/b", L, (4 * D,)),
        "out_w": stack("model/h{i}/mlp/c_proj/w", L, (D, 4 * D), True),
        "out_b": stack("model/h{i}/mlp/c_proj/b", L, (D,)),
    }
    params_np = {
        "wte": stack("model/wte/{i}", cfg.n_wtes, (cfg.n_in_vocab, D)),
        "wpe": get("model/wpe", (cfg.block_size, D)),
        "lm_head": stack(
            "model/lm_head/{i}", cfg.n_lm_heads, (cfg.n_out_vocab, D)
        ),
        "ln_f_g": get("model/ln_f/g", (D,)),
        "ln_f_b": get("model/ln_f/b", (D,)),
        "blocks": blocks,
    }
    return cfg, params_from_numpy(params_np, dtype, device)


# ------------------------------------------------------ quantized serving


def section_is_quantized(sec: GPTSection) -> bool:
    """True when every projection weight, wte table and LM head of the
    section is stored in a block type that repacks losslessly into per-32
    block scales (`ggml.PACKABLE_TYPES`; q2_k/q3_k/q6_k have per-16
    sub-scales and load dense)."""
    names = [n for n in sec.tensors if n.endswith("/w") or "/wte/" in n
             or "/lm_head/" in n]
    return bool(names) and all(
        sec.tensors[n].ttype in PACKABLE_TYPES for n in names
    )


def _scale_leaf(name: str) -> bool:
    return name.endswith("_s") or name.endswith("_m")


def _scale_leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _scale_leaves(v)
        elif _scale_leaf(k):
            yield v


def _scales_f16_lossless(qpack_np) -> bool:
    """True iff every scale/min leaf of a host-side qpack round-trips
    through f16 exactly (always for q4_0/q4_1/q5_0/q5_1/q8_0, whose file
    scales are f16; generally not for the k-quants' d*sc products)."""
    return all(
        np.array_equal(a, a.astype(np.float16).astype(np.float32))
        for a in _scale_leaves(qpack_np)
    )


def qparams_from_numpy(tree, dtype, device):
    """Carry a qpack of numpy arrays (a JAX qpack brought to the host, or
    one built here) into torch tensors on `device`: int8 values stay int8;
    a scale or min leaf stays float16 or float32, and an int16 one (the JAX
    package ships f16 scales as their bit patterns) becomes float16 by a
    bit view; every other float leaf goes to `dtype`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = qparams_from_numpy(v, dtype, device)
            continue
        a = np.array(v, order="C")
        if a.dtype == np.int8:
            t = torch.from_numpy(a)
        elif _scale_leaf(k) and a.dtype == np.int16:
            t = torch.from_numpy(a).view(torch.float16)
        elif _scale_leaf(k) and a.dtype in (np.float16, np.float32):
            t = torch.from_numpy(a)
        else:
            t = torch.from_numpy(a.astype(np.float32)).to(dtype)
        out[k] = t.to(device)
    return out


def gpt_qparams_from_section(sec: GPTSection, dtype, device):
    """The packed-quantized params of a block-quantized section, leaf for
    leaf the layout of `bark_tpu.io.loader.gpt_qparams_from_section`
    (blocks run along the file-contiguous input axis):

      blocks.*_q  (L, Din, Dout) int8   blocks.*_s (L, Din/32, Dout)
      wte_q       (n_wtes, V, D) int8   wte_s      (n_wtes, V, D/32)
      lm_q        (D, v_pad) int8       lm_s       (D/32, v_pad)
      [*_m mins, shaped as *_s, when an offset format (q4_1/q5_1/q4_k/
       q5_k) is present]

    with v_pad = ceil(V/D)*D: single-head stages keep their LM head
    transposed and zero-padded for the kernel. Multi-head (fine) stages
    keep file orientation instead: lm_heads_q (n_heads, V, D) int8,
    lm_heads_s (n_heads, V, D/32). Scales and mins are float16 where that
    is lossless, float32 otherwise; norms, biases and wpe are dense in
    `dtype`. Returns (cfg, qpack); raises ValueError when a target tensor
    is not block-quantized."""
    cfg = gpt_config_from_hparams(sec.hparams)
    L, D, V = cfg.n_layer, cfg.n_embd, cfg.n_out_vocab
    v_pad = -(-V // D) * D
    has_min = any(
        rec.ttype in QUANT_NAME
        and QUANT_NAME[rec.ttype] in ("q4_1", "q5_1", "q4_k", "q5_k")
        for rec in sec.tensors.values()
    )

    def unpack(name, file_shape):
        rec = sec.tensors.get(name)
        if rec is None or rec.ttype not in QUANT_NAME:
            raise ValueError(f"tensor {name} is not block-quantized")
        q, s, m = quant.repack_to_int8(
            np.frombuffer(bytes(rec.data), np.uint8), QUANT_NAME[rec.ttype],
            int(np.prod(file_shape)),
        )
        rows, cols = file_shape
        return (q.reshape(rows, cols), s.reshape(rows, cols // 32),
                m.reshape(rows, cols // 32))

    def dense(name, shape):
        rec = sec.tensors.get(name)
        return np.zeros(shape, np.float32) if rec is None else rec.to_float32()

    def stacked(fmt, n, shape):
        return np.stack([dense(fmt.format(i=i), shape) for i in range(n)])

    blocks = {
        "ln1_g": stacked("model/h{i}/ln_1/g", L, (D,)),
        "ln1_b": stacked("model/h{i}/ln_1/b", L, (D,)),
        "ln2_g": stacked("model/h{i}/ln_2/g", L, (D,)),
        "ln2_b": stacked("model/h{i}/ln_2/b", L, (D,)),
        "qkv_b": stacked("model/h{i}/attn/c_attn/b", L, (3 * D,)),
        "proj_b": stacked("model/h{i}/attn/c_proj/b", L, (D,)),
        "fc_b": stacked("model/h{i}/mlp/c_fc/b", L, (4 * D,)),
        "out_b": stacked("model/h{i}/mlp/c_proj/b", L, (D,)),
    }
    for key, fmt, shape in (
        ("qkv", "model/h{i}/attn/c_attn/w", (3 * D, D)),
        ("proj", "model/h{i}/attn/c_proj/w", (D, D)),
        ("fc", "model/h{i}/mlp/c_fc/w", (4 * D, D)),
        ("out", "model/h{i}/mlp/c_proj/w", (D, 4 * D)),
    ):
        # transposed to (in, out), as the dense loader lays projections out
        triples = [unpack(fmt.format(i=i), shape) for i in range(L)]
        for j, suffix in enumerate(("_q", "_s", "_m")[:3 if has_min else 2]):
            blocks[key + suffix] = np.stack([t[j].T for t in triples])

    wtes = [unpack(f"model/wte/{i}", (cfg.n_in_vocab, D))
            for i in range(cfg.n_wtes)]
    heads = [unpack(f"model/lm_head/{i}", (V, D))
             for i in range(cfg.n_lm_heads)]
    suffixes = ("_q", "_s", "_m")[:3 if has_min else 2]
    qpack = {
        "wpe": dense("model/wpe", (cfg.block_size, D)),
        "ln_f_g": dense("model/ln_f/g", (D,)),
        "ln_f_b": dense("model/ln_f/b", (D,)),
        "blocks": blocks,
    }
    for j, suffix in enumerate(suffixes):
        qpack["wte" + suffix] = np.stack([t[j] for t in wtes])
    if cfg.n_lm_heads == 1:
        for j, suffix in enumerate(suffixes):
            a = heads[0][j].T  # (D or D/32, V)
            padded = np.zeros((a.shape[0], v_pad), a.dtype)
            padded[:, :V] = a
            qpack["lm" + suffix] = padded
    else:
        for j, suffix in enumerate(suffixes):
            qpack["lm_heads" + suffix] = np.stack([t[j] for t in heads])

    sdt = np.float16 if _scales_f16_lossless(qpack) else np.float32

    def cast_scales(tree):
        return {k: cast_scales(v) if isinstance(v, dict)
                else v.astype(sdt) if _scale_leaf(k) else v
                for k, v in tree.items()}

    return cfg, qparams_from_numpy(cast_scales(qpack), dtype, device)


def densify(cfg: GPTConfig, params) -> Dict:
    """`dense_from_qpack` of a qpack, or `params` itself when it is dense.
    A stage program calls it once per call, never per chunk or window: it
    is a full pass over the weights."""
    return dense_from_qpack(cfg, params) if is_qpack(params) else params


def dense_from_qpack(cfg: GPTConfig, qp, dtype=None) -> Dict:
    """The dense params dict of a qpack, bit-equal to dequantize-at-load:
    values * scales [+ mins] in f32, then one cast to the params dtype.
    Leaves that are dense in the qpack are shared, not copied."""
    dtype = dtype or qp["wpe"].dtype
    blocks = qp["blocks"]

    def dq(q, s, m, axis):
        w = q.float() * torch.repeat_interleave(s.float(), 32, dim=axis)
        if m is not None:
            w = w + torch.repeat_interleave(m.float(), 32, dim=axis)
        return w.to(dtype)

    def proj(key):
        return dq(blocks[f"{key}_q"], blocks[f"{key}_s"],
                  blocks.get(f"{key}_m"), 1)

    if "lm_heads_q" in qp:  # multi-head (fine): file orientation
        lm_head = dq(qp["lm_heads_q"], qp["lm_heads_s"],
                     qp.get("lm_heads_m"), 2)
    else:  # (D, v_pad) -> (1, V, D)
        lm_t = dq(qp["lm_q"], qp["lm_s"], qp.get("lm_m"), 0)
        lm_head = lm_t[:, :cfg.n_out_vocab].T.contiguous()[None]
    dense_blocks = {k: v for k, v in blocks.items()
                    if k.endswith("_g") or k.endswith("_b")}
    for key in ("qkv", "proj", "fc", "out"):
        dense_blocks[f"{key}_w"] = proj(key)
    return {
        "wte": dq(qp["wte_q"], qp["wte_s"], qp.get("wte_m"), 2),
        "wpe": qp["wpe"],
        "lm_head": lm_head,
        "ln_f_g": qp["ln_f_g"],
        "ln_f_b": qp["ln_f_b"],
        "blocks": dense_blocks,
    }


# ------------------------------------------------------------------ codec


def _conv(t, name: str, cout: int, cin: int):
    """Conv weight+bias, restoring dims the converter squeezed away (k=1
    convs arrive 2-D, 1-channel convs lose their channel dim)."""
    w = t[f"{name}.weight"].to_float32().reshape(cout, cin, -1)
    b = np.atleast_1d(t[f"{name}.bias"].to_float32())
    return w, b


def _lstm(t, prefix: str):
    return [
        {
            "w_ih": t[f"{prefix}.lstm.weight_ih_l{l}"].to_float32(),
            "w_hh": t[f"{prefix}.lstm.weight_hh_l{l}"].to_float32(),
            "b_ih": t[f"{prefix}.lstm.bias_ih_l{l}"].to_float32(),
            "b_hh": t[f"{prefix}.lstm.bias_hh_l{l}"].to_float32(),
        }
        for l in (0, 1)
    ]


def codec_params_from_section(sec: CodecSection, device) -> Dict:
    """The codec's params (f32, as the JAX package keeps them) from a
    parsed CodecSection: `bark_tpu.models.encodec.params_from_section`.
    The encoder, which only voice presets from audio run, loads when the
    file holds it."""
    t = sec.tensors
    C0 = sec.hparams.n_filters * 2 ** len(RATIOS)
    embeds = []
    while f"quantizer.vq.layers.{len(embeds)}._codebook.embed" in t:
        embeds.append(
            t[f"quantizer.vq.layers.{len(embeds)}._codebook.embed"]
            .to_float32()
        )

    def res_unit(prefix: str, dim: int) -> Dict:
        b1w, b1b = _conv(t, f"{prefix}.block.1.conv.conv", dim // 2, dim)
        b3w, b3b = _conv(t, f"{prefix}.block.3.conv.conv", dim, dim // 2)
        sw, sb = _conv(t, f"{prefix}.shortcut.conv.conv", dim, dim)
        return {
            "block1_w": b1w, "block1_b": b1b,
            "block3_w": b3w, "block3_b": b3b,
            "shortcut_w": sw, "shortcut_b": sb,
        }

    stages = []
    C = C0
    for i in range(len(RATIOS)):
        convtr_idx = 3 + 3 * i
        name = f"decoder.model.{convtr_idx}.convtr.convtr"
        stage = {  # ConvTranspose1d weights are (Cin, Cout, K)
            "convtr_w": t[f"{name}.weight"].to_float32().reshape(C, C // 2, -1),
            "convtr_b": np.atleast_1d(t[f"{name}.bias"].to_float32()),
        }
        stage.update(res_unit(f"decoder.model.{convtr_idx + 1}", C // 2))
        stages.append(stage)
        C //= 2
    ci_w, ci_b = _conv(
        t, "decoder.model.0.conv.conv", C0, sec.hparams.hidden_dim
    )
    co_w, co_b = _conv(t, "decoder.model.15.conv.conv", 1, C)
    tree = {
        "quantizer": np.stack(embeds),
        "decoder": {
            "conv_in_w": ci_w, "conv_in_b": ci_b,
            "lstm": _lstm(t, "decoder.model.1"),
            "stages": stages,
            "conv_out_w": co_w, "conv_out_b": co_b,
        },
    }
    if "encoder.model.0.conv.conv.weight" in t:
        enc_stages = []
        C = sec.hparams.n_filters
        for i in range(len(RATIOS)):
            res_idx = 1 + 3 * i
            stage = res_unit(f"encoder.model.{res_idx}", C)
            dw, db = _conv(t, f"encoder.model.{res_idx + 2}.conv.conv",
                           2 * C, C)
            stage.update({"down_w": dw, "down_b": db})
            enc_stages.append(stage)
            C *= 2
        ei_w, ei_b = _conv(t, "encoder.model.0.conv.conv",
                           sec.hparams.n_filters, sec.hparams.in_channels)
        eo_w, eo_b = _conv(t, "encoder.model.15.conv.conv",
                           sec.hparams.hidden_dim, C)
        tree["encoder"] = {
            "conv_in_w": ei_w, "conv_in_b": ei_b,
            "stages": enc_stages,
            "lstm": _lstm(t, "encoder.model.13"),
            "conv_out_w": eo_w, "conv_out_b": eo_b,
        }
    return params_from_numpy(tree, torch.float32, device)


def codec_shapes(cfg: CodecConfig, with_encoder: bool = False) -> Dict:
    """The codec params tree of shapes (tuples), as
    `bark_tpu.models.encodec.init_params` lays it out (with the encoder
    when `with_encoder`)."""
    def res_unit(dim):
        return {
            "block1_w": (dim // 2, dim, cfg.residual_kernel_size),
            "block1_b": (dim // 2,),
            "block3_w": (dim, dim // 2, 1),
            "block3_b": (dim,),
            "shortcut_w": (dim, dim, 1),
            "shortcut_b": (dim,),
        }

    C0 = cfg.n_filters * 2 ** len(RATIOS)
    C = C0
    stages = []
    for r in RATIOS:
        stage = {"convtr_w": (C, C // 2, 2 * r), "convtr_b": (C // 2,)}
        stage.update(res_unit(C // 2))
        stages.append(stage)
        C //= 2
    lstm = [
        {"w_ih": (4 * C0, C0), "w_hh": (4 * C0, C0),
         "b_ih": (4 * C0,), "b_hh": (4 * C0,)}
        for _ in range(2)
    ]
    tree = {
        "quantizer": (cfg.n_q_total, cfg.n_bins, cfg.hidden_dim),
        "decoder": {
            "conv_in_w": (C0, cfg.hidden_dim, cfg.kernel_size),
            "conv_in_b": (C0,),
            "lstm": lstm,
            "stages": stages,
            "conv_out_w": (1, C, cfg.kernel_size),
            "conv_out_b": (1,),
        },
    }
    if with_encoder:
        C = cfg.n_filters
        enc_stages = []
        for r in reversed(RATIOS):
            stage = res_unit(C)
            stage.update({"down_w": (2 * C, C, 2 * r), "down_b": (2 * C,)})
            enc_stages.append(stage)
            C *= 2
        tree["encoder"] = {
            "conv_in_w": (cfg.n_filters, cfg.in_channels, cfg.kernel_size),
            "conv_in_b": (cfg.n_filters,),
            "stages": enc_stages,
            "lstm": [{"w_ih": (4 * C, C), "w_hh": (4 * C, C),
                      "b_ih": (4 * C,), "b_hh": (4 * C,)}
                     for _ in range(2)],
            "conv_out_w": (cfg.hidden_dim, C, cfg.kernel_size),
            "conv_out_b": (cfg.hidden_dim,),
        }
    return tree


def codec_init_params_numpy(cfg: CodecConfig, seed: int,
                            scale: float = 0.05,
                            with_encoder: bool = False) -> Dict:
    """Random f32 codec params, array for array the same draws as
    `bark_tpu.models.encodec.init_params_host` (with the encoder when
    `with_encoder`): one RandomState(seed), drawn in JAX's pytree order
    (dict keys sorted, lists in order)."""
    rng = np.random.RandomState(seed)

    def fill(node):
        if isinstance(node, dict):
            out = {k: fill(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, list):
            return [fill(v) for v in node]
        return (rng.randn(*node) * scale).astype(np.float32)

    return fill(codec_shapes(cfg, with_encoder))
