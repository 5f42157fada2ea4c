"""ggml block-quantization formats q4_0 / q4_1 / q5_0 / q5_1 / q8_0.

The port's copy of `bark_tpu.io.quant`, numpy only (the JAX package's
optional C++ codec is left out; tests/test_torch_shared_copies.py holds the
two bit-equal). Bit-exact re-implementations of the ggml reference
quantizers used by `bark_model_quantize` (bark.cpp:272-478 via
ggml_quantize_chunk).
Each block covers QK=32 consecutive f32 values:

  q4_0: {f16 d;            u8 qs[16]}  x = (q - 8) * d,  d = max/-8
  q4_1: {f16 d; f16 m;     u8 qs[16]}  x = q * d + m,    d = (max-min)/15
  q5_0: {f16 d; u32 qh;    u8 qs[16]}  x = (q - 16) * d, d = max/-16
  q5_1: {f16 d; f16 m; u32 qh; u8 qs[16]}  x = q * d + m, d = (max-min)/31
  q8_0: {f16 d;            i8 qs[32]}  x = q * d,        d = amax/127

Nibble layout: qs[j] holds value j in the low nibble and value j+16 in the
high nibble. q5 high bits: bit j of qh is the 5th bit of value j (j<16), and
bit j+16 for the second half.

k-quants (q2_k .. q6_k): the reference ENGINE accepts these types in model
files (bark.cpp:287-291 routes the ftypes; the layouts are
ggml's public super-block formats over QK_K=256 values). The read path here
decodes them exactly per the ggml layout; the write path uses a simple
round-to-nearest sub-block quantizer (valid blocks, not bit-identical to
ggml's error-minimizing search — the reference CLI never writes k-quants).
See the `_Q*K` helpers below for the per-format bit layouts.
"""

from __future__ import annotations

import numpy as np

QK = 32  # block size shared by the q*_0 / q*_1 / q8_0 formats
QK_K = 256  # super-block size of the k-quant formats

# Bytes per block of each quantized type.
BLOCK_BYTES = {
    "q4_0": 2 + 16,
    "q4_1": 2 + 2 + 16,
    "q5_0": 2 + 4 + 16,
    "q5_1": 2 + 2 + 4 + 16,
    "q8_0": 2 + 32,
    # k-quants: {fields} per 256 values (ggml block_q*_K structs)
    "q2_k": 16 + 64 + 2 + 2,  # scales[16] qs[64] d dmin        = 84
    "q3_k": 32 + 64 + 12 + 2,  # hmask[32] qs[64] scales[12] d  = 110
    "q4_k": 2 + 2 + 12 + 128,  # d dmin scales[12] qs[128]      = 144
    "q5_k": 2 + 2 + 12 + 32 + 128,  # d dmin scales[12] qh qs   = 176
    "q6_k": 128 + 64 + 16 + 2,  # ql[128] qh[64] scales[16] d   = 210
}

# Values per block, per type (32 for the simple formats, 256 for k-quants).
BLOCK_ELEMS = {
    name: (QK_K if name.endswith("_k") else QK) for name in BLOCK_BYTES
}

# Types the packed-serving path can repack losslessly into
# (int8 values, per-32 f32 scales[, mins]): everything whose sub-block
# scale granularity divides 32. q2_k/q3_k/q6_k have per-16 sub-scales and
# must dequantize at load instead.
PACKABLE = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k")


def _as_blocks(x: np.ndarray, elems: int = QK) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % elems != 0:
        raise ValueError(f"size {x.size} not a multiple of {elems}")
    return x.reshape(-1, elems)


def _signed_absmax(xb: np.ndarray) -> np.ndarray:
    """Per-block value with the largest magnitude, keeping its sign (ggml
    tracks `max` alongside `amax` and divides by the signed value)."""
    idx = np.argmax(np.abs(xb), axis=1)
    return xb[np.arange(xb.shape[0]), idx]


def _safe_inv(d: np.ndarray) -> np.ndarray:
    return np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    # q: (nb, 32) uint8 -> (nb, 16): low nibble j, high nibble j+16
    return (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)


def _unpack_nibbles(qs: np.ndarray) -> np.ndarray:
    lo = qs & 0x0F
    hi = qs >> 4
    return np.concatenate([lo, hi], axis=1)


def _pack_qh(hi_bit: np.ndarray) -> np.ndarray:
    # hi_bit: (nb, 32) in {0,1}; bit j of qh is element j's 5th bit
    weights = (1 << np.arange(32, dtype=np.uint64))
    qh = (hi_bit.astype(np.uint64) * weights).sum(axis=1)
    return qh.astype(np.uint32)


def _unpack_qh(qh: np.ndarray) -> np.ndarray:
    bits = (qh[:, None].astype(np.uint64) >> np.arange(32, dtype=np.uint64)) & 1
    return bits.astype(np.uint8)


def quantize_blocks(x: np.ndarray, qtype: str) -> np.ndarray:
    """Quantize a float32 array (size divisible by 32) into raw block
    bytes."""
    if qtype.endswith("_k"):
        return _quantize_kblocks(_as_blocks(x, QK_K), qtype)
    xb = _as_blocks(x)
    nb = xb.shape[0]
    if qtype == "q4_0":
        d = (_signed_absmax(xb) / -8.0).astype(np.float32)
        q = np.clip((xb * _safe_inv(d)[:, None] + 8.5).astype(np.int32), 0, 15)
        out = np.empty((nb, BLOCK_BYTES["q4_0"]), dtype=np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:] = _pack_nibbles(q.astype(np.uint8))
    elif qtype == "q4_1":
        mn = xb.min(axis=1)
        mx = xb.max(axis=1)
        d = ((mx - mn) / 15.0).astype(np.float32)
        q = np.clip(
            ((xb - mn[:, None]) * _safe_inv(d)[:, None] + 0.5).astype(np.int32),
            0, 15,
        )
        out = np.empty((nb, BLOCK_BYTES["q4_1"]), dtype=np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 4:] = _pack_nibbles(q.astype(np.uint8))
    elif qtype == "q5_0":
        d = (_signed_absmax(xb) / -16.0).astype(np.float32)
        q = np.clip((xb * _safe_inv(d)[:, None] + 16.5).astype(np.int32), 0, 31)
        out = np.empty((nb, BLOCK_BYTES["q5_0"]), dtype=np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:6] = _pack_qh((q >> 4) & 1).view(np.uint8).reshape(nb, 4)
        out[:, 6:] = _pack_nibbles((q & 0x0F).astype(np.uint8))
    elif qtype == "q5_1":
        mn = xb.min(axis=1)
        mx = xb.max(axis=1)
        d = ((mx - mn) / 31.0).astype(np.float32)
        q = np.clip(
            ((xb - mn[:, None]) * _safe_inv(d)[:, None] + 0.5).astype(np.int32),
            0, 31,
        )
        out = np.empty((nb, BLOCK_BYTES["q5_1"]), dtype=np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 4:8] = _pack_qh((q >> 4) & 1).view(np.uint8).reshape(nb, 4)
        out[:, 8:] = _pack_nibbles((q & 0x0F).astype(np.uint8))
    elif qtype == "q8_0":
        d = (np.abs(xb).max(axis=1) / 127.0).astype(np.float32)
        v = xb * _safe_inv(d)[:, None]
        # ggml uses roundf (half away from zero), not numpy's half-to-even
        q = np.trunc(v + np.copysign(0.5, v)).astype(np.int8)
        out = np.empty((nb, BLOCK_BYTES["q8_0"]), dtype=np.uint8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:] = q.view(np.uint8)
    else:
        raise ValueError(f"unsupported quant type: {qtype}")
    return out.reshape(-1)


def dequantize_blocks(raw: np.ndarray, qtype: str, n_elements: int) -> np.ndarray:
    """Dequantize raw block bytes back to float32 (n_elements values)."""
    if qtype.endswith("_k"):
        return _dequantize_kblocks(raw, qtype, n_elements)
    bb = BLOCK_BYTES[qtype]
    nb = n_elements // QK
    blocks = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)[
        : nb * bb
    ].reshape(nb, bb)
    if qtype == "q4_0":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        q = _unpack_nibbles(blocks[:, 2:]).astype(np.float32)
        x = (q - 8.0) * d
    elif qtype == "q4_1":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
        q = _unpack_nibbles(blocks[:, 4:]).astype(np.float32)
        x = q * d + m
    elif qtype == "q5_0":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        qh = _unpack_qh(blocks[:, 2:6].copy().view(np.uint32).reshape(-1))
        q = _unpack_nibbles(blocks[:, 6:]) | (qh << 4)
        x = (q.astype(np.float32) - 16.0) * d
    elif qtype == "q5_1":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
        qh = _unpack_qh(blocks[:, 4:8].copy().view(np.uint32).reshape(-1))
        q = _unpack_nibbles(blocks[:, 8:]) | (qh << 4)
        x = q.astype(np.float32) * d + m
    elif qtype == "q8_0":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        q = blocks[:, 2:].view(np.int8).astype(np.float32)
        x = q * d
    else:
        raise ValueError(f"unsupported quant type: {qtype}")
    return x.reshape(-1).astype(np.float32)


def repack_to_int8(raw: np.ndarray, qtype: str, n_elements: int):
    """Repack quantized blocks into an (int8 values, f32 scales, f32 mins)
    triple for the packed decode kernel (K5).

    Returns (values int8 [n], scales f32 [n/32], mins f32 [n/32]); the
    dequantized value is `values * scales + mins` broadcast per 32-block.
    For the offset-free formats (q4_0/q5_0/q8_0) mins is all zeros and values
    already include the -8/-16 recentering. q4_k/q5_k repack losslessly too:
    their sub-blocks are exactly 32 wide, so scale32 = d*sc and
    min32 = -dmin*m reproduce the ggml dequantization bit-for-bit.
    """
    if qtype in ("q4_k", "q5_k"):
        q, s, m = _unpack_k45(raw, qtype, n_elements)
        return (
            q.astype(np.int8).reshape(-1),
            s.reshape(-1),
            m.reshape(-1),
        )
    bb = BLOCK_BYTES[qtype]
    nb = n_elements // QK
    blocks = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)[
        : nb * bb
    ].reshape(nb, bb)
    if qtype == "q4_0":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        q = _unpack_nibbles(blocks[:, 2:]).astype(np.int16) - 8
        return q.astype(np.int8).reshape(-1), d, np.zeros_like(d)
    if qtype == "q4_1":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
        q = _unpack_nibbles(blocks[:, 4:]).astype(np.int8)
        return q.reshape(-1), d, m
    if qtype == "q5_0":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        qh = _unpack_qh(blocks[:, 2:6].copy().view(np.uint32).reshape(-1))
        q = (_unpack_nibbles(blocks[:, 6:]) | (qh << 4)).astype(np.int16) - 16
        return q.astype(np.int8).reshape(-1), d, np.zeros_like(d)
    if qtype == "q5_1":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
        qh = _unpack_qh(blocks[:, 4:8].copy().view(np.uint32).reshape(-1))
        q = (_unpack_nibbles(blocks[:, 8:]) | (qh << 4)).astype(np.int8)
        return q.reshape(-1), d, m
    if qtype == "q8_0":
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        q = blocks[:, 2:].view(np.int8)
        return q.reshape(-1).copy(), d, np.zeros_like(d)
    raise ValueError(f"unsupported quant type: {qtype}")


# ----------------------------------------------------------------- k-quants
#
# Super-blocks of QK_K=256 values. Element order inside a super-block is the
# ggml dequantize_row_q*_K output order; in that order the sub-block scale
# granularity is simply contiguous runs of 16 (q2/q3/q6) or 32 (q4/q5)
# values. What varies per format is the BIT layout mapping element positions
# to packed bytes, captured by the (de)interleave helpers below.


def _kraw(raw, qtype: str, n_elements: int) -> np.ndarray:
    bb = BLOCK_BYTES[qtype]
    nb = n_elements // QK_K
    if n_elements % QK_K:
        raise ValueError(f"{qtype}: size {n_elements} not a multiple of 256")
    return np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)[
        : nb * bb
    ].reshape(nb, bb)


def _f16(b2: np.ndarray) -> np.ndarray:
    return b2.copy().view(np.float16).astype(np.float32).reshape(-1)


def _scales_k4(s12: np.ndarray):
    """Unpack the 12-byte q4_K/q5_K scale field into 8 six-bit (scale, min)
    pairs (ggml get_scale_min_k4)."""
    nb = s12.shape[0]
    sc = np.empty((nb, 8), np.float32)
    mi = np.empty((nb, 8), np.float32)
    for j in range(4):
        sc[:, j] = s12[:, j] & 63
        mi[:, j] = s12[:, j + 4] & 63
        sc[:, j + 4] = (s12[:, j + 8] & 0x0F) | ((s12[:, j] >> 6) << 4)
        mi[:, j + 4] = (s12[:, j + 8] >> 4) | ((s12[:, j + 4] >> 6) << 4)
    return sc, mi


def _pack_scales_k4(Ls: np.ndarray, Lm: np.ndarray) -> np.ndarray:
    """Inverse of _scales_k4: 8 six-bit (scale, min) pairs -> 12 bytes."""
    nb = Ls.shape[0]
    s12 = np.zeros((nb, 12), np.uint8)
    for j in range(4):
        s12[:, j] = (Ls[:, j] & 63) | ((Ls[:, j + 4] >> 4) << 6)
        s12[:, j + 4] = (Lm[:, j] & 63) | ((Lm[:, j + 4] >> 4) << 6)
        s12[:, j + 8] = (Ls[:, j + 4] & 0x0F) | ((Lm[:, j + 4] & 0x0F) << 4)
    return s12


def _unpack_q2(qs: np.ndarray) -> np.ndarray:
    """(nb, 64) 2-bit-packed bytes -> (nb, 256) values in ggml element
    order: value[half*128 + shift*32 + l] = (qs[half*32 + l] >> 2*shift) & 3."""
    nb = qs.shape[0]
    qs2 = qs.reshape(nb, 2, 1, 32)
    shifts = (2 * np.arange(4, dtype=np.uint8)).reshape(1, 1, 4, 1)
    return ((qs2 >> shifts) & 3).reshape(nb, QK_K)


def _pack_q2(v: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_q2: (nb, 256) values in {0..3} -> (nb, 64)."""
    nb = v.shape[0]
    v4 = v.reshape(nb, 2, 4, 32).astype(np.uint8)
    out = np.zeros((nb, 2, 32), np.uint8)
    for g in range(4):
        out |= v4[:, :, g, :] << (2 * g)
    return out.reshape(nb, 64)


def _unpack_nib_k45(qs: np.ndarray) -> np.ndarray:
    """(nb, 128) nibble-packed -> (nb, 8, 32): chunk c's byte l holds
    sub-block 2c (low nibble) and 2c+1 (high nibble)."""
    nb = qs.shape[0]
    qs4 = qs.reshape(nb, 4, 32)
    return np.stack([qs4 & 0x0F, qs4 >> 4], axis=2).reshape(nb, 8, 32)


def _pack_nib_k45(v: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_nib_k45: (nb, 8, 32) low-4-bit values -> (nb, 128)."""
    nb = v.shape[0]
    v = v.reshape(nb, 4, 2, 32).astype(np.uint8)
    return (v[:, :, 0, :] | (v[:, :, 1, :] << 4)).reshape(nb, 128)


def _dequantize_kblocks(raw, qtype: str, n_elements: int) -> np.ndarray:
    blocks = _kraw(raw, qtype, n_elements)
    nb = blocks.shape[0]
    if qtype in ("q4_k", "q5_k"):
        q, s, m = _unpack_k45(raw, qtype, n_elements)
        y = q.astype(np.float32) * np.repeat(s, 32).reshape(nb, QK_K) \
            + np.repeat(m, 32).reshape(nb, QK_K)
        return y.reshape(-1)
    if qtype == "q2_k":
        sfield = blocks[:, 0:16]
        q = _unpack_q2(blocks[:, 16:80]).astype(np.float32)
        d = _f16(blocks[:, 80:82])
        dmin = _f16(blocks[:, 82:84])
        sc = (sfield & 0x0F).astype(np.float32)  # (nb, 16) per-16 scales
        mi = (sfield >> 4).astype(np.float32)
        dl = np.repeat(d[:, None] * sc, 16, axis=1)  # (nb, 256)
        ml = np.repeat(dmin[:, None] * mi, 16, axis=1)
        return (dl * q - ml).reshape(-1)
    if qtype == "q3_k":
        hmask, qs = blocks[:, 0:32], blocks[:, 32:96]
        s12 = blocks[:, 96:108]
        d = _f16(blocks[:, 108:110])
        # 16 six-bit scales packed in 12 bytes (ggml kmask shuffle): for
        # word k in 0..3, scales[k]=lo4(b[k])|2bits(b[8+k],0), [4+k]=
        # lo4(b[4+k])|2bits(b[8+k],2), [8+k]=hi4(b[k])|2bits(b[8+k],4),
        # [12+k]=hi4(b[4+k])|2bits(b[8+k],6); stored value minus 32.
        sc = np.empty((nb, 16), np.int32)
        for k in range(4):
            sc[:, k] = (s12[:, k] & 0x0F) | ((s12[:, 8 + k] & 3) << 4)
            sc[:, 4 + k] = (s12[:, 4 + k] & 0x0F) | (
                ((s12[:, 8 + k] >> 2) & 3) << 4
            )
            sc[:, 8 + k] = (s12[:, k] >> 4) | (((s12[:, 8 + k] >> 4) & 3) << 4)
            sc[:, 12 + k] = (s12[:, 4 + k] >> 4) | (
                ((s12[:, 8 + k] >> 6) & 3) << 4
            )
        sc -= 32
        q2 = _unpack_q2(qs).astype(np.int32)  # low 2 bits, element order
        # high bit: element (half, shift, l) reads bit (half*4+shift) of
        # hmask[l]; q -= 4 where the high bit is NOT set
        bit = np.arange(8, dtype=np.uint8).reshape(1, 8, 1)
        hb = ((hmask[:, None, :] >> bit) & 1).reshape(nb, QK_K)
        q = q2 - 4 * (1 - hb.astype(np.int32))
        dl = np.repeat(d[:, None] * sc.astype(np.float32), 16, axis=1)
        return (dl * q.astype(np.float32)).reshape(-1)
    if qtype == "q6_k":
        ql = blocks[:, 0:128].reshape(nb, 2, 64)
        qh = blocks[:, 128:192].reshape(nb, 2, 32)
        sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
        d = _f16(blocks[:, 208:210])
        lo0, lo1 = ql[:, :, :32] & 0x0F, ql[:, :, 32:] & 0x0F
        hi0, hi1 = ql[:, :, :32] >> 4, ql[:, :, 32:] >> 4
        g = np.stack(
            [
                lo0 | (((qh >> 0) & 3) << 4),
                lo1 | (((qh >> 2) & 3) << 4),
                hi0 | (((qh >> 4) & 3) << 4),
                hi1 | (((qh >> 6) & 3) << 4),
            ],
            axis=2,
        )  # (nb, 2, 4, 32) in element order half*128 + g*32 + l
        q = g.reshape(nb, QK_K).astype(np.int32) - 32
        dl = np.repeat(d[:, None] * sc, 16, axis=1)
        return (dl * q.astype(np.float32)).reshape(-1)
    raise ValueError(f"unsupported k-quant type: {qtype}")


def _unpack_k45(raw, qtype: str, n_elements: int):
    """q4_k/q5_k -> (values (nb,256) uint8, scale32 (nb,8) f32,
    min32 (nb,8) f32) with dequant == values*scale32 - (-min32) per 32."""
    blocks = _kraw(raw, qtype, n_elements)
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, mi = _scales_k4(blocks[:, 4:16])
    if qtype == "q4_k":
        q = _unpack_nib_k45(blocks[:, 16:144])
    else:
        qh = blocks[:, 16:48]  # (nb, 32): bit sb of qh[l] is sub-block sb's
        q = _unpack_nib_k45(blocks[:, 48:176])  # 5th bit of element l
        sb = np.arange(8, dtype=np.uint8).reshape(1, 8, 1)
        q = q | (((qh[:, None, :] >> sb) & 1) << 4)
    scale32 = d[:, None] * sc
    min32 = -(dmin[:, None] * mi)
    return q.reshape(nb, QK_K), scale32, min32


def _sub_minmax_quant(xb: np.ndarray, nsub: int, qmax: int, lbits: int):
    """Shared min/offset k-quantizer: per sub-block affine x ~= d*sc*q - mlo,
    with the sub-scales/mins themselves quantized to `lbits` against f16
    super-scales (ggml quantize_row_q2_K/q4_K/q5_K shape, round-to-nearest
    instead of the error-minimizing search).

    Returns (q (nb,nsub,sublen) uint8, Ls, Lm (nb,nsub) uint8, d16, dmin16).
    """
    nb = xb.shape[0]
    sub = xb.reshape(nb, nsub, QK_K // nsub)
    mn = np.minimum(sub.min(axis=2), 0.0)  # ggml clamps the min at <= 0
    mx = sub.max(axis=2)
    scale = (mx - mn) / qmax
    the_min = -mn  # >= 0
    lmax = (1 << lbits) - 1
    d = (scale.max(axis=1) / lmax).astype(np.float32)
    dmin = (the_min.max(axis=1) / lmax).astype(np.float32)
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    inv_d = np.where(d16 > 0, 1.0 / np.where(d16 == 0, 1, d16), 0.0)
    inv_m = np.where(dmin16 > 0, 1.0 / np.where(dmin16 == 0, 1, dmin16), 0.0)
    Ls = np.clip((scale * inv_d[:, None] + 0.5).astype(np.int32), 0, lmax)
    Lm = np.clip((the_min * inv_m[:, None] + 0.5).astype(np.int32), 0, lmax)
    eff_scale = d16[:, None] * Ls  # quantize against the DECODER's values
    eff_min = dmin16[:, None] * Lm
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1, eff_scale), 0.0)
    q = np.clip(
        ((sub + eff_min[:, :, None]) * inv_s[:, :, None] + 0.5).astype(
            np.int32
        ),
        0,
        qmax,
    ).astype(np.uint8)
    return q, Ls.astype(np.uint8), Lm.astype(np.uint8), d16, dmin16


def _sub_sym_quant(xb: np.ndarray, nsub: int, qlim: int, smax: int):
    """Shared symmetric k-quantizer: x ~= d*sc*q, q in [-qlim, qlim-1],
    signed sub-scales quantized to [-smax-1, smax] against an f16 d.

    Returns (q (nb,nsub,sublen) int32, Lsc (nb,nsub) int32, d16)."""
    nb = xb.shape[0]
    sub = xb.reshape(nb, nsub, QK_K // nsub)
    idx = np.argmax(np.abs(sub), axis=2)
    smax_val = np.take_along_axis(sub, idx[:, :, None], axis=2)[:, :, 0]
    scale = smax_val / -qlim  # sign tracks the extremum, like q4_0
    d = (np.abs(scale).max(axis=1) / smax).astype(np.float32)
    d16 = d.astype(np.float16).astype(np.float32)
    inv_d = np.where(d16 != 0, 1.0 / np.where(d16 == 0, 1, d16), 0.0)
    Lsc = np.clip(
        np.round(scale * inv_d[:, None]).astype(np.int32), -smax - 1, smax
    )
    eff = d16[:, None] * Lsc.astype(np.float32)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1, eff), 0.0)
    q = np.clip(
        np.round(sub * inv_s[:, :, None]).astype(np.int32), -qlim, qlim - 1
    )
    return q, Lsc, d16


def _quantize_kblocks(xb: np.ndarray, qtype: str) -> np.ndarray:
    nb = xb.shape[0]
    out = np.zeros((nb, BLOCK_BYTES[qtype]), np.uint8)
    if qtype == "q2_k":
        q, Ls, Lm, d16, dmin16 = _sub_minmax_quant(xb, 16, 3, 4)
        out[:, 0:16] = Ls | (Lm << 4)
        out[:, 16:80] = _pack_q2(q.reshape(nb, QK_K))
        out[:, 80:82] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 82:84] = dmin16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    elif qtype == "q3_k":
        q, Lsc, d16 = _sub_sym_quant(xb, 16, 4, 31)
        v = (q + 4).reshape(nb, QK_K).astype(np.uint8)  # 0..7
        out[:, 32:96] = _pack_q2((v & 3).astype(np.uint8))
        # high bit: element (half, shift, l) -> bit (half*4+shift) of hmask[l]
        hb = ((v >> 2) & 1).reshape(nb, 8, 32)
        hm = np.zeros((nb, 32), np.uint8)
        for b in range(8):
            hm |= hb[:, b, :] << b
        out[:, 0:32] = hm
        s6 = (Lsc + 32).astype(np.uint8)  # 0..63
        for k in range(4):
            out[:, 96 + k] = (s6[:, k] & 0x0F) | ((s6[:, 8 + k] & 0x0F) << 4)
            out[:, 100 + k] = (s6[:, 4 + k] & 0x0F) | (
                (s6[:, 12 + k] & 0x0F) << 4
            )
            out[:, 104 + k] = (
                (s6[:, k] >> 4)
                | (((s6[:, 4 + k] >> 4)) << 2)
                | ((s6[:, 8 + k] >> 4) << 4)
                | ((s6[:, 12 + k] >> 4) << 6)
            )
        out[:, 108:110] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    elif qtype in ("q4_k", "q5_k"):
        qmax = 15 if qtype == "q4_k" else 31
        q, Ls, Lm, d16, dmin16 = _sub_minmax_quant(xb, 8, qmax, 6)
        out[:, 0:2] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:4] = dmin16.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 4:16] = _pack_scales_k4(Ls, Lm)
        if qtype == "q4_k":
            out[:, 16:144] = _pack_nib_k45(q)
        else:
            out[:, 48:176] = _pack_nib_k45((q & 0x0F).astype(np.uint8))
            hb = (q >> 4) & 1  # (nb, 8, 32)
            qh = np.zeros((nb, 32), np.uint8)
            for sb in range(8):
                qh |= hb[:, sb, :] << sb
            out[:, 16:48] = qh
    elif qtype == "q6_k":
        q, Lsc, d16 = _sub_sym_quant(xb, 16, 32, 127)
        v = (q + 32).reshape(nb, 2, 4, 32).astype(np.uint8)  # 0..63
        lo, hi = v & 0x0F, (v >> 4) & 3
        ql = np.concatenate(
            [lo[:, :, 0, :] | (lo[:, :, 2, :] << 4),
             lo[:, :, 1, :] | (lo[:, :, 3, :] << 4)],
            axis=2,
        )  # (nb, 2, 64)
        qh = (
            hi[:, :, 0, :]
            | (hi[:, :, 1, :] << 2)
            | (hi[:, :, 2, :] << 4)
            | (hi[:, :, 3, :] << 6)
        )  # (nb, 2, 32)
        out[:, 0:128] = ql.reshape(nb, 128)
        out[:, 128:192] = qh.reshape(nb, 64)
        out[:, 192:208] = np.clip(Lsc, -128, 127).astype(np.int8).view(
            np.uint8
        )
        out[:, 208:210] = d16.astype(np.float16).view(np.uint8).reshape(nb, 2)
    else:
        raise ValueError(f"unsupported k-quant type: {qtype}")
    return out.reshape(-1)
