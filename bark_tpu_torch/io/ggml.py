"""Reader/writer for the single-file `ggml_weights.bin` Bark model format.

The port's copy of `bark_tpu.io.ggml` with the pure-Python reader and
writer only (the JAX package's native mmap scanner is left out;
tests/test_torch_shared_copies.py reads each package's files with the
other's reader, record for record).

Layout (defined by convert.py:293-348, read by bark.cpp:664-1184):

  1. int32 magic 0x67676d6c ("ggml")
  2. vocab: int32 n_vocab, then per token {int32 len, bytes}
  3. three GPT sections in order semantic -> coarse -> fine, each:
       10 x int32 hparams (n_layer, n_head, n_embd, block_size, bias,
                           n_in_vocab, n_out_vocab, n_lm_heads, n_wtes, ftype)
       int32 n_tensors
       n_tensors x tensor records
  4. int32 magic again, then the EnCodec section:
       9 x int32 hparams (in_channels, hidden_dim, n_filters, kernel_size,
                          residual_kernel_size, n_bins, bandwidth, sr, ftype)
       tensor records until EOF

  Tensor record: {int32 n_dims, int32 name_len, int32 ttype,
                  int32 ne[n_dims] (reversed vs numpy), name bytes, data}.

The GPT section `ftype` field may carry the quantization version encoded as
`qntvr*1000 + ftype` (bark.cpp:711,727; GGML_QNT_VERSION=2).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import BinaryIO, Dict, List

import numpy as np

from bark_tpu_torch.io import quant

GGML_MAGIC = 0x67676D6C
GGML_QNT_VERSION = 2


class GGMLType(enum.IntEnum):
    """ggml tensor data types (subset used by bark)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    I8 = 24
    I16 = 25
    I32 = 26


class GGMLFType(enum.IntEnum):
    """ggml model file types (ggml_ftype)."""

    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q4_1_SOME_F16 = 4
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K = 11
    MOSTLY_Q4_K = 12
    MOSTLY_Q5_K = 13
    MOSTLY_Q6_K = 14


FTYPE_TO_TYPE = {
    GGMLFType.ALL_F32: GGMLType.F32,
    GGMLFType.MOSTLY_F16: GGMLType.F16,
    GGMLFType.MOSTLY_Q4_0: GGMLType.Q4_0,
    GGMLFType.MOSTLY_Q4_1: GGMLType.Q4_1,
    GGMLFType.MOSTLY_Q8_0: GGMLType.Q8_0,
    GGMLFType.MOSTLY_Q5_0: GGMLType.Q5_0,
    GGMLFType.MOSTLY_Q5_1: GGMLType.Q5_1,
    GGMLFType.MOSTLY_Q2_K: GGMLType.Q2_K,
    GGMLFType.MOSTLY_Q3_K: GGMLType.Q3_K,
    GGMLFType.MOSTLY_Q4_K: GGMLType.Q4_K,
    GGMLFType.MOSTLY_Q5_K: GGMLType.Q5_K,
    GGMLFType.MOSTLY_Q6_K: GGMLType.Q6_K,
}

QUANT_NAME = {
    GGMLType.Q4_0: "q4_0",
    GGMLType.Q4_1: "q4_1",
    GGMLType.Q5_0: "q5_0",
    GGMLType.Q5_1: "q5_1",
    GGMLType.Q8_0: "q8_0",
    # k-quants: accepted by the reference engine (bark.cpp:287-291) even
    # though its quantize CLI never writes them
    GGMLType.Q2_K: "q2_k",
    GGMLType.Q3_K: "q3_k",
    GGMLType.Q4_K: "q4_k",
    GGMLType.Q5_K: "q5_k",
    GGMLType.Q6_K: "q6_k",
}

# Types the packed-quantized serving path can repack losslessly
# (quant.PACKABLE); the rest dequantize at load.
PACKABLE_TYPES = frozenset(
    t for t, n in QUANT_NAME.items() if n in quant.PACKABLE
)

_PLAIN_DTYPES = {
    GGMLType.F32: np.dtype(np.float32),
    GGMLType.F16: np.dtype(np.float16),
    GGMLType.I8: np.dtype(np.int8),
    GGMLType.I16: np.dtype(np.int16),
    GGMLType.I32: np.dtype(np.int32),
}


def type_size_bytes(ttype: GGMLType, n_elements: int) -> int:
    if ttype in _PLAIN_DTYPES:
        return n_elements * _PLAIN_DTYPES[ttype].itemsize
    name = QUANT_NAME[ttype]
    elems = quant.BLOCK_ELEMS[name]
    assert n_elements % elems == 0, (ttype, n_elements)
    return (n_elements // elems) * quant.BLOCK_BYTES[name]


@dataclasses.dataclass
class GPTHParams:
    n_layer: int
    n_head: int
    n_embd: int
    block_size: int
    bias: int
    n_in_vocab: int
    n_out_vocab: int
    n_lm_heads: int
    n_wtes: int
    ftype: int
    n_codes_given: int = 1

    @property
    def qntvr(self) -> int:
        return self.ftype // 1000

    @property
    def base_ftype(self) -> int:
        return self.ftype % 1000


@dataclasses.dataclass
class CodecHParams:
    in_channels: int
    hidden_dim: int
    n_filters: int
    kernel_size: int
    residual_kernel_size: int
    n_bins: int
    bandwidth: int
    sample_rate: int
    ftype: int


@dataclasses.dataclass
class TensorRecord:
    name: str
    shape: tuple  # numpy-order shape (row-major, last dim contiguous)
    ttype: GGMLType
    data: bytes  # raw on-disk bytes

    def to_float32(self) -> np.ndarray:
        """Decode to a float32 numpy array of `shape`."""
        n = int(np.prod(self.shape)) if self.shape else 1
        if self.ttype in _PLAIN_DTYPES:
            arr = np.frombuffer(self.data, dtype=_PLAIN_DTYPES[self.ttype])
            return arr.astype(np.float32).reshape(self.shape)
        raw = np.frombuffer(self.data, dtype=np.uint8)
        return quant.dequantize_blocks(
            raw, QUANT_NAME[self.ttype], n
        ).reshape(self.shape)

    @classmethod
    def from_array(
        cls, name: str, arr: np.ndarray, ttype: GGMLType
    ) -> "TensorRecord":
        if ttype in _PLAIN_DTYPES:
            data = np.ascontiguousarray(
                arr.astype(_PLAIN_DTYPES[ttype])
            ).tobytes()
        else:
            data = quant.quantize_blocks(
                np.ascontiguousarray(arr, dtype=np.float32),
                QUANT_NAME[ttype],
            ).tobytes()
        return cls(name=name, shape=tuple(arr.shape), ttype=ttype, data=data)


@dataclasses.dataclass
class GPTSection:
    hparams: GPTHParams
    tensors: Dict[str, TensorRecord]


@dataclasses.dataclass
class CodecSection:
    hparams: CodecHParams
    tensors: Dict[str, TensorRecord]


@dataclasses.dataclass
class ModelFile:
    vocab: List[str]
    semantic: GPTSection
    coarse: GPTSection
    fine: GPTSection
    codec: CodecSection


# ----------------------------------------------------------------- reading


def _read_i32(f: BinaryIO) -> int:
    b = f.read(4)
    if len(b) != 4:
        raise EOFError("unexpected end of file")
    return struct.unpack("<i", b)[0]


def _read_vocab(f: BinaryIO) -> List[str]:
    n_vocab = _read_i32(f)
    toks = []
    for _ in range(n_vocab):
        ln = _read_i32(f)
        toks.append(f.read(ln).decode("utf-8", errors="replace"))
    return toks


def _read_tensor_record(f: BinaryIO) -> TensorRecord:
    n_dims = _read_i32(f)
    name_len = _read_i32(f)
    ttype = GGMLType(_read_i32(f))
    ne = [_read_i32(f) for _ in range(n_dims)]
    name = f.read(name_len).decode("utf-8")
    # ggml dims are reversed relative to numpy (convert.py:287)
    shape = tuple(reversed(ne))
    n_elements = 1
    for d in ne:
        n_elements *= d
    data = f.read(type_size_bytes(ttype, n_elements))
    return TensorRecord(name=name, shape=shape, ttype=ttype, data=data)


def _read_gpt_section(f: BinaryIO) -> GPTSection:
    vals = [_read_i32(f) for _ in range(10)]
    hp = GPTHParams(*vals)
    n_tensors = _read_i32(f)
    tensors: Dict[str, TensorRecord] = {}
    for _ in range(n_tensors):
        rec = _read_tensor_record(f)
        tensors[rec.name] = rec
    return GPTSection(hparams=hp, tensors=tensors)


def _read_codec_section(f: BinaryIO) -> CodecSection:
    magic = _read_i32(f)
    if magic != GGML_MAGIC:
        raise ValueError(f"bad codec magic: {magic:#x}")
    vals = [_read_i32(f) for _ in range(9)]
    hp = CodecHParams(*vals)
    tensors: Dict[str, TensorRecord] = {}
    while True:
        peek = f.read(4)
        if len(peek) < 4:
            break
        f.seek(-4, 1)
        rec = _read_tensor_record(f)
        tensors[rec.name] = rec
    return CodecSection(hparams=hp, tensors=tensors)


def read_model_file(path: str) -> ModelFile:
    """Parse ggml_weights.bin with the streaming Python reader."""
    with open(path, "rb") as f:
        magic = _read_i32(f)
        if magic != GGML_MAGIC:
            raise ValueError(
                f"invalid model file '{path}' (bad magic {magic:#x})"
            )
        vocab = _read_vocab(f)
        semantic = _read_gpt_section(f)
        coarse = _read_gpt_section(f)
        fine = _read_gpt_section(f)
        codec = _read_codec_section(f)
    return ModelFile(
        vocab=vocab, semantic=semantic, coarse=coarse, fine=fine, codec=codec
    )


# ----------------------------------------------------------------- writing


def _write_i32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<i", v))


def _write_vocab(f: BinaryIO, vocab: List[str]) -> None:
    _write_i32(f, len(vocab))
    for tok in vocab:
        data = tok.encode("utf-8")
        _write_i32(f, len(data))
        f.write(data)


def _write_tensor_record(f: BinaryIO, rec: TensorRecord) -> None:
    ne = list(reversed(rec.shape))
    name_b = rec.name.encode("utf-8")
    _write_i32(f, len(ne))
    _write_i32(f, len(name_b))
    _write_i32(f, int(rec.ttype))
    for d in ne:
        _write_i32(f, d)
    f.write(name_b)
    f.write(rec.data)


def _write_gpt_section(f: BinaryIO, sec: GPTSection) -> None:
    hp = sec.hparams
    for v in (
        hp.n_layer, hp.n_head, hp.n_embd, hp.block_size, hp.bias,
        hp.n_in_vocab, hp.n_out_vocab, hp.n_lm_heads, hp.n_wtes, hp.ftype,
    ):
        _write_i32(f, v)
    _write_i32(f, len(sec.tensors))
    for rec in sec.tensors.values():
        _write_tensor_record(f, rec)


def _write_codec_section(f: BinaryIO, sec: CodecSection) -> None:
    _write_i32(f, GGML_MAGIC)
    hp = sec.hparams
    for v in (
        hp.in_channels, hp.hidden_dim, hp.n_filters, hp.kernel_size,
        hp.residual_kernel_size, hp.n_bins, hp.bandwidth, hp.sample_rate,
        hp.ftype,
    ):
        _write_i32(f, v)
    for rec in sec.tensors.values():
        _write_tensor_record(f, rec)


def write_model_file(path: str, model: ModelFile) -> None:
    with open(path, "wb") as f:
        _write_i32(f, GGML_MAGIC)
        _write_vocab(f, model.vocab)
        for sec in (model.semantic, model.coarse, model.fine):
            _write_gpt_section(f, sec)
        _write_codec_section(f, model.codec)
