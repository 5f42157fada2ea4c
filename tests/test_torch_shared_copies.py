"""The port's own copies of bark_tpu's jax-free host modules (params,
tokenizer, the ggml reader and writer, the block quantizers, the file
quantizer, the voice presets, the sentence splitter, the WAV writer and
reader, the checkpoint converter) against their originals, on seeded
data: equal defaults, equal token lists, record-for-record equal model
files read by the other package's reader, bit-equal quantized blocks,
byte-equal quantized files, equal histories from the same presets, equal
sentence lists, byte-equal WAV files and converted model files."""

import dataclasses

import numpy as np
import pytest

from bark_tpu import params as jparams
from bark_tpu.io import convert as jconvert
from bark_tpu.io import ggml as jggml
from bark_tpu.io import quant as jquant
from bark_tpu.io import quantize as jquantize
from bark_tpu.pipeline import voice as jvoice
from bark_tpu.text import longform as jlongform
from bark_tpu.text import tokenizer as jtok
from bark_tpu.utils import wav as jwav
from bark_tpu_torch import params as tparams
from bark_tpu_torch.io import convert as tconvert
from bark_tpu_torch.io import ggml as tggml
from bark_tpu_torch.io import quant as tquant
from bark_tpu_torch.io import quantize as tquantize
from bark_tpu_torch.pipeline import voice as tvoice
from bark_tpu_torch.text import longform as tlongform
from bark_tpu_torch.text import tokenizer as ttok
from bark_tpu_torch.utils import wav as twav

from tiny_model import VOCAB, build_tiny_model, tiny_params

QTYPES = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
          "q2_k", "q3_k", "q4_k", "q5_k", "q6_k")


def test_params_defaults_equal():
    jf = dataclasses.fields(jparams.BarkContextParams)
    tf = dataclasses.fields(tparams.BarkContextParams)
    assert [f.name for f in tf] == [f.name for f in jf]
    j, t = jparams.BarkContextParams(), tparams.BarkContextParams()
    for f in jf:
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert tparams.bark_context_default_params() == t
    for enum in ("Verbosity", "EncodingStep"):
        je, te = getattr(jparams, enum), getattr(tparams, enum)
        assert [(m.name, m.value) for m in te] == [(m.name, m.value)
                                                   for m in je]
        assert all(te[m.name] == m for m in je)  # IntEnums compare as ints


TEXTS = [
    "hello world",
    "Hello, World! the 42 wo",
    "héllo wörld àçñ — ünïcode ☃ stays out",
    "a" * 40 + " tok3 ## [CLS] 1234567 !?",
    " ".join(["hello world the a"] * 90),  # past 256 tokens
    "",
]


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_tokenizer_equal(text):
    vocab = VOCAB + ["h", "##e", "##l", "##o", "w", "!", "?", ",", "4",
                     "##2", "1", "##234567", "[", "]", "#", "C", "##LS"]
    jv, tv = jtok.Vocab.from_tokens(vocab), ttok.Vocab.from_tokens(vocab)
    for n in (256, 16):
        assert (ttok.bert_tokenize(tv, text, n)
                == jtok.bert_tokenize(jv, text, n))
    for block in (256, 1024):
        for p in (jparams.BarkContextParams(), tiny_params()):
            j = jtok.tokenize_input(jv, text, p, block_size=block)
            assert ttok.tokenize_input(tv, text, p, block_size=block) == j


def _records_equal(a, b):
    assert list(a.tensors) == list(b.tensors)
    assert dataclasses.asdict(a.hparams) == dataclasses.asdict(b.hparams)
    for name, ra in a.tensors.items():
        rb = b.tensors[name]
        assert (ra.shape, int(ra.ttype)) == (rb.shape, int(rb.ttype)), name
        assert bytes(ra.data) == bytes(rb.data), name


def _models_equal(a, b):
    assert a.vocab == b.vocab
    for sec in ("semantic", "coarse", "fine", "codec"):
        _records_equal(getattr(a, sec), getattr(b, sec))


@pytest.mark.parametrize("ftype", ["f32", "q5_1"])
def test_model_files_read_across(tmp_path, ftype):
    """A file written by each package reads record for record the same
    with the other's reader."""
    src = str(tmp_path / "w.bin")
    jggml.write_model_file(src, build_tiny_model())
    if ftype != "f32":
        path = str(tmp_path / "wq.bin")
        jquantize.model_quantize(src, path,
                                 int(jggml.GGMLFType.MOSTLY_Q5_1))
    else:
        path = src
    jm = jggml.read_model_file(path)
    tm = tggml.read_model_file(path)
    _models_equal(tm, jm)
    back = str(tmp_path / "back.bin")
    tggml.write_model_file(back, tm)
    _models_equal(jggml.read_model_file(back), jm)
    assert open(back, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("qtype", QTYPES)
def test_block_codecs_bit_equal(qtype):
    """quantize_blocks / dequantize_blocks of both packages on seeded data,
    small and past the size where bark_tpu hands the simple formats to its
    C++ codec."""
    rng = np.random.default_rng(5)
    for n in (256 * 3, 256 * 96):
        x = (rng.standard_normal(n) * rng.uniform(0.01, 3.0)).astype(
            np.float32)
        x[::97] = 0.0  # zero runs inside some blocks
        raw = jquant.quantize_blocks(x, qtype)
        np.testing.assert_array_equal(tquant.quantize_blocks(x, qtype), raw)
        np.testing.assert_array_equal(
            tquant.dequantize_blocks(raw, qtype, n),
            jquant.dequantize_blocks(raw, qtype, n))


@pytest.mark.parametrize("qtype", tquant.PACKABLE)
def test_repack_bit_equal(qtype):
    assert tquant.PACKABLE == jquant.PACKABLE
    x = (np.random.default_rng(6).standard_normal(256 * 24) * 0.1).astype(
        np.float32)
    raw = jquant.quantize_blocks(x, qtype)
    for a, b in zip(tquant.repack_to_int8(raw, qtype, x.size),
                    jquant.repack_to_int8(raw, qtype, x.size)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_format_tables_equal():
    assert tquant.BLOCK_BYTES == jquant.BLOCK_BYTES
    assert tquant.BLOCK_ELEMS == jquant.BLOCK_ELEMS
    assert ({int(k): v for k, v in tggml.QUANT_NAME.items()}
            == {int(k): v for k, v in jggml.QUANT_NAME.items()})
    assert ({int(k): int(v) for k, v in tggml.FTYPE_TO_TYPE.items()}
            == {int(k): int(v) for k, v in jggml.FTYPE_TO_TYPE.items()})
    assert ({int(t) for t in tggml.PACKABLE_TYPES}
            == {int(t) for t in jggml.PACKABLE_TYPES})
    assert tquantize.QUANTIZE_NAME_PATTERNS == jquantize.QUANTIZE_NAME_PATTERNS


@pytest.mark.parametrize("ftype,n_embd", [("MOSTLY_Q4_0", 32),
                                          ("MOSTLY_Q8_0", 32),
                                          ("MOSTLY_Q5_1", 32),
                                          ("MOSTLY_Q4_K", 256)])
def test_model_quantize_byte_equal(tmp_path, ftype, n_embd):
    src = str(tmp_path / "w.bin")
    jggml.write_model_file(src, build_tiny_model(n_embd=n_embd))
    ft = int(jggml.GGMLFType[ftype])
    jout, tout = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    assert jquantize.model_quantize(src, jout, ft)
    assert tquantize.model_quantize(src, tout, ft)
    assert open(tout, "rb").read() == open(jout, "rb").read()


# seeded presets (semantic, coarse, fine lengths): short, each history at
# its cap and past it, odd lengths, an audio-only preset (no semantic)
PRESETS = [(5, 9, 9), (18, 52, 40), (19, 61, 512), (256, 630, 513),
           (300, 700, 600), (0, 30, 30), (1, 1, 1), (41, 3, 7)]


def _preset(mod, n_sem, n_coarse, n_fine, seed):
    rng = np.random.RandomState(seed)
    return mod.VoicePreset(
        semantic=rng.randint(0, 16, n_sem).astype(np.int32),
        coarse=rng.randint(0, 8, (2, n_coarse)).astype(np.int32),
        fine=rng.randint(0, 8, (8, n_fine)).astype(np.int32))


@pytest.mark.parametrize("sizes", PRESETS, ids=[
    "-".join(map(str, p)) for p in PRESETS])
@pytest.mark.parametrize("cap", [60, 630])
def test_voice_histories_equal(sizes, cap, tmp_path):
    """Every function of pipeline/voice.py that needs no codec, on the
    same seeded preset: the prompt's history slots, the trimmed coarse
    histories, the fine rows, the preset from a generation's buffers, and
    a file saved by one package loaded by the other."""
    p = tiny_params(max_coarse_history=cap)
    j = _preset(jvoice, *sizes, seed=sum(sizes))
    t = _preset(tvoice, *sizes, seed=sum(sizes))
    j.validate(p)
    t.validate(p)
    np.testing.assert_array_equal(tvoice.semantic_history_tokens(t, p),
                                  jvoice.semantic_history_tokens(j, p))
    for a, b in zip(tvoice.coarse_history(t, p), jvoice.coarse_history(j, p)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tvoice.fine_history(t, p),
                                  jvoice.fine_history(j, p))
    for mod in (tvoice, jvoice):
        assert mod.semantic_history_tokens(None, p) is None
        assert all(a.size == 0 for a in mod.coarse_history(None, p))
        assert mod.fine_history(None, p).shape == (0, 8)
    gen = (t.semantic, t.coarse.T, t.fine.T)
    for a, b in zip(vars(tvoice.preset_from_generation(*gen, p)).values(),
                    vars(jvoice.preset_from_generation(*gen, p)).values()):
        np.testing.assert_array_equal(a, b)
    tvoice.save_voice_preset(str(tmp_path / "t.npz"), t)
    jvoice.save_voice_preset(str(tmp_path / "j.npz"), j)
    for path in ("t.npz", "j.npz"):
        a = tvoice.load_voice_preset(str(tmp_path / path))
        b = jvoice.load_voice_preset(str(tmp_path / path))
        for name in ("semantic", "coarse", "fine"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("fault", ["semantic_range", "semantic_2d",
                                   "coarse_rows", "fine_rows", "fine_range",
                                   "not_a_preset"])
def test_voice_validation_equal(fault, tmp_path):
    """The two copies refuse the same malformed presets with the same
    message."""
    p = tiny_params()
    arrays = dict(semantic=np.zeros(4, np.int32),
                  coarse=np.zeros((2, 4), np.int32),
                  fine=np.zeros((8, 4), np.int32))
    if fault == "semantic_range":
        arrays["semantic"][1] = 16
    elif fault == "semantic_2d":
        arrays["semantic"] = np.zeros((2, 2), np.int32)
    elif fault == "coarse_rows":
        arrays["coarse"] = np.zeros((3, 4), np.int32)
    elif fault == "fine_rows":
        arrays["fine"] = np.zeros((7, 4), np.int32)
    elif fault == "fine_range":
        arrays["fine"][2, 1] = -1
    errors = []
    for mod in (tvoice, jvoice):
        with pytest.raises(ValueError) as e:
            if fault == "not_a_preset":
                path = str(tmp_path / "x.npz")
                np.savez(path, semantic_prompt=arrays["semantic"])
                mod.load_voice_preset(path)
            else:
                mod.VoicePreset(**arrays).validate(p)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


LONG_TEXTS = [
    "Hello world. How are you? Fine!",
    "  one sentence without an ender  ",
    "a" * 500,
    "x, " * 120 + "end.",
    "Semi; colon: and, commas " * 12,
    "",
    "Wait... what?!  Yes.\nNew line. Été ici.",
]


@pytest.mark.parametrize("text", LONG_TEXTS, ids=range(len(LONG_TEXTS)))
@pytest.mark.parametrize("max_chars", [220, 40])
def test_split_sentences_equal(text, max_chars):
    assert (tlongform.split_sentences(text, max_chars)
            == jlongform.split_sentences(text, max_chars))


@pytest.mark.parametrize("n", [0, 1, 4801])
def test_wav_equal(n, tmp_path):
    """The WAV writers give the same bytes, in memory and on disk, the
    stream headers too, and each reader reads the other's file."""
    audio = np.random.default_rng(n).normal(0, 0.3, n).astype(np.float32)
    assert twav.wav_bytes(audio, 24000) == jwav.wav_bytes(audio, 24000)
    assert twav.wav_stream_header(16000) == jwav.wav_stream_header(16000)
    paths = [str(tmp_path / "t.wav"), str(tmp_path / "j.wav")]
    twav.write_wav(paths[0], audio)
    jwav.write_wav(paths[1], audio)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    for path in paths:
        (ta, tsr), (ja, jsr) = twav.read_wav(path), jwav.read_wav(path)
        assert tsr == jsr == 24000
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(ta, audio)


def test_read_wav_int16_stereo_equal(tmp_path):
    import struct

    pcm = (np.arange(-40, 40, dtype=np.int16) * 300).reshape(-1, 2)
    data = pcm.tobytes()
    path = str(tmp_path / "s.wav")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 8000, 32000, 4,
                                      16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    (ta, tsr), (ja, jsr) = twav.read_wav(path), jwav.read_wav(path)
    assert tsr == jsr == 8000 and ta.shape == (40,)
    np.testing.assert_array_equal(ta, ja)


def hf_snapshot(d):
    """A synthetic HF suno/bark snapshot (pytorch_model.bin, config.json,
    vocab.txt) in directory `d`, at the tiny model's sizes, built with
    tests/test_convert.py's state dicts."""
    import json
    import pathlib

    import torch

    import tiny_model as tm
    from test_convert import _codec_state, _gpt_state

    d = pathlib.Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    shapes = dict(
        semantic=(320, tm.SEMANTIC_INFER + 1, tm.SEMANTIC_VOCAB),
        coarse_acoustics=(384, tm.COARSE_INFER + 1,
                          tm.SEMANTIC_VOCAB + 2 * tm.CODEBOOK),
        fine_acoustics=(64, tm.CODEBOOK + 1, tm.CODEBOOK + 1))
    state, config = {}, {}
    for prefix, (block, n_in, n_out) in shapes.items():
        fine = prefix == "fine_acoustics"
        state.update(_gpt_state(prefix, rng, n_layer=2, n_embd=32,
                                block=block, n_in=n_in, n_out=n_out,
                                ln_bias=fine, n_wtes=8 if fine else 1,
                                n_heads_lm=7 if fine else 1))
        config[f"{prefix}_config"] = dict(
            num_layers=2, num_heads=2, hidden_size=32, block_size=block,
            bias=False, input_vocab_size=n_in, output_vocab_size=n_out,
            **(dict(n_codes_total=8, n_codes_given=1) if fine else {}))
    state.update(_codec_state(rng))
    config["codec_config"] = dict(
        audio_channels=1, hidden_size=16, num_filters=2, kernel_size=7,
        residual_kernel_size=3, codebook_size=tm.CODEBOOK,
        sampling_rate=24000)
    torch.save(state, d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps(config))
    (d / "vocab.txt").write_text("".join(t + "\n" for t in tm.VOCAB))
    return d


@pytest.mark.parametrize("use_f16", [False, True])
def test_convert_byte_equal(tmp_path, use_f16):
    """Both converters write the same bytes from one HF snapshot; the
    weight-norm fold is the same function."""
    snap = hf_snapshot(tmp_path / "hf")
    paths = [str(tmp_path / "t.bin"), str(tmp_path / "j.bin")]
    tconvert.convert(str(snap), paths[0], use_f16=use_f16)
    jconvert.convert(str(snap), paths[1], use_f16=use_f16)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    rng = np.random.default_rng(1)
    v = rng.normal(size=(6, 4, 5)).astype(np.float32)
    g = np.abs(rng.normal(size=(6, 1, 1))).astype(np.float32) + 0.1
    np.testing.assert_array_equal(tconvert.weight_norm_fold(v, g),
                                  jconvert.weight_norm_fold(v, g))
