"""Minimal RIFF/WAVE writer and reader for 32-bit float mono PCM.

The reference writes IEEE-float WAV via the vendored dr_wav
(the reference's examples/common.cpp:11-25: 1 channel, 24 kHz, 32-bit float).
The stdlib `wave` module only handles integer PCM, so the float container is
assembled by hand; it is 58 bytes of header plus raw little-endian floats.

The port's copy of `bark_tpu.utils.wav`; tests/test_torch_shared_copies.py
holds the two byte-equal.
"""

from __future__ import annotations

import struct

import numpy as np

WAVE_FORMAT_IEEE_FLOAT = 3


def wav_bytes(audio: np.ndarray, sample_rate: int = 24000) -> bytes:
    """Serialize mono float32 PCM to an in-memory IEEE-float WAV."""
    import io

    buf = io.BytesIO()
    _write_wav_to(buf, audio, sample_rate)
    return buf.getvalue()


def wav_stream_header(sample_rate: int = 24000) -> bytes:
    """A WAV header for a stream of unknown length (RIFF and data sizes set
    to 0xFFFFFFFF, the convention players and ffmpeg accept for live
    streams); follow with raw little-endian float32 sample chunks."""
    n_channels, bits = 1, 32
    byte_rate = sample_rate * n_channels * bits // 8
    block_align = n_channels * bits // 8
    parts = [b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE", b"fmt "]
    parts.append(
        struct.pack(
            "<IHHIIHHH", 18, WAVE_FORMAT_IEEE_FLOAT, n_channels,
            sample_rate, byte_rate, block_align, bits, 0,
        )
    )
    parts += [b"data", struct.pack("<I", 0xFFFFFFFF)]
    return b"".join(parts)


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 24000) -> None:
    """Write mono float32 PCM to `path` (IEEE-float WAV, like dr_wav)."""
    with open(path, "wb") as f:
        _write_wav_to(f, audio, sample_rate)


def _write_wav_to(f, audio: np.ndarray, sample_rate: int) -> None:
    pcm = np.ascontiguousarray(audio, dtype="<f4").reshape(-1)
    data = pcm.tobytes()
    n_channels, bits = 1, 32
    byte_rate = sample_rate * n_channels * bits // 8
    block_align = n_channels * bits // 8
    f.write(b"RIFF")
    f.write(struct.pack("<I", 4 + (8 + 18) + (8 + 4) + (8 + len(data))))
    f.write(b"WAVE")
    # fmt chunk (18 bytes: WAVE_FORMAT_IEEE_FLOAT carries cbSize=0)
    f.write(b"fmt ")
    f.write(
        struct.pack(
            "<IHHIIHHH",
            18,
            WAVE_FORMAT_IEEE_FLOAT,
            n_channels,
            sample_rate,
            byte_rate,
            block_align,
            bits,
            0,
        )
    )
    # fact chunk (required for non-PCM formats)
    f.write(b"fact")
    f.write(struct.pack("<II", 4, len(pcm)))
    f.write(b"data")
    f.write(struct.pack("<I", len(data)))
    f.write(data)


def read_wav(path: str):
    """Read a WAV file -> (float32 mono array, sample_rate).

    Handles IEEE-float 32-bit and integer PCM 16-bit, mono or multi-channel
    (channels averaged), which covers both this writer and common test vectors.
    """
    with open(path, "rb") as f:
        riff, _, wave_tag = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_tag != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            payload = f.read(size)
            if size % 2:  # chunks are word-aligned
                f.read(1)
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        audio_fmt, n_channels, sample_rate, _, _, bits = fmt
        if audio_fmt == WAVE_FORMAT_IEEE_FLOAT and bits == 32:
            pcm = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif audio_fmt == 1 and bits == 16:
            pcm = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif audio_fmt == 1 and bits == 32:
            pcm = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported format {audio_fmt}/{bits}")
        if n_channels > 1:
            pcm = pcm.reshape(-1, n_channels).mean(axis=1)
        return pcm, sample_rate
