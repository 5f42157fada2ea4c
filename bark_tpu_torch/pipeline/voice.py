"""Voice presets (speaker history prompts) — a beyond-reference feature.

The port's copy of `bark_tpu.pipeline.voice` (that module needs no JAX
but belongs to the JAX package, which the port does not import);
tests/test_torch_shared_copies.py holds the two equal on seeded presets.
`preset_from_audio` runs the port's EnCodec encoder
(`models.encodec.encode_audio`) on the codec params' device.

The C++ reference hardcodes an EMPTY history: the 256 semantic-history slots
of the prompt are always `semantic_pad_token` and the coarse/fine stages
start from nothing (bark.cpp:640-651). suno's Python bark
(bark/generation.py) supports `history_prompt` .npz speaker files with keys

  semantic_prompt: (n,)  int, values < semantic_vocab_size (10000)
  coarse_prompt:   (n_coarse_codebooks, m) int, values < codebook_size
  fine_prompt:     (n_fine_codebooks, k)   int, values < codebook_size

and every suno voice preset (v2/en_speaker_0 ...) ships in this format.
This module mirrors suno's history semantics exactly:

- semantic: the last 256 history tokens fill the prompt's history slots,
  right-padded with semantic_pad_token (generate_text_semantic).
- coarse: histories are trimmed to mutually consistent lengths
  (n_sem_hist even, matching coarse length by the semantic->coarse ratio,
  capped by max_coarse_history), the coarse history is codebook-flattened
  (column-major interleave + per-channel codebook offsets + semantic vocab
  offset), and suno's `[:-2]` time-alignment trim is applied
  (generate_coarse, including its "bit of a hack" comment).
- fine: the last 512 history frames are prepended to the fine input and
  sliced off the output (generate_fine).

The exact-integer schedule arithmetic matches pipeline/coarse.py
(stc_fraction) so host- and device-side window math agree bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from bark_tpu_torch.params import BarkContextParams
from bark_tpu_torch.pipeline.coarse import CTX_SEMANTIC, stc_fraction

# suno prepends at most half a fine block of history (generate_fine)
FINE_HISTORY_MAX = 512


@dataclasses.dataclass
class VoicePreset:
    """A speaker prompt in suno's .npz layout (validated int32 arrays)."""

    semantic: np.ndarray  # (n,)
    coarse: np.ndarray  # (n_coarse_codebooks, m)
    fine: np.ndarray  # (n_fine_codebooks, k)

    def validate(self, params: BarkContextParams) -> None:
        p = params
        # empty semantic is allowed (audio-only presets, preset_from_audio):
        # the mutually-consistent trim then yields no coarse history and the
        # preset conditions the fine stage only
        if self.semantic.ndim != 1:
            raise ValueError("semantic_prompt must be a 1-D array")
        if self.semantic.size and (
            (self.semantic < 0).any()
            or (self.semantic >= p.semantic_vocab_size).any()
        ):
            raise ValueError(
                "semantic_prompt values must be in "
                f"[0, {p.semantic_vocab_size})"
            )
        if self.coarse.ndim != 2 or self.coarse.shape[0] != p.n_coarse_codebooks:
            raise ValueError(
                f"coarse_prompt must be ({p.n_coarse_codebooks}, m)"
            )
        if self.fine.ndim != 2 or self.fine.shape[0] != p.n_fine_codebooks:
            raise ValueError(f"fine_prompt must be ({p.n_fine_codebooks}, k)")
        for name, arr in (("coarse", self.coarse), ("fine", self.fine)):
            if arr.size and ((arr < 0).any() or (arr >= p.codebook_size).any()):
                raise ValueError(
                    f"{name}_prompt values must be in [0, {p.codebook_size})"
                )


def load_voice_preset(path: str) -> VoicePreset:
    """Read a suno-format .npz speaker file."""
    with np.load(path) as z:
        try:
            preset = VoicePreset(
                semantic=np.asarray(z["semantic_prompt"], np.int32),
                coarse=np.asarray(z["coarse_prompt"], np.int32),
                fine=np.asarray(z["fine_prompt"], np.int32),
            )
        except KeyError as e:
            raise ValueError(
                f"{path}: not a bark voice preset (missing {e})"
            ) from None
    return preset


def save_voice_preset(path: str, preset: VoicePreset) -> None:
    np.savez(
        path,
        semantic_prompt=preset.semantic,
        coarse_prompt=preset.coarse,
        fine_prompt=preset.fine,
    )


def semantic_history_tokens(
    preset: Optional[VoicePreset], params: BarkContextParams
) -> Optional[np.ndarray]:
    """The 256 history slots of the semantic prompt: last 256 preset tokens
    right-padded with semantic_pad_token (suno generate_text_semantic);
    None for the reference's empty history."""
    if preset is None:
        return None
    hist = preset.semantic[-CTX_SEMANTIC:]
    out = np.full((CTX_SEMANTIC,), params.semantic_pad_token, np.int32)
    out[: len(hist)] = hist
    return out


def _flatten_codebooks(arr: np.ndarray, offset_size: int) -> np.ndarray:
    """suno's _flatten_codebooks: add per-channel codebook offsets and
    interleave column-major (c0[0], c1[0], c0[1], ...)."""
    arr = arr.copy()
    for n in range(1, arr.shape[0]):
        arr[n, :] += offset_size * n
    return arr.ravel("F")


def coarse_history(
    preset: Optional[VoicePreset], params: BarkContextParams
) -> Tuple[np.ndarray, np.ndarray]:
    """(semantic history, flattened offset-carrying coarse history) for the
    coarse stage, trimmed to mutually consistent lengths exactly as suno's
    generate_coarse does. Empty arrays for no preset."""
    if preset is None:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    p = params
    num, den = stc_fraction(p)
    max_sem_hist = p.max_coarse_history * den // num
    x_sem = np.asarray(preset.semantic, np.int32)
    x_coarse = _flatten_codebooks(
        np.asarray(preset.coarse, np.int32), p.codebook_size
    ) + p.semantic_vocab_size
    # mutually consistent trim (suno): even semantic length, coarse length
    # rounding to the exact ratio, both capped by the history windows
    n_sem = min(
        max_sem_hist,
        len(x_sem) - len(x_sem) % 2,
        len(x_coarse) * den // num,
    )
    # round(n_sem * ratio) half-away-from-zero, integer-exact
    n_coarse = (2 * n_sem * num + den) // (2 * den)
    x_sem = x_sem[len(x_sem) - n_sem :]
    x_coarse = x_coarse[len(x_coarse) - n_coarse :]
    # suno: "bit of a hack for time alignment (sounds better)"
    x_coarse = x_coarse[: len(x_coarse) - 2] if len(x_coarse) >= 2 else x_coarse
    return x_sem, x_coarse


def preset_from_generation(
    semantic_tokens: np.ndarray,
    coarse_tokens: np.ndarray,
    fine_tokens: np.ndarray,
    params: BarkContextParams,
) -> VoicePreset:
    """Turn a finished generation's token buffers into a reusable voice
    preset — suno's `save_as_prompt(filepath, full_generation)` (bark/api.py),
    which the C++ reference cannot do at all. Input layouts are the
    BarkContext buffers (semantic (n,), coarse (m, n_coarse) and fine
    (m, n_fine) de-offset frame rows); the preset stores them in suno's
    channel-major .npz layout."""
    preset = VoicePreset(
        semantic=np.asarray(semantic_tokens, np.int32).reshape(-1),
        coarse=np.ascontiguousarray(
            np.asarray(coarse_tokens, np.int32).T
        ),
        fine=np.ascontiguousarray(np.asarray(fine_tokens, np.int32).T),
    )
    preset.validate(params)
    return preset


def preset_from_audio(
    codec_params,
    audio: np.ndarray,
    params: BarkContextParams,
    semantic_donor: Optional[VoicePreset] = None,
) -> VoicePreset:
    """Build a preset's acoustic channels (coarse/fine) from a waveform via
    the EnCodec *encoder* (models/encodec.encode_audio — the compression
    path the reference's submodule ships but its TTS pipeline never runs).

    Bark's semantic tokens come from a HuBERT-family audio->semantic model
    that is not part of bark.cpp or this framework, so the semantic channel
    must be donated: pass `semantic_donor` (any existing preset or a saved
    generation). Without a donor the semantic channel is empty and — by
    suno's mutually-consistent-length trim (coarse_history) — the coarse
    stage will run with no history; the fine stage still conditions on the
    encoded audio, giving timbre-only cloning."""
    import torch

    from bark_tpu_torch.models import encodec

    audio = np.asarray(audio, np.float32).reshape(-1)
    device = codec_params["quantizer"].device
    codes = encodec.encode_audio(
        codec_params, torch.from_numpy(audio).to(device),
        params.n_fine_codebooks,
    ).cpu().numpy().astype(np.int32)  # (n_frames, n_fine)
    fine = np.ascontiguousarray(codes.T)  # (n_fine, n_frames)
    semantic = (
        semantic_donor.semantic
        if semantic_donor is not None
        else np.zeros((0,), np.int32)
    )
    preset = VoicePreset(
        semantic=np.asarray(semantic, np.int32),
        coarse=fine[: params.n_coarse_codebooks],
        fine=fine,
    )
    preset.validate(params)
    return preset


def fine_history(
    preset: Optional[VoicePreset], params: BarkContextParams
) -> np.ndarray:
    """The (n_hist <= 512, n_fine_codebooks) rows prepended to the fine
    input (suno generate_fine); empty for no preset."""
    if preset is None:
        return np.zeros((0, params.n_fine_codebooks), np.int32)
    return np.asarray(preset.fine, np.int32).T[-FINE_HISTORY_MAX:]
