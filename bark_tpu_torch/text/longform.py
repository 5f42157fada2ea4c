"""Sentence splitting for long-form generation.

Bark's semantic stage generates at most `n_steps_text_encoder` (768) tokens
~= 15 s of audio per utterance, and its prompt holds 256 text tokens; both
the reference (bark.cpp:624-651, hard truncation) and suno simply cut
longer inputs. suno's documented long-form recipe (the notebooks under
suno-ai/bark/notebooks) splits the script into sentences and generates them
one at a time, each conditioned on the previous generation as its history
prompt. This module provides the splitter for api.context.generate_audio_long.

The port's copy of `bark_tpu.text.longform`; tests/test_torch_shared_copies.py
holds the two equal.
"""

from __future__ import annotations

import re
from typing import List

# sentence enders followed by whitespace; keeps the ender with the sentence
_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+")
# secondary break points for over-long sentences, best first
_SOFT_BREAKS = (";", ":", ",", " ")


def split_sentences(text: str, max_chars: int = 220) -> List[str]:
    """Split `text` into generation-sized pieces.

    Sentence boundaries first; any sentence longer than `max_chars`
    (roughly Bark's 256-token prompt budget for English text) is further
    split at the latest soft break (;:, or space) before the limit. Returns
    stripped, non-empty pieces whose concatenation covers the input text.
    """
    pieces: List[str] = []
    for sentence in _SENTENCE_RE.split(text.strip()):
        sentence = sentence.strip()
        while len(sentence) > max_chars:
            cut = -1
            for br in _SOFT_BREAKS:
                cut = sentence.rfind(br, 1, max_chars + 1)
                if cut > 0:
                    break
            if cut <= 0:  # one unbreakable run: hard cut
                cut = max_chars
            head, sentence = sentence[: cut + 1].strip(), sentence[
                cut + 1 :
            ].strip()
            if head:
                pieces.append(head)
        if sentence:
            pieces.append(sentence)
    return pieces
