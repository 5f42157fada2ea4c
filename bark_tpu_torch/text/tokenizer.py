"""BERT WordPiece tokenizer and Bark prompt layout.

The port's copy of `bark_tpu.text.tokenizer`, without its optional C++
fast path (token-identical; tests/test_torch_shared_copies.py holds the
two equal). Behavioral contract (matches bark.cpp:480-662):

- ``strip_accents``: folds exactly the 52 hard-coded Latin accented codepoints;
  every other codepoint passes through unchanged (bark.cpp:486-556).
- word split: the C locale regex ``[[:punct:]]|[[:alpha:]]+|[[:digit:]]+`` —
  i.e. ASCII-only classes. Codepoints outside those classes (including any
  non-ASCII character that survives accent folding) are silently dropped.
- WordPiece: greedy longest-dictionary-prefix per word, continuation pieces
  prefixed ``"##"``; an unmatched leading character is skipped with the
  continuation prefix applied from then on (bark.cpp:588-617).
- NO lowercasing, despite the BERT-uncased vocab — an upstream quirk that is
  deliberately preserved (capitalized words mostly fall back to ##-pieces).
- ``tokenize_input`` produces the fixed 513-token prompt: up to 256 text ids
  offset by ``text_encoding_offset``, right-padded with ``text_pad_token``,
  then 256 × ``semantic_pad_token`` ("empty semantic history") and a single
  ``semantic_infer_token`` (bark.cpp:622-662).
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from bark_tpu_torch.params import BarkContextParams

# The reference's 52-entry accent-folding map (bark.cpp:488-541).
_ACCENT_MAP = {
    "À": "A", "Á": "A", "Â": "A", "Ã": "A", "Ä": "A", "Å": "A",
    "à": "a", "á": "a", "â": "a", "ã": "a", "ä": "a", "å": "a",
    "È": "E", "É": "E", "Ê": "E", "Ë": "E",
    "è": "e", "é": "e", "ê": "e", "ë": "e",
    "Ì": "I", "Í": "I", "Î": "I", "Ï": "I",
    "ì": "i", "í": "i", "î": "i", "ï": "i",
    "Ò": "O", "Ó": "O", "Ô": "O", "Õ": "O", "Ö": "O",
    "ò": "o", "ó": "o", "ô": "o", "õ": "o", "ö": "o",
    "Ù": "U", "Ú": "U", "Û": "U", "Ü": "U",
    "ù": "u", "ú": "u", "û": "u", "ü": "u",
    "Ý": "Y", "ý": "y",
    "Ç": "C", "ç": "c",
    "Ñ": "N", "ñ": "n",
}

# C-locale [[:punct:]] is exactly the ASCII punctuation set; [[:alpha:]] and
# [[:digit:]] are ASCII-only in the C locale used by std::regex.
_WORD_RE = re.compile(r"[!-/:-@\[-`{-~]|[A-Za-z]+|[0-9]+")


@dataclass
class Vocab:
    """Token <-> id maps (bark_vocab, bark.cpp:41-47)."""

    token_to_id: Dict[str, int] = field(default_factory=dict)
    id_to_token: Dict[int, str] = field(default_factory=dict)

    @classmethod
    def from_tokens(cls, tokens: Sequence[str]) -> "Vocab":
        v = cls()
        for i, t in enumerate(tokens):
            v.token_to_id[t] = i
            v.id_to_token[i] = t
        return v

    def __len__(self) -> int:
        return len(self.token_to_id)


def strip_accents(text: str) -> str:
    return "".join(_ACCENT_MAP.get(ch, ch) for ch in text)


def bert_tokenize(
    vocab: Vocab, text: str, n_max_tokens: int = 256, verbose: bool = False
) -> List[int]:
    """Greedy longest-match-first WordPiece (bert_tokenize, bark.cpp:558-620).

    Stops emitting once ``n_max_tokens - 1`` tokens are produced, like the
    reference's ``t >= n_max_tokens - 1`` guard.
    """
    words = _WORD_RE.findall(strip_accents(text))
    token_map = vocab.token_to_id

    tokens: List[int] = []
    for word in words:
        prefix = ""
        i, n = 0, len(word)
        while i < n:
            if len(tokens) >= n_max_tokens - 1:
                return tokens
            matched = False
            for j in range(n, i, -1):
                tid = token_map.get(prefix + word[i:j])
                if tid is not None:
                    tokens.append(tid)
                    i = j
                    prefix = "##"
                    matched = True
                    break
            if not matched:
                if verbose:
                    print(
                        f"bert_tokenize: unknown token '{word[i]}'",
                        file=sys.stderr,
                    )
                prefix = "##"
                i += 1
    return tokens


def tokenize_input(
    vocab: Vocab,
    text: str,
    params: BarkContextParams,
    block_size: int = 1024,
    semantic_history=None,
) -> List[int]:
    """Build the fixed 513-token semantic prompt (bark.cpp:622-662).

    Layout: [text ids + text_encoding_offset, right-padded with text_pad_token
    to 256] + [256 history slots] + [semantic_infer_token]. The history slots
    are 256 x semantic_pad_token (the reference hardcodes an empty history,
    bark.cpp:640-651) unless `semantic_history` supplies a voice preset's
    semantic tokens (exactly 256, already padded — see
    pipeline/voice.semantic_history_tokens; suno generate_text_semantic).
    """
    max_ctx_size = min(block_size, 256)
    ids = bert_tokenize(vocab, text, n_max_tokens=max_ctx_size)
    if len(ids) > max_ctx_size:
        print(
            f"tokenize_input: input sequence is too long "
            f"({len(ids)} > {max_ctx_size}), truncating sequence",
            file=sys.stderr,
        )
        ids = ids[:max_ctx_size]

    prompt = [t + params.text_encoding_offset for t in ids]
    prompt += [params.text_pad_token] * (max_ctx_size - len(prompt))
    if semantic_history is None:
        prompt += [params.semantic_pad_token] * 256
    else:
        assert len(semantic_history) == 256
        prompt += [int(t) for t in semantic_history]
    prompt.append(params.semantic_infer_token)
    assert len(prompt) == 256 + 256 + 1
    return prompt
