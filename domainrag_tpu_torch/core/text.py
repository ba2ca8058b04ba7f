"""Tokenization for the Flux text encoders (own copy of
``domainrag_tpu/core/text.py``).

Two providers, both host-side:

- :func:`load_hf_tokenizers` — the real CLIP + T5 tokenizers from a local
  FLUX.1-dev checkpoint directory (``tokenizer`` / ``tokenizer_2``
  subfolders), through ``transformers``, imported only when called;
- :class:`StubTokenizer` — the deterministic hash tokenizer used for
  tests and random-weight runs where no vocab files exist.

Flux conventions: CLIP-L padded/truncated to 77 with EOS pooling; T5
padded to 512.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence

import numpy as np


class TokenizerLike(Protocol):
    def __call__(self, text: str, max_len: int) -> np.ndarray: ...


@dataclasses.dataclass
class StubTokenizer:
    """Deterministic word-hash tokenizer. bos/eos/pad ids mimic CLIP-style
    specials so EOS pooling paths are exercised."""

    vocab_size: int = 1000
    bos_id: Optional[int] = 998
    eos_id: int = 999
    pad_id: int = 0

    def __call__(self, text: str, max_len: int) -> np.ndarray:
        ids: List[int] = []
        if self.bos_id is not None:
            ids.append(self.bos_id)
        for word in text.lower().split():
            ids.append(abs(hash(word)) % (self.vocab_size - 3) + 1)
        ids.append(self.eos_id)
        ids = ids[:max_len]
        ids += [self.pad_id] * (max_len - len(ids))
        return np.asarray(ids, np.int32)


@dataclasses.dataclass
class HFTokenizer:
    """A ``transformers`` tokenizer as a :class:`TokenizerLike`: padded
    and truncated to ``max_len``, int32 ids."""

    tokenizer: object

    def __call__(self, text: str, max_len: int) -> np.ndarray:
        out = self.tokenizer(text, padding="max_length", max_length=max_len,
                             truncation=True, return_tensors="np")
        return out["input_ids"][0].astype(np.int32)


def load_hf_tokenizers(flux_dev_path: str):
    """(clip_tokenizer, t5_tokenizer) from a local FLUX.1-dev dir."""
    from transformers import CLIPTokenizer, T5TokenizerFast
    clip_tok = CLIPTokenizer.from_pretrained(flux_dev_path,
                                             subfolder="tokenizer")
    t5_tok = T5TokenizerFast.from_pretrained(flux_dev_path,
                                             subfolder="tokenizer_2")
    return HFTokenizer(clip_tok), HFTokenizer(t5_tok)


def batch_tokenize(tok: TokenizerLike, prompts: Sequence[str],
                   max_len: int) -> np.ndarray:
    return np.stack([tok(p, max_len) for p in prompts])
