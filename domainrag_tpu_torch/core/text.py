"""Tokenization for the Flux text encoders (own copy of
``domainrag_tpu/core/text.py:28-73``).

:class:`StubTokenizer` is the deterministic hash tokenizer used for tests
and random-weight runs where no vocab files exist. Flux conventions: CLIP-L
padded/truncated to 77 with EOS pooling; T5 padded to 512.
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


def batch_tokenize(tok: TokenizerLike, prompts: Sequence[str],
                   max_len: int) -> np.ndarray:
    return np.stack([tok(p, max_len) for p in prompts])
