"""Word-aligned subword batches for the text branch (the JAX package's
text/tokenizer.py, reference models/jegal.py:116-129).

Words come from a single-space split (`text.split(" ")`, reference
jegal.py:119) and are encoded pretokenized, with per-word character offsets
and batch padding. The backend is duck-typed: any object with
`enable_padding(pad_id=, pad_token=, length=)` and
`encode_batch(list_of_word_lists, is_pretokenized=True)` returning encodings
with `.ids`, `.attention_mask` and `.offsets`, such as a
`tokenizers.Tokenizer` loaded from xlm-roberta-base's tokenizer.json
(`WordTokenizer.from_file`, which imports `tokenizers` only when called).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class WordBatch:
    """A padded, word-aligned token batch.

    input_ids / attention_mask: (B, S) int32; offsets: (B, S, 2) int32;
    words: the per-sample word lists (after the single-space split);
    special_ids: ids that never start a word (cls, sep, pad).
    """

    input_ids: np.ndarray
    attention_mask: np.ndarray
    offsets: np.ndarray
    words: list[list[str]]
    special_ids: tuple[int, ...]


class WordTokenizer:
    """Pretokenized encoding with offsets over a duck-typed backend.

    For xlm-roberta-base: cls=0 '<s>', pad=1 '<pad>', sep=2 '</s>'.
    """

    def __init__(self, tokenizer, cls_id: int = 0, pad_id: int = 1,
                 sep_id: int = 2, pad_token: str = "<pad>"):
        self.tok = tokenizer
        self.cls_id = cls_id
        self.pad_id = pad_id
        self.sep_id = sep_id
        self.pad_token = pad_token

    @classmethod
    def from_file(cls, path: str, **kw):
        """A `tokenizers` JSON file (e.g. xlm-roberta-base's
        tokenizer.json); needs the `tokenizers` package."""
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(path), **kw)

    @property
    def special_ids(self) -> tuple[int, ...]:
        return (self.cls_id, self.sep_id, self.pad_id)

    def encode_words(self, texts: list[str],
                     pad_to: int | None = None) -> WordBatch:
        """Raw strings -> a WordBatch: each text splits on single spaces
        into words, encoded pretokenized with specials and batch padding."""
        words = [t.split(" ") for t in texts]
        self.tok.enable_padding(pad_id=self.pad_id, pad_token=self.pad_token,
                                length=pad_to)
        encs = self.tok.encode_batch(words, is_pretokenized=True)
        s = max(len(e.ids) for e in encs)
        b = len(encs)
        ids = np.full((b, s), self.pad_id, dtype=np.int32)
        mask = np.zeros((b, s), dtype=np.int32)
        offs = np.zeros((b, s, 2), dtype=np.int32)
        for i, e in enumerate(encs):
            n = len(e.ids)
            ids[i, :n] = e.ids
            mask[i, :n] = e.attention_mask
            offs[i, :n] = np.asarray(e.offsets, dtype=np.int32)
        return WordBatch(ids, mask, offs, words, self.special_ids)
