"""A deterministic stand-in for xlm-roberta-base's tokenizer at the full
vocabulary, with the duck-typed backend interface that
`jegal_torch.text.WordTokenizer` takes.

Frozen copy of `PieceTokenizer` from chip_smoke.py:424 (repository root);
the card machine has no `tokenizers` wheel and the repository no XLM-R
vocabulary. The plain reference tokenizes with this class too, through
its own word splitting (reference/jegal.py), never through the port's."""

from __future__ import annotations

import zlib
from types import SimpleNamespace


class PieceTokenizer:
    """Each word splits into pieces of at most 3 characters (offsets inside
    the word), each piece's id is a fixed function of its text in [3,
    vocab) (crc32), and <s>=0 / </s>=2 wrap the sequence, XLM-R's special
    ids."""

    def __init__(self, vocab: int = 250002):
        self.vocab = vocab
        self.pad_id, self.length = 1, None

    def enable_padding(self, pad_id, pad_token, length=None):
        self.pad_id, self.length = pad_id, length

    def piece_id(self, piece: str) -> int:
        return 3 + zlib.crc32(piece.encode()) % (self.vocab - 3)

    def encode_batch(self, batch, is_pretokenized=True):
        if not is_pretokenized:
            raise ValueError("PieceTokenizer encodes pretokenized words only")
        rows = []
        for words in batch:
            ids, offs = [0], [(0, 0)]
            for w in words:
                for i in range(0, len(w), 3):
                    piece = w[i:i + 3]
                    ids.append(self.piece_id(piece))
                    offs.append((i, i + len(piece)))
            rows.append((ids + [2], offs + [(0, 0)]))
        s = max([len(ids) for ids, _ in rows] + [self.length or 0])
        return [SimpleNamespace(
            ids=ids + [self.pad_id] * (s - len(ids)),
            attention_mask=[1] * len(ids) + [0] * (s - len(ids)),
            offsets=offs + [(0, 0)] * (s - len(ids))) for ids, offs in rows]
