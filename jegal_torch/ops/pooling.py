"""Word-level pooling as dense matmuls (the JAX package's ops/pooling.py).

The host builds, per sample, a pooling matrix P (W_max, S) whose row w
holds 1/n_w over word w's source positions; the device computes
word_emb = P @ token_emb. Two sources:

  * text: subword -> word, averaging each word's subword tokens
    (reference models/jegal.py:131-211);
  * audio: frame -> word, averaging the 25 Hz audio tokens inside each
    word's frame span (reference models/jegal.py:213-252).

Reference quirks kept exactly:
  * text: word w's subwords span [start_idx[w], start_idx[w+1]); the LAST
    detected word's span extends to the END of the padded token axis,
    including the </s> token (and padding, when B > 1) — reference
    models/jegal.py:168-171.
  * text: a sample is invalid when it has more words than detected word
    starts (the tokenizer merged words) or no words (jegal.py:158-171,
    200-211).
  * audio: spans are [start - first_start, end - first_start + 1], clamped
    to the available tokens; a negative or empty span makes the sample
    invalid.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def text_word_starts(input_ids: np.ndarray, offsets: np.ndarray,
                     special_ids: Sequence[int]) -> list[list[int]]:
    """Per-sample token indices that start a word: offset[0] == 0 and the
    token is not a special token (reference models/jegal.py:146-150)."""
    special = set(int(s) for s in special_ids)
    return [[i for i, (tid, off) in enumerate(zip(ids_row, off_row))
             if int(off[0]) == 0 and int(tid) not in special]
            for ids_row, off_row in zip(input_ids, offsets)]


def build_text_pooling(word_starts: list[list[int]], num_words: list[int],
                       seq_len: int, w_max: int):
    """-> (P (B, w_max, seq_len) f32, valid (B,) bool, counts (B,) int32).

    Rows past a sample's word count are zero; an invalid sample (more words
    than word starts, no words, or more than w_max) gets an all-zero P and
    valid=False."""
    b = len(word_starts)
    p = np.zeros((b, w_max, seq_len), dtype=np.float32)
    valid = np.zeros((b,), dtype=bool)
    counts = np.zeros((b,), dtype=np.int32)
    for i, (starts, nw) in enumerate(zip(word_starts, num_words)):
        if nw <= 0 or nw > len(starts) or nw > w_max:
            continue
        valid[i] = True
        counts[i] = nw
        for w in range(nw):
            lo = starts[w]
            # the last DETECTED start runs to the end of the padded axis;
            # a word before it (nw < len(starts)) ends at the next start
            hi = starts[w + 1] if w < len(starts) - 1 else seq_len
            if hi <= lo:
                hi = lo + 1
            p[i, w, lo:hi] = 1.0 / (hi - lo)
    return p, valid, counts


def build_audio_pooling(word_boundaries: list, t_audio: int, w_max: int):
    """word_boundaries: per sample, a list of [word, start_frame, end_frame]
    in 25 fps frame units (== audio-token units).
    -> (P (B, w_max, t_audio) f32, valid (B,) bool, counts (B,) int32)."""
    b = len(word_boundaries)
    p = np.zeros((b, w_max, t_audio), dtype=np.float32)
    valid = np.zeros((b,), dtype=bool)
    counts = np.zeros((b,), dtype=np.int32)
    for i, wbs in enumerate(word_boundaries):
        if not wbs or len(wbs) > w_max:
            continue
        actual_start = int(wbs[0][1])
        ok = True
        for w, entry in enumerate(wbs):
            lo = int(entry[1]) - actual_start
            hi = int(entry[2]) - actual_start + 1
            if lo < 0:
                ok = False
                break
            lo_c = min(lo, t_audio)
            hi_c = max(0, min(hi, t_audio))
            if hi_c <= lo_c:
                ok = False
                break
            p[i, w, lo_c:hi_c] = 1.0 / (hi_c - lo_c)
        if ok:
            valid[i] = True
            counts[i] = len(wbs)
        else:
            p[i] = 0.0
    return p, valid, counts


def pool_words(pooling_matrix, token_emb):
    """(B, W, S) @ (B, S, D) -> (B, W, D) word embeddings."""
    return torch.bmm(pooling_matrix, token_emb)
