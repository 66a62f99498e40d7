"""Frame -> word audio pooling as a dense matmul (the JAX package's
ops/pooling.py:75-118).

The host builds, per sample, a pooling matrix P (W_max, T_audio) whose row
w holds 1/n_w over word w's span of 25 Hz audio tokens; the device computes
word_emb = P @ token_emb. Reference quirks kept (models/jegal.py:213-252):
spans are [start - first_start, end - first_start + 1], clamped to the
available tokens; a negative or empty span makes the sample invalid.
"""

from __future__ import annotations

import numpy as np
import torch


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
