"""Text normalization (the JAX package's text/normalize.py, reference
inference_embs.py:318-332): lowercase and strip ASCII punctuation; a word
that normalizes to "" is skipped by its callers."""

from __future__ import annotations

import string


def preprocess_text(text: str) -> str:
    """Lowercase and strip punctuation."""
    text = text.lower()
    return "".join(c for c in text if c not in string.punctuation)
