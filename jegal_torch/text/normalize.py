"""Text normalization and transcript parsing (the JAX package's
text/normalize.py), with the reference's text contract
(inference_embs.py:288-377):
  * transcript files: 'Text: ...' / 'Lang: ...' / blank /
    'WORD, START, END, SCORE' header / one row per word;
  * normalization: lowercase and strip ASCII punctuation; a word that
    normalizes to "" is skipped;
  * boundaries: seconds -> frames by round(t * fps), fps = 25.
"""

from __future__ import annotations

import string

FPS = 25


def preprocess_text(text: str) -> str:
    """Lowercase and strip punctuation (reference inference_embs.py:
    318-332)."""
    text = text.lower()
    return "".join(c for c in text if c not in string.punctuation)


def validate_text_file(path: str) -> bool:
    """Enforce the transcript format (reference inference_embs.py:
    288-316); a malformed file raises ValueError."""
    with open(path, "r", encoding="utf-8") as f:
        lines = [line.strip() for line in f.readlines()]
    if len(lines) < 4:
        raise ValueError(f"{path} is too short to be valid.")
    if not lines[0].startswith("Text: "):
        raise ValueError("First line must start with 'Text: '")
    if not lines[1].startswith("Lang: "):
        raise ValueError("Second line must start with 'Lang: '")
    if lines[2] != "":
        raise ValueError("Third line must be empty.")
    if lines[3] != "WORD, START, END, SCORE":
        raise ValueError("Fourth line must be 'WORD, START, END, SCORE'")
    return True


def load_text(path: str, fps: int = FPS):
    """A transcript file -> (text, word_boundaries), each boundary [word,
    start_frame, end_frame] (reference inference_embs.py:334-377, with its
    trailing space when the last row normalizes to an empty word)."""
    validate_text_file(path)
    with open(path, "r", encoding="utf-8") as f:
        rows = f.readlines()[4:]
    text = ""
    word_boundaries = []
    for i, line in enumerate(rows):
        parts = line.split(", ")
        word = preprocess_text(parts[0])
        if word == "":
            continue
        text += word
        if i != len(rows) - 1:
            text += " "
        word_boundaries.append([word, round(float(parts[1]) * fps),
                                round(float(parts[2]) * fps)])
    return text, word_boundaries
