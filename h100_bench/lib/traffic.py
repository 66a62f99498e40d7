"""The one traffic generator: a traffic mix is a JSON file of parameters
under workloads/, read here; no mix has code of its own.

A mix describes a fixed pool of clips and the calls made on it:

  entry            the module of entries/ whose calls the window makes:
                   "extract_many" (JegalEngine.extract_many on the clips'
                   planar frames, text, wav and word boundaries) or
                   "tower_many" (gestsync_features_from_raw_many on the
                   planar frames alone)
  modalities       extract_many's combo ("vta")
  batch_size       the entry's batch_size
  clips_per_call   each call takes this many clips: the pool repeated
                   (a whole number of times), in an order drawn from the
                   seed for that call
  pool.clips       the pool's size
  pool.seconds     [shortest, longest]: the clips' lengths are evenly
                   spaced over this range, the same for every seed
  pool.fps, pool.sample_rate
  pool.words_per_second, pool.word_letters {"edge", "inner"}: each clip
                   has round(words_per_second * seconds) words, evenly
                   spread over its frames; the first and last words have
                   `edge` letters, the others `inner`, so that a clip's
                   token, word and mel counts follow from its length alone
  pool.chin_rows   [lo, hi): each frame's chin row, drawn
  pool.wav_scale   the wav's standard deviation (raw int16 scale)
  pool.content     false: frames only (no text, wav or words)

The seed draws the pixels, chin rows, words, audio and every call's
order; it never changes a length or a count, so every seed asks for the
same set of shapes."""

from __future__ import annotations

import json
import string
from pathlib import Path

import numpy as np
import torch

from .repack import s2d_repack_torch
from .weights import derive_seed

FRAME = (270, 480, 3)


def load(path: Path) -> dict:
    with open(path) as f:
        mix = json.load(f)
    pool = mix["pool"]
    if mix["clips_per_call"] % pool["clips"]:
        raise ValueError("clips_per_call must be a whole number of pools")
    return mix


def _round(x: float) -> int:
    return int(np.floor(x + 0.5))


def lengths(mix: dict) -> list[int]:
    """Every clip's frame count, the same for every seed."""
    pool = mix["pool"]
    lo, hi = pool["seconds"]
    n = pool["clips"]
    return [_round(pool["fps"] * (lo + (hi - lo) * i / max(n - 1, 1)))
            for i in range(n)]


def word_counts(mix: dict) -> list[int]:
    pool = mix["pool"]
    return [max(1, _round(pool["words_per_second"] * t / pool["fps"]))
            for t in lengths(mix)]


def word_lengths(n: int, letters: dict) -> list[int]:
    return [letters["edge"] if i in (0, n - 1) else letters["inner"]
            for i in range(n)]


def make_pool(mix: dict, seed: int, device) -> list[dict]:
    """The pool's clips as the engine takes them: host arrays (planar
    uint8 frames (T, 90, 27, 160), masked and repacked from raw frames and
    chin rows drawn on `device`; float32 wav; text; word boundaries)."""
    pool = mix["pool"]
    ts = lengths(mix)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 21))
    clips = []
    for i, t in enumerate(ts):
        raw = torch.randint(0, 256, (t,) + FRAME, dtype=torch.uint8,
                            generator=gen, device=device)
        chin = torch.randint(pool["chin_rows"][0], pool["chin_rows"][1],
                             (t,), generator=gen, device=device)
        planar = s2d_repack_torch(raw, chin).cpu().numpy()
        clips.append({"frames": planar, "fname": f"clip{i:02d}_t{t}"})
    if pool.get("content", True):
        rng = np.random.default_rng(derive_seed(seed, 22))
        per_frame = pool["sample_rate"] // pool["fps"]
        wavs = (torch.randn(sum(ts) * per_frame, generator=gen,
                            device=device) * pool["wav_scale"]).cpu().numpy()
        at = 0
        for c, t, n in zip(clips, ts, word_counts(mix)):
            c["wav"] = wavs[at:at + t * per_frame]
            at += t * per_frame
            letters = np.array(list(string.ascii_lowercase))
            words = ["".join(rng.choice(letters, k))
                     for k in word_lengths(n, pool["word_letters"])]
            edges = np.floor(np.linspace(0, t, n + 1)).astype(int)
            c["text"] = " ".join(words)
            c["word_boundaries"] = [[w, int(edges[k]), int(edges[k + 1]) - 1]
                                    for k, w in enumerate(words)]
    return clips


def call_order(mix: dict, seed: int, k: int) -> list[int]:
    """Pool indices of call k: the pool repeated clips_per_call / clips
    times, in an order drawn from (seed, k)."""
    n = mix["pool"]["clips"]
    idx = np.tile(np.arange(n), mix["clips_per_call"] // n)
    rng = np.random.default_rng([int(seed), 23, int(k)])
    return [int(i) for i in rng.permutation(idx)]

