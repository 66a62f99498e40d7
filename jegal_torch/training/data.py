"""Training data pipeline: random word-window crops -> padded batches (the
JAX package's training/data.py:38-182, reference dataset.py:15-195 with its
use-before-assignment defect fixed: text first, then the visual and audio
windows it determines).

  * num_words ~ U[5, min(len(words), U[10, 19])] consecutive words;
  * window = [first word's start, last word's end] in 25 fps frames;
  * visual features cropped to the window, audio to the same span at 640
    samples a frame, then log-mel;
  * word boundaries kept in absolute frames (pooling subtracts the first
    word's start).

`sample_word_window` draws from the numpy Generator in the JAX package's
order, so one seed gives both packages the same windows. Batches are padded
to the shape buckets with neutral masks and pooling rows, and returned as
CPU tensors; the training loop moves them to the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jegal_torch.config import HOP_LENGTH, SAMPLE_RATE
from jegal_torch.data.bucketing import (
    MEL_BUCKETS,
    S_BUCKETS,
    T_BUCKETS,
    W_BUCKETS,
    next_bucket,
    pad_axis,
)
from jegal_torch.ops import pooling as P
from jegal_torch.ops.audio import load_wav, wav2filterbanks_np
from jegal_torch.text.normalize import preprocess_text

FPS = 25


def sample_word_window(rows: list[str], rng: np.random.Generator):
    """rows: transcript 'WORD, START, END, SCORE' lines -> (text,
    start_frame, end_frame, word_boundaries), or None for fewer than 5
    words or no word left after normalization."""
    if len(rows) < 5:
        return None
    max_words = rng.integers(10, 20)
    num_words = rng.integers(5, min(len(rows), max_words) + 1)
    start_idx = rng.integers(0, len(rows) - num_words + 1)

    start_time = float(rows[start_idx].split(", ")[1])
    end_time = float(rows[start_idx + num_words - 1].split(", ")[2])
    start_frame = round(start_time * FPS)
    end_frame = round(end_time * FPS)

    text = ""
    word_boundaries = []
    for i in range(start_idx, start_idx + num_words):
        parts = rows[i].split(", ")
        word = preprocess_text(parts[0])
        if word == "":
            continue
        text += word
        if i != start_idx + num_words - 1:
            text += " "
        word_boundaries.append([
            word, round(float(parts[1]) * FPS), round(float(parts[2]) * FPS)])
    if not word_boundaries:
        return None
    return text, start_frame, end_frame, word_boundaries


def load_training_sample(row, feature_dir: str, rng: np.random.Generator):
    """One CSV row (filename, text_path, audio_path) -> a raw sample dict,
    or None for a missing or unusable clip (dropped, as the reference
    drops None samples)."""
    text_path, audio_path = row["text_path"], row["audio_path"]
    if not os.path.exists(text_path) or not os.path.exists(audio_path):
        return None
    with open(text_path, "r", encoding="utf-8") as f:
        rows = [line.strip() for line in f.readlines()][4:]
    window = sample_word_window(rows, rng)
    if window is None:
        return None
    text, start_frame, end_frame, wbs = window

    feats_path = os.path.join(feature_dir, row["filename"] + ".npy")
    try:
        feats = np.load(feats_path)
    except (OSError, ValueError, EOFError):
        return None
    if feats.ndim != 2 or feats.shape[1] != 1024:
        return None
    feats = feats[start_frame:end_frame + 1]
    if len(feats) == 0:
        return None

    wav = load_wav(audio_path)
    aud_fact = int(round(SAMPLE_RATE / FPS))
    wav = wav[aud_fact * start_frame:aud_fact * (end_frame + 1)]
    if len(wav) < HOP_LENGTH * 4:
        return None
    return {
        "visual_feats": feats.astype(np.float32),
        "text": text,
        "wav": wav,
        "word_boundaries": wbs,
    }


def collate_training_batch(samples: list[dict], tokenizer):
    """Raw samples -> the padded batch dict of trainer.train_step (CPU
    tensors), or None when no sample survives the validity checks.
    tokenizer: a jegal_torch.text.WordTokenizer."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None

    # text: the whole batch tokenized together (HF-parity padding)
    batch = tokenizer.encode_words([s["text"] for s in samples])
    s_nat = batch.input_ids.shape[1]
    starts = P.text_word_starts(batch.input_ids, batch.offsets,
                                batch.special_ids)
    n_words = [len(s["word_boundaries"]) for s in samples]
    w_bucket = next_bucket(max(n_words), W_BUCKETS)
    text_pool, tvalid, counts = P.build_text_pooling(
        starts, n_words, s_nat, w_bucket)

    # audio: a mel per sample; its pooling is built against the sample's
    # NATURAL token count ((t_mel-1)//4+1, the CNN's output length), then
    # padded to the shared bucket, so no span indexes conv-on-padding tokens
    mels = [wav2filterbanks_np(s["wav"])[0] for s in samples]
    mel_bucket = next_bucket(max(m.shape[0] for m in mels), MEL_BUCKETS)
    pools, avalid_l = [], []
    for s, m in zip(samples, mels):
        t_audio = (m.shape[0] - 1) // 4 + 1
        p, v, _ = P.build_audio_pooling([s["word_boundaries"]], t_audio,
                                        w_bucket)
        pools.append(pad_axis(p, 2, mel_bucket // 4)[0])
        avalid_l.append(v[0])
    audio_pool = np.stack(pools)
    avalid = np.asarray(avalid_l)
    audio_valid = np.array([m.shape[0] for m in mels], np.int64)

    valid = tvalid & avalid
    keep = [i for i in range(len(samples)) if valid[i]]
    if not keep:
        return None

    t_bucket = next_bucket(max(len(samples[i]["visual_feats"]) for i in keep),
                           T_BUCKETS)
    s_bucket = next_bucket(s_nat, S_BUCKETS)

    def stack(make):
        return np.stack([make(i) for i in keep])

    feats = stack(lambda i: pad_axis(samples[i]["visual_feats"], 0, t_bucket))
    vmask = stack(lambda i: np.pad(
        np.ones(len(samples[i]["visual_feats"]), np.float32),
        (0, t_bucket - len(samples[i]["visual_feats"]))))
    mel = stack(lambda i: pad_axis(mels[i], 0, mel_bucket))
    ids = pad_axis(batch.input_ids[keep], 1, s_bucket,
                   value=tokenizer.pad_id)
    tmask = pad_axis(batch.attention_mask[keep], 1, s_bucket)
    tpool = pad_axis(text_pool[keep], 2, s_bucket)
    wmask = stack(lambda i: np.pad(
        np.ones(counts[i], np.float32), (0, w_bucket - counts[i])))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return {
        "visual_feats": f32(feats),
        "visual_mask": f32(vmask),
        "input_ids": torch.from_numpy(np.asarray(ids, np.int64)),
        "text_mask": f32(tmask),
        "text_pool": f32(tpool),
        "audio_mel": f32(mel),
        "audio_pool": f32(audio_pool[keep]),
        "audio_valid": torch.from_numpy(audio_valid[keep]),
        "word_mask": f32(wmask),
    }
