"""Gestured-word spotting evaluation (AVS-Spot; the JAX package's
eval/spotting.py).

The reference's evaluation/evaluate_spotting.py:39-90: per video the
word-frame attention softmax((G C^T) / 0.07) over words, transposed to
(W, T); the prediction is the argmax frame of the target word's row, a hit
iff it lies within the true span +/- frame_threshold (clamped at 0) and
its score reaches the threshold.

`evaluate_device` batches the attention and the argmax over the whole set
with torch on a device (the card unless `device="cpu"`). Videos pad to a
common (T, W) per group: padded words take -inf logits (probability 0, so
the softmax over the valid words is unchanged) and padded frames -inf
scores. The span and threshold checks stay on the host. Equal to the numpy
path whenever the target row has no tie.
"""

from __future__ import annotations

import numpy as np
import torch

from jegal_torch.config import SPOT_FRAME_THRESHOLD, SPOT_THRESHOLD
from jegal_torch.eval.common import (
    TEMP,
    attention_matrix,
    list_embedding_files,
    load_pkl,
    parse_word_boundaries,
)


def spot_word(gesture_emb, content_emb, word_boundaries, target_word_boundary,
              thresh: float = SPOT_THRESHOLD, frame_thresh: int = SPOT_FRAME_THRESHOLD):
    """-> (correct: bool, pred_frame: int, pred_score: float)."""
    wbs = parse_word_boundaries(word_boundaries)
    target = parse_word_boundaries(target_word_boundary)
    attn = attention_matrix(np.asarray(gesture_emb), np.asarray(content_emb))
    row = attn[wbs.index(target)]
    pred_idx = int(np.argmax(row))
    pred_score = float(row[pred_idx])
    return _hit(target, pred_idx, pred_score, thresh, frame_thresh), \
        pred_idx, pred_score


def _hit(target, pred: int, score: float, thresh: float,
         frame_thresh: int) -> bool:
    start = max(0, int(target[1]) - frame_thresh)
    end = int(target[2]) + frame_thresh
    return start <= pred <= end and score >= thresh


def evaluate(path: str, thresh: float = SPOT_THRESHOLD,
             frame_thresh: int = SPOT_FRAME_THRESHOLD) -> dict:
    """Each .pkl's info carries 'word_boundaries' and
    'target_word_boundary' (the AVS-Spot CSV columns)."""
    correct = total = 0
    for fname in list_embedding_files(path):
        feats = load_pkl(fname)
        info = feats["info"]
        ok, _, _ = spot_word(feats["gesture_emb"], feats["content_emb"],
                             info["word_boundaries"],
                             info["target_word_boundary"], thresh,
                             frame_thresh)
        correct += int(ok)
        total += 1
    return {"accuracy": 100.0 * correct / max(total, 1),
            "correct": correct, "total": total}


# ---------------------------------------------------------------------------
# On a device
# ---------------------------------------------------------------------------

# Budget of one group's padded (m, t_max, d) float32 gesture tensor (~256
# MB): one long outlier must not inflate the whole set's padding. Module
# level so that tests can shrink it to force several groups.
MAX_GROUP_ELEMS = 1 << 26


def _spot_batch_device(gesture, content, t_valid, w_valid, word_idx,
                       temp: float):
    """gesture (N, T, D), content (N, W, D) float32; valid counts (N,);
    word_idx (N,) the target word's row -> (pred_frame (N,), pred_score
    (N,))."""
    def norm(x):
        return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)

    logits = torch.einsum("ntd,nwd->ntw", norm(gesture), norm(content)) / temp
    n, t, w = logits.shape
    wmask = torch.arange(w, device=logits.device)[None, :] < w_valid[:, None]
    logits = logits.masked_fill(~wmask[:, None, :], float("-inf"))
    attn = torch.softmax(logits, dim=2)               # over words, per frame
    row = attn.gather(2, word_idx[:, None, None].expand(n, t, 1))[..., 0]
    tmask = torch.arange(t, device=row.device)[None, :] < t_valid[:, None]
    row = row.masked_fill(~tmask, float("-inf"))
    return row.argmax(dim=1), row.amax(dim=1)


def predict_device(path: str, device="cuda", mesh=None) -> list:
    """Each .pkl's (target word boundary, pred_frame, pred_score), in
    `list_embedding_files` order, with the attention and argmax batched on
    `device`: `spot_word`'s prediction for every video at once. mesh: a
    collective call: each group's videos pad to a multiple of the 'data'
    size (as the JAX package pads them), each rank computes its rows and
    the predictions are gathered over 'data', on every rank."""
    from jegal_torch.api import resolve_device
    from jegal_torch.parallel import mesh as M

    dev = resolve_device(device)
    videos = []
    for fname in list_embedding_files(path):
        feats = load_pkl(fname)
        info = feats["info"]
        wbs = parse_word_boundaries(info["word_boundaries"])
        target = parse_word_boundaries(info["target_word_boundary"])
        videos.append((np.asarray(feats["gesture_emb"], np.float32),
                       np.asarray(feats["content_emb"], np.float32),
                       wbs.index(target), target))
    if not videos:
        return []
    n = len(videos)
    d = videos[0][0].shape[1]

    # groups of videos sorted by length under a padded-tensor budget: one
    # long outlier pads only its own group
    order = sorted(range(n), key=lambda i: videos[i][0].shape[0])
    groups: list[list[int]] = []
    cur: list[int] = []
    for i in order:
        if cur and ((len(cur) + 1) * videos[i][0].shape[0] * d
                    > MAX_GROUP_ELEMS or len(cur) >= 512):
            groups.append(cur)
            cur = []
        cur.append(i)
    if cur:
        groups.append(cur)

    pred = np.zeros((n,), np.int64)
    score = np.zeros((n,), np.float64)
    for idxs in groups:
        m = len(idxs)
        m_pad = M.round_to_data(m, mesh)
        t_max = max(videos[i][0].shape[0] for i in idxs)
        w_max = max(videos[i][1].shape[0] for i in idxs)
        gest = np.zeros((m_pad, t_max, d), np.float32)
        cont = np.zeros((m_pad, w_max, d), np.float32)
        t_valid = np.ones((m_pad,), np.int64)   # a pad row: one dummy each
        w_valid = np.ones((m_pad,), np.int64)
        word_idx = np.zeros((m_pad,), np.int64)
        for bi, i in enumerate(idxs):
            g, c, wi, _ = videos[i]
            gest[bi, :g.shape[0]] = g
            cont[bi, :c.shape[0]] = c
            t_valid[bi], w_valid[bi], word_idx[bi] = g.shape[0], c.shape[0], wi
        p, s = (M.gather_rows(x, mesh) for x in _spot_batch_device(
            *M.put_batch((gest, cont, t_valid, w_valid, word_idx), mesh, dev),
            TEMP))
        pred[idxs], score[idxs] = p[:m].cpu().numpy(), s[:m].cpu().numpy()
    return [(target, int(pred[i]), float(score[i]))
            for i, (_, _, _, target) in enumerate(videos)]


def evaluate_device(path: str, thresh: float = SPOT_THRESHOLD,
                    frame_thresh: int = SPOT_FRAME_THRESHOLD,
                    device="cuda", mesh=None) -> dict:
    """`evaluate`, with the predictions from `predict_device` (a collective
    call with a mesh)."""
    preds = predict_device(path, device, mesh)
    if not preds:
        return {"accuracy": 0.0, "correct": 0, "total": 0}
    correct = sum(int(_hit(target, pred, score, thresh, frame_thresh))
                  for target, pred, score in preds)
    return {"accuracy": 100.0 * correct / len(preds), "correct": correct,
            "total": len(preds)}
