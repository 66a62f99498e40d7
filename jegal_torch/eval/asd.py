"""Gesture-only active speaker detection evaluation (AVS-Asd; the JAX
package's eval/asd.py).

The reference's evaluation/evaluate_asd.py:26-124: for each query, its
mean-pooled content embedding scores the positive and the negative
speakers' mean-pooled gesture embeddings by a cosine / 0.07 softmax; the
accuracy at n speakers is whether the argmax over the first n candidates
is the positive (index 0), for n in config.ASD_SPEAKERS.

`df` is the AVS-Asd table: any object whose `iterrows()` yields (index,
row) with row["filename"] and row["neg_files"] (a stringified list), such
as a pandas frame. `evaluate_device` scores every query at once with torch
on a device (the card unless `device="cpu"`); the softmax is monotone, so
it takes the argmax of the masked cosines. File IO and the mean pooling
stay on the host in both paths.
"""

from __future__ import annotations

import ast
import os

import numpy as np
import torch

from jegal_torch.config import ASD_SPEAKERS
from jegal_torch.eval.common import TEMP, load_pkl, softmax


def _emb_path(res_dir: str, filename: str) -> str:
    parts = filename.split("/")
    return os.path.join(res_dir, parts[0] + "__" + parts[1] + ".pkl")


def _mean_embs(path: str, load_content: bool):
    feats = load_pkl(path)
    g = np.asarray(feats["gesture_emb"]).mean(axis=0)
    if load_content:
        return g, np.asarray(feats["content_emb"]).mean(axis=0)
    return g


def cosine_scores(query: np.ndarray, candidates: np.ndarray,
                  temp: float = TEMP) -> np.ndarray:
    """The softmax over candidates of cosine(query, cand) / temp (reference
    evaluate_asd.py:43-51; torch CosineSimilarity's eps 1e-8)."""
    qn = np.linalg.norm(query)
    cn = np.linalg.norm(candidates, axis=1)
    cos = (candidates @ query) / np.maximum(qn * cn, 1e-8)
    return softmax(cos / temp, axis=0)


def _queries(res_dir: str, df):
    """(query content, [query gesture, negative gestures...]) for each row
    whose query file exists; a missing negative file is skipped."""
    for _, row in df.iterrows():
        qpath = _emb_path(res_dir, row["filename"])
        if not os.path.exists(qpath):
            continue
        q_gest, q_content = _mean_embs(qpath, load_content=True)
        gestures = [q_gest]
        for neg in ast.literal_eval(row["neg_files"]):
            npath = _emb_path(res_dir, neg)
            if os.path.exists(npath):
                gestures.append(_mean_embs(npath, load_content=False))
        yield q_content, gestures


def evaluate(res_dir: str, df) -> dict:
    counts = {n: [0, 0] for n in ASD_SPEAKERS}     # n -> [correct, total]
    evaluated = 0
    for q_content, gestures in _queries(res_dir, df):
        cands_all = np.stack(gestures)
        evaluated += 1
        for n_spk in ASD_SPEAKERS:
            pred = int(np.argmax(cosine_scores(q_content,
                                               cands_all[:n_spk])))
            counts[n_spk][0] += int(pred == 0)
            counts[n_spk][1] += 1
    out = {"evaluated": evaluated}
    for n_spk, (c, t) in counts.items():
        out[f"acc_{n_spk}spk"] = c / t if t else 0.0
    return out


# ---------------------------------------------------------------------------
# On a device
# ---------------------------------------------------------------------------

def _asd_batch_device(query, cands, cand_count, speakers):
    """query (N, D), cands (N, S, D), cand_count (N,) valid candidates ->
    {n_spk: pred (N,)}, the argmax over the first min(n_spk, count)
    candidates."""
    qn = torch.linalg.norm(query, dim=1)
    cn = torch.linalg.norm(cands, dim=2)
    cos = (torch.einsum("nsd,nd->ns", cands, query)
           / (qn[:, None] * cn).clamp_min(1e-8))
    s = torch.arange(cos.shape[1], device=cos.device)[None, :]
    return {n_spk: cos.masked_fill(
                s >= cand_count.clamp_max(n_spk)[:, None],
                float("-inf")).argmax(dim=1)
            for n_spk in speakers}


def evaluate_device(res_dir: str, df, device="cuda", mesh=None) -> dict:
    """`evaluate`, with every query's scoring in one batch on `device`.
    mesh: a collective call: the queries pad to a multiple of the 'data'
    size (as the JAX package pads them), each rank scores its rows, and
    the predictions are gathered over 'data', so that every rank reduces
    them to the same rates."""
    from jegal_torch.api import resolve_device
    from jegal_torch.parallel import mesh as M

    dev = resolve_device(device)
    queries, cand_sets = [], []
    for q_content, gestures in _queries(res_dir, df):
        queries.append(q_content)
        cand_sets.append(gestures)
    evaluated = len(queries)
    out = {"evaluated": evaluated}
    if not evaluated:
        out.update({f"acc_{n_spk}spk": 0.0 for n_spk in ASD_SPEAKERS})
        return out
    d = queries[0].shape[0]
    s_max = max(max(len(c) for c in cand_sets), max(ASD_SPEAKERS))
    n_pad = M.round_to_data(evaluated, mesh)
    q = np.zeros((n_pad, d), np.float32)
    cands = np.zeros((n_pad, s_max, d), np.float32)
    count = np.ones((n_pad,), np.int64)     # a pad row: one dummy candidate
    for i, (qc, cs) in enumerate(zip(queries, cand_sets)):
        q[i] = qc
        cands[i, :len(cs)] = np.stack(cs)
        count[i] = len(cs)
    preds = _asd_batch_device(*M.put_batch((q, cands, count), mesh, dev),
                              ASD_SPEAKERS)
    for n_spk in ASD_SPEAKERS:
        pred = M.gather_rows(preds[n_spk], mesh)[:evaluated]
        out[f"acc_{n_spk}spk"] = float((pred.cpu().numpy() == 0).mean())
    return out
