"""Cross-modal retrieval evaluation (AVS-Ret; the JAX package's
eval/retrieval.py).

The reference's rank-of-diagonal metrics over the cosine-similarity matrix
of temporally mean-pooled embeddings (evaluation/evaluate_retrieval.py:
18-110), returned as metric dicts, with R@1 beside R@{5,10,25,50} (the
reference script crashes at its unpack, :87-89). The numpy path follows
the reference's sort; `compute_metrics_device` / `evaluate_device` compute
the similarity matrix and the ranks with torch on a device (the card
unless `device="cpu"`). Without ties in the similarities both give the
same ranks (the reference's sort emits several indices for a tied row).
"""

from __future__ import annotations

import numpy as np
import torch

from jegal_torch.eval.common import (
    l2_normalize,
    list_embedding_files,
    load_pkl,
)


def load_video_level_embeddings(path: str):
    """The mean over time / words -> video-level gesture and content
    embeddings (reference evaluate_retrieval.py:25-35)."""
    gesture, content, infos = [], [], []
    for fname in list_embedding_files(path):
        feats = load_pkl(fname)
        gesture.append(np.asarray(feats["gesture_emb"]).mean(axis=0)
                       .squeeze())
        content.append(np.asarray(feats["content_emb"]).mean(axis=0)
                       .squeeze())
        infos.append(feats["info"])
    return np.stack(gesture), np.stack(content), infos


def similarity_matrix(emb1: np.ndarray, emb2: np.ndarray) -> np.ndarray:
    e1 = l2_normalize(emb1.astype(np.float32), axis=1)
    e2 = l2_normalize(emb2.astype(np.float32), axis=1)
    return e1 @ e2.T


def rank_of_diagonal(sim: np.ndarray) -> np.ndarray:
    """The 0-based rank of each diagonal entry within its row, by the
    reference's sort (evaluate_retrieval.py:51-57, ties as it treats
    them)."""
    sx = np.sort(-sim, axis=1)
    d = -np.diag(sim)[:, None]
    return np.where(sx - d == 0)[1]


def compute_metrics(sim: np.ndarray) -> dict:
    ind = rank_of_diagonal(sim)
    n = len(ind)
    return {
        "R1": float(np.sum(ind < 1)) / n,
        "R5": float(np.sum(ind < 5)) / n,
        "R10": float(np.sum(ind < 10)) / n,
        "R25": float(np.sum(ind < 25)) / n,
        "R50": float(np.sum(ind < 50)) / n,
        "MR": float(np.median(ind) + 1),
    }


def evaluate(path: str) -> dict:
    """-> {"c2g": metrics, "g2c": metrics} (content -> gesture, gesture ->
    content, reference evaluate_retrieval.py:100-110)."""
    gesture, content, _ = load_video_level_embeddings(path)
    return {
        "c2g": compute_metrics(similarity_matrix(content, gesture)),
        "g2c": compute_metrics(similarity_matrix(gesture, content)),
    }


# ---------------------------------------------------------------------------
# On a device
# ---------------------------------------------------------------------------

def _metrics_on_device(emb_q, emb_k, valid, offset: int = 0,
                       mesh=None) -> dict:
    """emb_q: (n, D) float32 query rows offset .. offset + n of the N (all
    of them without a mesh), emb_k: (N, D); valid: (N,) 1 for a real row,
    0 for a pad row. rank_i = #{valid j : sim[i, j] > sim[i, i]}, the
    0-based rank of the diagonal (the numpy sort's without ties); under a
    mesh each rank ranks its query rows and the ranks are gathered over
    'data', so that every rank reduces every row's rank to the same
    metrics (the median needs them all)."""
    from jegal_torch.parallel import mesh as M

    def norm(x):
        return x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)

    sim = norm(emb_q) @ norm(emb_k).T
    # the diagonal from the same product values the ranks compare against
    rows = torch.arange(sim.shape[0], device=sim.device)
    diag = sim[rows, rows + offset]
    beats = (sim > diag[:, None]) & (valid[None, :] == 1.0)
    ranks = M.gather_rows(beats.sum(dim=1).to(torch.float32), mesh)
    rowmask = valid == 1.0
    n = valid.sum()

    def recall(k):
        hit = (ranks < k).to(torch.float32)
        return torch.where(rowmask, hit, torch.zeros_like(hit)).sum() / n

    # the median over valid rows (np.median: the mean of the two middles)
    s = torch.sort(torch.where(rowmask, ranks,
                               torch.full_like(ranks, float("inf")))).values
    ni = n.to(torch.int64)
    lo, hi = s[(ni - 1) // 2], s[ni // 2]
    return {"R1": recall(1), "R5": recall(5), "R10": recall(10),
            "R25": recall(25), "R50": recall(50),
            "MR": (lo + hi) / 2.0 + 1.0}


def compute_metrics_device(emb_q: np.ndarray, emb_k: np.ndarray,
                           device="cuda", mesh=None) -> dict:
    """`compute_metrics(similarity_matrix(emb_q, emb_k))` with the (N, N)
    similarity and the ranks on `device`. mesh: a collective call (every
    rank with the same embeddings): the query rows pad to a multiple of
    the 'data' size (as the JAX package pads them), each rank takes its
    rows of them against every key, and every rank returns the metrics."""
    from jegal_torch.api import resolve_device
    from jegal_torch.parallel import mesh as M

    dev = resolve_device(device)
    n = emb_q.shape[0]
    n_pad = M.round_to_data(n, mesh)
    q = np.zeros((n_pad, emb_q.shape[1]), np.float32)
    k = np.zeros((n_pad, emb_k.shape[1]), np.float32)
    q[:n], k[:n] = emb_q, emb_k
    valid = np.zeros((n_pad,), np.float32)
    valid[:n] = 1.0
    rows = M.batch_rows(n_pad, mesh)
    return {name: float(v) for name, v in _metrics_on_device(
        *(torch.from_numpy(a).to(dev) for a in (q[rows], k, valid)),
        rows.start, mesh).items()}


def evaluate_device(path: str, device="cuda", mesh=None) -> dict:
    """`evaluate`, with the O(N^2) similarity and rank math on `device`
    (over the mesh's 'data' ranks with a mesh: a collective call)."""
    gesture, content, _ = load_video_level_embeddings(path)
    return {
        "c2g": compute_metrics_device(content, gesture, device, mesh),
        "g2c": compute_metrics_device(gesture, content, device, mesh),
    }
