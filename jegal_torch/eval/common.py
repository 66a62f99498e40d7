"""Shared evaluation utilities (the JAX package's eval/common.py): .pkl
loading and the gesture-content attention, in numpy."""

from __future__ import annotations

import ast
import glob
import os
import pickle

import numpy as np

from jegal_torch.config import TEMPERATURE as TEMP


def load_pkl(path: str) -> dict:
    """An embedding file the engine wrote (`extract_to_pkl`)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def list_embedding_files(path: str) -> list[str]:
    return sorted(glob.glob(os.path.join(path, "*.pkl")))


def l2_normalize(x: np.ndarray, axis: int = -1,
                 eps: float = 1e-12) -> np.ndarray:
    """torch F.normalize(p=2): x / max(||x||, eps)."""
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, eps)


def softmax(x: np.ndarray, axis: int) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def parse_word_boundaries(wb):
    """CSV cells store word boundaries as stringified lists."""
    if isinstance(wb, str):
        return ast.literal_eval(wb)
    return wb


def attention_matrix(gesture_emb: np.ndarray, content_emb: np.ndarray,
                     temp: float = TEMP) -> np.ndarray:
    """softmax((G @ C^T) / temp) over words, transposed to (W, T)
    (reference evaluate_spotting.py:39-57 / plot_heatmap.py:34-59)."""
    g = l2_normalize(gesture_emb.astype(np.float32))
    c = l2_normalize(content_emb.astype(np.float32))
    return softmax(g @ c.T / temp, axis=1).T
