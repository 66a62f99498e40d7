"""Word-frame attention heatmaps (the JAX package's eval/heatmap.py): the
reference's utils/plot_heatmap.py:34-107, a thresholded jet overlay of the
(W, T) attention matrix with word labels, without cv2 (its addWeighted is
a plain alpha blend). matplotlib is imported by `render` alone."""

from __future__ import annotations

import numpy as np

from jegal_torch.config import HEATMAP_ALPHA, HEATMAP_THRESHOLD
from jegal_torch.eval.common import (
    attention_matrix,
    load_pkl,
    parse_word_boundaries,
)


def render(attn: np.ndarray, words: list[str], fname: str = "heatmap",
           thresh: float = HEATMAP_THRESHOLD, alpha: float = HEATMAP_ALPHA,
           cmap: str = "jet") -> str:
    """(W, T) attention -> <fname>.png; returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    fig, ax = plt.subplots(1, 1, figsize=(16, 20))
    cmap_fn = plt.colormaps.get_cmap(cmap)
    rgba = cmap_fn(attn.copy())
    attn_thresh = attn.copy()
    attn_thresh[attn_thresh < thresh] = 0.01
    thresh_rgba = cmap_fn(attn_thresh)
    thresh_rgba[..., 3] = (attn_thresh > 0).astype(float) * alpha
    merged = np.clip(alpha * thresh_rgba + (1 - alpha) * rgba, 0.0, 1.0)

    im = ax.imshow(merged, cmap=cmap)
    ax.set_yticks(list(range(len(words))))
    ax.set_yticklabels(words, fontsize=14)
    ax.xaxis.set_tick_params(labelsize=14)
    ax.set_aspect("equal")
    cax = make_axes_locatable(ax).append_axes("right", size="2%", pad=0.2)
    cbar = fig.colorbar(im, cax=cax, orientation="vertical")
    cbar.ax.tick_params(labelsize=20)
    fig.tight_layout()
    out = fname + ".png"
    fig.savefig(out, dpi=fig.dpi)
    plt.close(fig)
    return out


def plot_from_pkl(path: str, fname: str = "heatmap") -> str:
    """The heatmap of one embedding file (its info's word boundaries
    label the rows)."""
    feats = load_pkl(path)
    words = [w[0] for w in parse_word_boundaries(
        feats["info"]["word_boundaries"])]
    attn = attention_matrix(np.asarray(feats["gesture_emb"]),
                            np.asarray(feats["content_emb"]))
    return render(attn, words, fname=fname)
