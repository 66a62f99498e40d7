"""Transformer encoder stacks (jegal_tpu/core/transformer.py).

  * `encoder_stack`: the reference JEGAL encoder (models/modules.py:11-131),
    PRE-norm sublayers with the reference LayerNorm plus a final one.
  * `torch_encoder_stack`: torch nn.TransformerEncoderLayer (post-norm,
    ReLU, std LayerNorm eps 1e-5), the GestSync window transformer.

Masked scores are FILLED with -1e9 in float32 before the softmax
(reference models/modules.py:61-75).

On a CUDA tensor both stacks run through the fused sublayer kernels
(ops/kernels/fused_layer.py), as the JAX package picks its Pallas kernels
per backend (jax.lax.platform_dependent at transformer.py:237 and
gestsync.py:351-355); on a CPU tensor they run the plain layer loop below.

Parameter trees (JAX layout):
  mha:   {"q": linear, "k": linear, "v": linear, "o": linear}
  ffn:   {"w1": linear, "w2": linear}
  layer: {"attn": mha, "ff": ffn, "norm1": ln, "norm2": ln}
  stack: {"layers": [layer...], "norm": ln}   ("norm" only for pre-norm)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jegal_torch.core.layers import linear, ref_layer_norm, std_layer_norm
from jegal_torch.ops.kernels import fused_layer as FL


def sinusoidal_position_encoding(max_len: int, d_model: int,
                                 device=None) -> torch.Tensor:
    """(max_len, d_model) sin/cos table, built in float32 with numpy so it
    is bit-equal to the JAX package's table (transformer.py:47-61)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32)
        * np.float32(-(math.log(10000.0) / d_model))).astype(np.float32)
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe).to(device)


def _split_heads(x, h: int):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)  # (B, h, T, dk)


def _merge_heads(x):
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def masked_attention_weights(scores, mask):
    """Softmax in float32 with masked (== 0) entries filled with -1e9.
    scores: (B, h, Tq, Tk); mask broadcastable to it."""
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -1e9)
    return torch.softmax(scores, dim=-1)


def multi_head_attention(params, q_in, k_in, v_in, mask, num_heads: int):
    """Dense MHA (reference models/modules.py:88-120). mask: None or
    broadcastable to (B, 1, Tq, Tk) after a head-axis unsqueeze — pass
    (B, 1, Tk) or (B, Tq, Tk)."""
    q = _split_heads(linear(params["q"], q_in), num_heads)
    k = _split_heads(linear(params["k"], k_in), num_heads)
    v = _split_heads(linear(params["v"], v_in), num_heads)
    d_k = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d_k)
    m = mask
    if m is not None:
        while m.dim() < 4:
            m = m.unsqueeze(1)
    p = masked_attention_weights(scores, m).to(q.dtype)
    return linear(params["o"], _merge_heads(torch.matmul(p, v)))


def _ffn(params, x):
    return linear(params["w2"], torch.relu(linear(params["w1"], x)))


def _key_mask(mask, b: int, t: int):
    """A mask reduced to (B*T,) key validity, or None for no mask. A mask
    that is not a pure key mask has no fused form and raises."""
    if mask is None:
        return None
    if mask.numel() != b * t:
        raise ValueError(
            f"the fused encoder takes a key-validity mask of {b}x{t} "
            f"entries, got shape {tuple(mask.shape)}")
    return mask.reshape(-1)


def encoder_layer(params, x, mask, num_heads: int):
    h = ref_layer_norm(params["norm1"], x)
    x = x + multi_head_attention(params["attn"], h, h, h, mask, num_heads)
    h = ref_layer_norm(params["norm2"], x)
    return x + _ffn(params["ff"], h)


def encoder_stack(params, x, mask, num_heads: int):
    """N pre-norm layers + the final reference LayerNorm. x: (B, T, d)."""
    if x.is_cuda:
        b, t, d = x.shape
        km = _key_mask(mask, b, t)
        out = FL.fused_prenorm_stack(params, x.reshape(b * t, d), t,
                                     num_heads, kmask=km)
        return ref_layer_norm(params["norm"], out.reshape(b, t, d))
    for layer in params["layers"]:
        x = encoder_layer(layer, x, mask, num_heads)
    return ref_layer_norm(params["norm"], x)


def torch_encoder_layer(params, x, mask, num_heads: int):
    x = std_layer_norm(
        params["norm1"],
        x + multi_head_attention(params["attn"], x, x, x, mask, num_heads))
    return std_layer_norm(params["norm2"], x + _ffn(params["ff"], x))


def torch_encoder_stack(params, x, mask, num_heads: int):
    """Post-norm stack over x: (B, T, d)."""
    if x.is_cuda:
        b, t, d = x.shape
        km = _key_mask(mask, b, t)
        out = FL.fused_torch_stack(params, x.reshape(b * t, d), t,
                                   num_heads, kmask=km)
        return out.reshape(b, t, d)
    for layer in params["layers"]:
        x = torch_encoder_layer(layer, x, mask, num_heads)
    return x
