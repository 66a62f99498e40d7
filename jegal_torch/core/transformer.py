"""Transformer encoder stacks (jegal_tpu/core/transformer.py).

  * `encoder_stack`: the reference JEGAL encoder (models/modules.py:11-131),
    PRE-norm sublayers with the reference LayerNorm plus a final one.
  * `torch_encoder_stack`: torch nn.TransformerEncoderLayer (post-norm,
    ReLU, std LayerNorm eps 1e-5), the GestSync window transformer.

Masked scores are FILLED with -1e9 in float32 before the softmax
(reference models/modules.py:61-75).

On a CUDA tensor the stacks run through the fused sublayer kernels
(ops/kernels/fused_layer.py), as the JAX package picks its Pallas kernels
per backend (jax.lax.platform_dependent at transformer.py:237 and
gestsync.py:351-355); on a CPU tensor they run the plain layer loop below.
The pre-norm `encoder_stack` takes the fused kernels only where the JAX
package does (`fused=True` and `fused_layer.fused_stack_ok`); otherwise it
runs the layer loop, whose self-attention is the flash attention kernel on
a CUDA tensor (ops/kernels/flash_attention.py). Training passes
fused=False: the fused kernels have no backward, the flash attention has
one. On a CUDA tensor nothing runs the plain attention: an input that no
kernel takes (a mask that is not a key mask, a shape `_flash_ok` refuses)
raises.

Parameter trees (JAX layout):
  mha:   {"q": linear, "k": linear, "v": linear, "o": linear}
  ffn:   {"w1": linear, "w2": linear}
  layer: {"attn": mha, "ff": ffn, "norm1": ln, "norm2": ln}
  stack: {"layers": [layer...], "norm": ln}   ("norm" only for pre-norm)
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from jegal_torch.core.layers import linear, ref_layer_norm, std_layer_norm
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as FL


def sinusoidal_position_encoding(max_len: int, d_model: int,
                                 device=None) -> torch.Tensor:
    """(max_len, d_model) sin/cos table, built in float32 with numpy so it
    is bit-equal to the JAX package's table (transformer.py:47-61). The
    table is built and copied to `device` once and then shared (callers
    only read it): a forward captured into a CUDA graph may not copy from
    the host, and the eager run before each capture fills this cache."""
    return _pe_table(max_len, d_model, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=16)
def _pe_table(max_len: int, d_model: int, device: torch.device):
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32)
        * np.float32(-(math.log(10000.0) / d_model))).astype(np.float32)
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    with torch.inference_mode(False):     # a normal tensor, for training too
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


def _on_card(t) -> bool:
    """Whether `t` lies on the card: the one device test of the routing in
    this module, kept in one place so that the CPU tests can drive the
    card's routing with the kernels' plain twins."""
    return t.is_cuda


def _key_mask(mask, b: int, t: int):
    """A mask reduced to (B, T) key validity, or None for no mask. A mask
    that is not a pure key mask (a genuinely 2-D (Tq, Tk) one) has no
    kernel form and raises: only the card's routing calls this."""
    if mask is None:
        return None
    if mask.numel() != b * t:
        raise ValueError(
            f"the encoder kernels take a key-validity mask of {b}x{t} "
            f"entries, got shape {tuple(mask.shape)}")
    return mask.reshape(b, t)


def _flash_ok(t: int, d_k: int) -> bool:
    """The JAX package's dispatch gate (transformer.py:110-138): T tiles
    into one block of <= 128 rows or into 128-row blocks, and d_k % 32 ==
    0. Both JEGAL encoders qualify at every bucket (d_k 64 and 96); the
    21-token GestSync windows do not (they run the fused kernels)."""
    return t % 8 == 0 and (t <= 128 or t % 128 == 0) and d_k % 32 == 0


def multi_head_attention(params, q_in, k_in, v_in, mask, num_heads: int):
    """MHA (reference models/modules.py:88-120). mask: None or
    broadcastable to (B, 1, Tq, Tk) after a head-axis unsqueeze — pass
    (B, 1, Tk) or (B, Tq, Tk). On a CUDA tensor this is
    `flash_attention_diff` (transformer.py:169-188), which takes
    self-attention with a key mask at a shape `_flash_ok` admits; anything
    else raises there. On a CPU tensor it is the dense reference."""
    q = _split_heads(linear(params["q"], q_in), num_heads)
    k = _split_heads(linear(params["k"], k_in), num_heads)
    v = _split_heads(linear(params["v"], v_in), num_heads)
    b, _, t, d_k = q.shape
    if _on_card(q):
        if q_in is not k_in or t != k.shape[2] or not _flash_ok(t, d_k):
            raise ValueError(
                f"the flash attention kernel takes self-attention with T % 8 "
                f"== 0, T <= 128 or T % 128 == 0, and d_k % 32 == 0; got "
                f"Tq {t}, Tk {k.shape[2]}, d_k {d_k}"
                + ("" if q_in is k_in else ", cross-attention"))
        out = FA.flash_attention_diff(q, k, v, _key_mask(mask, b, t))
        return linear(params["o"], _merge_heads(out))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d_k)
    m = mask
    if m is not None:
        while m.dim() < 4:
            m = m.unsqueeze(1)
    p = masked_attention_weights(scores, m).to(q.dtype)
    return linear(params["o"], _merge_heads(torch.matmul(p, v)))


def _ffn(params, x):
    return linear(params["w2"], torch.relu(linear(params["w1"], x)))


def encoder_layer(params, x, mask, num_heads: int):
    h = ref_layer_norm(params["norm1"], x)
    x = x + multi_head_attention(params["attn"], h, h, h, mask, num_heads)
    h = ref_layer_norm(params["norm2"], x)
    return x + _ffn(params["ff"], h)


def encoder_stack(params, x, mask, num_heads: int, fused: bool = True):
    """N pre-norm layers + the final reference LayerNorm. x: (B, T, d).

    On a CUDA tensor, with fused=True and a shape that
    fused_layer.fused_stack_ok admits (T <= 512), the layers run as the
    fused sublayer kernels over the (B*T, d) rows. Otherwise the layer loop
    below runs: on the CPU, and on the card for T > 512 (a long clip) and
    with fused=False, which training passes because the fused kernels have
    no backward (JAX package transformer.py:206-247); its attention there
    is the flash attention kernel. On the card the mask must be a key
    mask."""
    b, t, d = x.shape
    if _on_card(x) and fused and FL.fused_stack_ok(t, d, num_heads):
        kmask = _key_mask(mask, b, t)
        km = None if kmask is None else kmask.reshape(-1)
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
    if _on_card(x):
        b, t, d = x.shape
        kmask = _key_mask(mask, b, t)
        km = None if kmask is None else kmask.reshape(-1)
        out = FL.fused_torch_stack(params, x.reshape(b * t, d), t,
                                   num_heads, kmask=km)
        return out.reshape(b, t, d)
    for layer in params["layers"]:
        x = torch_encoder_layer(layer, x, mask, num_heads)
    return x
