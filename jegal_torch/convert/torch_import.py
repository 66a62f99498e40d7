"""Torch state_dict -> the port's parameter trees (the JAX package's
convert/torch_import.py, with the same names and layouts).

Every converter takes a flat mapping `sd` of name -> tensor or numpy array
plus a `prefix`, and returns float32 tensors in the JAX layouts that the
port computes on (core/layers.py):

  torch Linear   weight (out, in)            -> kernel (in, out)
  torch Conv2d   weight (O, I, kh, kw)       -> kernel HWIO
  torch Conv3d   weight (O, I, kd, kh, kw)   -> kernel DHWIO
  torch LN/BN    weight/bias (+ running_*)   -> scale/bias (+ mean/var)

The reference has two MHA flavors: the "annotated" MultiHeadedAttention
with four Linears `linears.{0..3}` (reference models/modules.py:88-120),
and torch's nn.MultiheadAttention with a fused `in_proj` (GestSync's
nn.TransformerEncoder, reference models/gestsync.py:20-21).

Every leaf is a new contiguous CPU tensor: nothing aliases the state dict.
"""

from __future__ import annotations

import numpy as np
import torch


def _j(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _get(sd, name) -> torch.Tensor:
    arr = sd[name]
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu", torch.float32, copy=True)
    return torch.tensor(np.asarray(arr), dtype=torch.float32)


def linear_from_torch(sd, prefix: str):
    p = {"kernel": _get(sd, _j(prefix, "weight")).T.contiguous()}
    if _j(prefix, "bias") in sd:
        p["bias"] = _get(sd, _j(prefix, "bias"))
    return p


def layer_norm_from_torch(sd, prefix: str):
    """The reference's own LayerNorm (a_2/b_2) or torch nn.LayerNorm
    (weight/bias)."""
    if _j(prefix, "a_2") in sd:
        return {"scale": _get(sd, _j(prefix, "a_2")),
                "bias": _get(sd, _j(prefix, "b_2"))}
    return {"scale": _get(sd, _j(prefix, "weight")),
            "bias": _get(sd, _j(prefix, "bias"))}


def batch_norm_from_torch(sd, prefix: str):
    return {"scale": _get(sd, _j(prefix, "weight")),
            "bias": _get(sd, _j(prefix, "bias")),
            "mean": _get(sd, _j(prefix, "running_mean")),
            "var": _get(sd, _j(prefix, "running_var"))}


def _conv_from_torch(sd, prefix: str, perm):
    w = _get(sd, _j(prefix, "weight"))
    p = {"kernel": w.permute(*perm).contiguous()}
    if _j(prefix, "bias") in sd:
        p["bias"] = _get(sd, _j(prefix, "bias"))
    return p


def conv2d_from_torch(sd, prefix: str):
    """(O, I, kh, kw) -> HWIO."""
    return _conv_from_torch(sd, prefix, (2, 3, 1, 0))


def conv3d_from_torch(sd, prefix: str):
    """(O, I, kd, kh, kw) -> DHWIO."""
    return _conv_from_torch(sd, prefix, (2, 3, 4, 1, 0))


def mha_from_annotated_torch(sd, prefix: str):
    """The reference's MultiHeadedAttention: linears.{0,1,2,3} = q, k, v,
    o."""
    return {name: linear_from_torch(sd, _j(prefix, f"linears.{i}"))
            for i, name in enumerate(("q", "k", "v", "o"))}


def mha_from_torch_native(sd, prefix: str):
    """torch nn.MultiheadAttention: the fused in_proj split into q, k, v."""
    w = _get(sd, _j(prefix, "in_proj_weight"))     # (3d, d)
    b = _get(sd, _j(prefix, "in_proj_bias"))       # (3d,)
    d = w.shape[1]
    out = {name: {"kernel": w[i * d:(i + 1) * d].T.contiguous(),
                  "bias": b[i * d:(i + 1) * d].clone()}
           for i, name in enumerate(("q", "k", "v"))}
    out["o"] = linear_from_torch(sd, _j(prefix, "out_proj"))
    return out


def _ffn_from_torch(sd, prefix: str, w1: str, w2: str):
    return {"w1": linear_from_torch(sd, f"{prefix}.{w1}"),
            "w2": linear_from_torch(sd, f"{prefix}.{w2}")}


def encoder_stack_from_annotated_torch(sd, prefix: str, num_layers: int):
    """The reference Encoder_Transformer (models/modules.py:11-22):
    layers.{i}.self_attn / .feed_forward / .sublayer.{0,1}.norm, and the
    final .norm."""
    layers = []
    for i in range(num_layers):
        lp = _j(prefix, f"layers.{i}")
        layers.append({
            "attn": mha_from_annotated_torch(sd, lp + ".self_attn"),
            "ff": _ffn_from_torch(sd, lp + ".feed_forward", "w_1", "w_2"),
            "norm1": layer_norm_from_torch(sd, lp + ".sublayer.0.norm"),
            "norm2": layer_norm_from_torch(sd, lp + ".sublayer.1.norm"),
        })
    return {"layers": layers,
            "norm": layer_norm_from_torch(sd, _j(prefix, "norm"))}


def torch_encoder_stack_from_torch(sd, prefix: str, num_layers: int):
    """torch nn.TransformerEncoder (post-norm): layers.{i}.self_attn /
    linear1 / linear2 / norm1 / norm2."""
    layers = []
    for i in range(num_layers):
        lp = _j(prefix, f"layers.{i}")
        layers.append({
            "attn": mha_from_torch_native(sd, lp + ".self_attn"),
            "ff": _ffn_from_torch(sd, lp, "linear1", "linear2"),
            "norm1": layer_norm_from_torch(sd, lp + ".norm1"),
            "norm2": layer_norm_from_torch(sd, lp + ".norm2"),
        })
    return {"layers": layers}


def strip_module_prefix(sd):
    """Strip nn.DataParallel's 'module.' prefixes (the reference
    checkpoints were saved under it, reference inference_embs.py:110-114)."""
    return {k.replace("module.", "", 1) if k.startswith("module.") else k: v
            for k, v in sd.items()}
