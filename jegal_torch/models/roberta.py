"""XLM-RoBERTa encoder (the JAX package's models/roberta.py), HF-weight
compatible.

The reference runs a frozen HuggingFace `XLMRobertaModel` (reference
models/jegal.py:13-14,116-129) and keeps `last_hidden_state`. Architecture
(BERT-style post-norm; xlm-roberta-base: 12 layers, d=768, 12 heads,
d_ff=3072, exact GELU, LayerNorm eps 1e-5):

  embeddings: word + learned positions (RoBERTa padding_idx offset) +
              token_type + LayerNorm
  layer:      self-attn -> dense -> +residual -> LN -> FFN -> +residual -> LN

The plain path adds HF's extended mask, (1 - mask) * finfo(float32).min,
to the scores. On a CUDA tensor the whole stack is ONE call of the stack
kernel (ops/kernels/fused_layer.fused_roberta_stack), which fills masked
scores with -1e9 instead: both weigh a masked key exactly 0 after the
softmax, so every valid row agrees. A configuration the kernel cannot take
(head width other than 64 or 96, LayerNorm eps other than 1e-5) raises on
the card; it never runs the plain loop there.

Parameter tree (the JAX package's `params_from_hf` layout):
  {"embeddings": {"word", "position", "token_type", "ln"},
   "layers": [{"q", "k", "v", "attn_out", "attn_ln", "inter", "out",
               "out_ln"}, ...]}
`stack_layers` adds "fused_ops", the stack kernel's (L, ...) operands, once
at load time. (The JAX package also stacks "layers" for a lax.scan; the
eager loop here has no use for that copy.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from jegal_torch.core.layers import linear, std_layer_norm
from jegal_torch.ops.kernels import fused_layer as FL

PAD_TOKEN_ID = 1  # RoBERTa/XLM-R padding_idx


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 250002
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5


XLMR_BASE = RobertaConfig()


def create_position_ids(input_ids, pad_id: int = PAD_TOKEN_ID):
    """RoBERTa position ids: running count of non-pad tokens + pad_id, and
    pad_id at pads (HF create_position_ids_from_input_ids)."""
    mask = (input_ids != pad_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_id


def embeddings(params, input_ids, cfg: RobertaConfig):
    ids = input_ids.to(torch.int64)
    x = (params["word"][ids] + params["position"][create_position_ids(ids)]
         + params["token_type"][0][None, None, :])
    return std_layer_norm(params["ln"], x, eps=cfg.layer_norm_eps)


def _attention(params, x, ext_mask, cfg: RobertaConfig):
    b, s, d = x.shape
    h = cfg.num_heads
    dk = d // h

    def heads(p):
        return linear(p, x).reshape(b, s, h, dk).transpose(1, 2)

    q, k, v = heads(params["q"]), heads(params["k"]), heads(params["v"])
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
    if ext_mask is not None:
        scores = scores + ext_mask
    ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
    return linear(params["attn_out"], ctx.transpose(1, 2).reshape(b, s, d))


def encoder_layer(params, x, ext_mask, cfg: RobertaConfig):
    a = _attention(params, x, ext_mask, cfg)
    x = std_layer_norm(params["attn_ln"], x + a, eps=cfg.layer_norm_eps)
    f = linear(params["out"], F.gelu(linear(params["inter"], x)))
    return std_layer_norm(params["out_ln"], x + f, eps=cfg.layer_norm_eps)


def _fused_layout(layer):
    """One layer's tree -> the core/transformer layout the fused kernels
    take ({"attn": {q, k, v, o}, "ff": {w1, w2}, "norm1", "norm2"})."""
    return {"attn": {"q": layer["q"], "k": layer["k"], "v": layer["v"],
                     "o": layer["attn_out"]},
            "ff": {"w1": layer["inter"], "w2": layer["out"]},
            "norm1": layer["attn_ln"], "norm2": layer["out_ln"]}


def stack_layers(params):
    """The params plus `fused_ops`: the stack kernel's (L, ...) operands
    (fused_layer.stacked_weights), so no forward concatenates or stacks a
    weight. Done once at load (JegalEngine does); costs a second copy of
    the encoder weights on the device (340 MB for xlm-roberta-base)."""
    return dict(params, fused_ops=FL.stacked_weights(
        [_fused_layout(l) for l in params["layers"]]))


def forward(params, input_ids, attention_mask, cfg: RobertaConfig = XLMR_BASE):
    """input_ids, attention_mask: (B, S) -> last_hidden_state (B, S, d).

    On a CUDA tensor the stack is one kernel call (any S: the positions cap
    it at 512), on `fused_ops` when `stack_layers` has added them, else on
    operands stacked for this call. On a CPU tensor the plain layer loop
    runs.

    The kernel has no backward, and its wrapper raises under a gradient.
    The trainer calls this backbone inside torch.no_grad() (the counterpart
    of the JAX trainer's jax.lax.stop_gradient), so the frozen backbone
    runs on the kernel; the JAX trainer passes fused=False only because a
    Pallas kernel there has no VJP at all, and this backbone needs none."""
    x = embeddings(params["embeddings"], input_ids, cfg)
    b, s, d = x.shape
    if x.is_cuda:
        if cfg.layer_norm_eps != 1e-5:
            raise ValueError(f"the stack kernel's LayerNorm has eps 1e-5, "
                             f"the config {cfg.layer_norm_eps}")
        layers = params.get("fused_ops")
        if layers is None:
            layers = [_fused_layout(l) for l in params["layers"]]
        km = None if attention_mask is None else attention_mask.reshape(-1)
        out = FL.fused_roberta_stack(layers, x.reshape(b * s, d), s,
                                     cfg.num_heads, kmask=km)
        return out.reshape(b, s, d)
    ext_mask = None
    if attention_mask is not None:
        ext_mask = (1.0 - attention_mask.to(torch.float32))[:, None, None, :]
        ext_mask = ext_mask * torch.finfo(torch.float32).min
    for layer in params["layers"]:
        x = encoder_layer(layer, x, ext_mask, cfg)
    return x
