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
`params_from_hf` converts an HF XLMRobertaModel state dict. `stack_layers`
adds "fused_ops", the stack kernel's (L, ...) operands, once at load time.
(The JAX package also stacks "layers" for a lax.scan; the eager loop here
has no use for that copy.)

Under a model group of m > 1 ranks (parallel/mesh.py) the layers hold this
rank's shards (`roberta_param_spec`: q, k, v and inter by columns,
attn_out and out by rows) and run a Megatron layer loop: 12 / m heads a
rank, each row-split product summed over the group before its bias, the
residual and the post-LN; on a CUDA tensor its attention is the flash
attention kernel (ops/kernels/flash_attention.py). `fused_ops` is never
split: a sharded tree has none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from jegal_torch.core.layers import linear, std_layer_norm
from jegal_torch.core.transformer import local_heads, row_parallel_linear
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as FL
from jegal_torch.parallel.collectives import copy_to_model, group_size

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


def _gather_rows(table, idx):
    """table[idx] with the JAX gather's index semantics: a negative index
    counts from the end once, and an index still out of range clamps to
    the first or last row. A batch row padded with zeros (`<s>` ids, not
    the pad id) counts every token as real and asks for positions past the
    table; JAX clamps them, and so does this, so no input raises on the CPU
    or asserts on the card, and the valid rows are those of the JAX
    package bit for bit."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def embeddings(params, input_ids, cfg: RobertaConfig):
    ids = input_ids.to(torch.int64)
    x = (_gather_rows(params["word"], ids)
         + _gather_rows(params["position"], create_position_ids(ids))
         + params["token_type"][0][None, None, :])
    return std_layer_norm(params["ln"], x, eps=cfg.layer_norm_eps)


def _attention(params, x, mask, cfg: RobertaConfig, group=None):
    """Self-attention and its output product. mask: HF's additive (B, 1,
    1, S) mask on a CPU tensor; on a CUDA tensor (the layer loop of a
    model group) the (B, S) key mask of the flash attention kernel."""
    b, s, d = x.shape
    h = local_heads(cfg.num_heads, group)
    dk = d // cfg.num_heads
    x = copy_to_model(x, group)

    def heads(p):
        return linear(p, x).reshape(b, s, h, dk).transpose(1, 2)

    q, k, v = heads(params["q"]), heads(params["k"]), heads(params["v"])
    if x.is_cuda:
        ctx = FA.flash_attention_diff(q, k, v, mask)
    elif x.dtype != torch.float32:
        # bf16: float32 scores, mask and softmax; p and the context
        # rounded to bf16 (the JAX package's _attention)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(dk)
        if mask is not None:
            scores = scores + mask
        p = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(p.float(), v.float()).to(x.dtype)
    else:
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        if mask is not None:
            scores = scores + mask
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
    return row_parallel_linear(params["attn_out"], ctx.transpose(1, 2)
                               .reshape(b, s, h * dk), group)


def encoder_layer(params, x, mask, cfg: RobertaConfig, group=None):
    a = _attention(params, x, mask, cfg, group)
    x = std_layer_norm(params["attn_ln"], x + a, eps=cfg.layer_norm_eps)
    inter = F.gelu(linear(params["inter"], copy_to_model(x, group)))
    f = row_parallel_linear(params["out"], inter, group)
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


def _extended_mask(attention_mask):
    """HF's additive mask, (1 - mask) * finfo(float32).min, (B, 1, 1, S)."""
    if attention_mask is None:
        return None
    ext = (1.0 - attention_mask.to(torch.float32))[:, None, None, :]
    return ext * torch.finfo(torch.float32).min


def forward(params, input_ids, attention_mask, cfg: RobertaConfig = XLMR_BASE,
            group=None):
    """input_ids, attention_mask: (B, S) -> last_hidden_state (B, S, d).

    On a CUDA tensor the stack is one kernel call (any S: the positions cap
    it at 512), on `fused_ops` when `stack_layers` has added them, else on
    operands stacked for this call. On a CPU tensor the plain layer loop
    runs. Under a model `group` of more than one rank the tree is this
    rank's shards and the Megatron layer loop runs (module docstring), on
    the flash attention kernel on a CUDA tensor.

    The kernel has no backward, and its wrapper raises under a gradient.
    The trainer calls this backbone inside torch.no_grad() (the counterpart
    of the JAX trainer's jax.lax.stop_gradient), so the frozen backbone
    runs on the kernel; the JAX trainer passes fused=False only because a
    Pallas kernel there has no VJP at all, and this backbone needs none."""
    x = embeddings(params["embeddings"], input_ids, cfg)
    b, s, d = x.shape
    if group_size(group) > 1:
        mask = attention_mask if x.is_cuda else _extended_mask(attention_mask)
        for layer in params["layers"]:
            x = encoder_layer(layer, x, mask, cfg, group)
        return x
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
    ext_mask = _extended_mask(attention_mask)
    for layer in params["layers"]:
        x = encoder_layer(layer, x, ext_mask, cfg)
    return x


def params_from_hf(sd, cfg: RobertaConfig = XLMR_BASE):
    """An HF XLMRobertaModel / RobertaModel state dict -> the port's tree
    (the JAX package's roberta.py:191-215). Keys may come with or without
    the 'roberta.' prefix; the pooler is ignored."""
    from jegal_torch.convert.torch_import import (
        _get,
        layer_norm_from_torch,
        linear_from_torch,
    )

    if not any(k.startswith("embeddings.") for k in sd):
        sd = {k.split(".", 1)[1]: v for k, v in sd.items() if "." in k}
    emb = {
        "word": _get(sd, "embeddings.word_embeddings.weight"),
        "position": _get(sd, "embeddings.position_embeddings.weight"),
        "token_type": _get(sd, "embeddings.token_type_embeddings.weight"),
        "ln": layer_norm_from_torch(sd, "embeddings.LayerNorm"),
    }
    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"

        def lin(name):
            return linear_from_torch(sd, f"{p}.{name}")

        def ln(name):
            return layer_norm_from_torch(sd, f"{p}.{name}")

        layers.append({
            "q": lin("attention.self.query"), "k": lin("attention.self.key"),
            "v": lin("attention.self.value"),
            "attn_out": lin("attention.output.dense"),
            "attn_ln": ln("attention.output.LayerNorm"),
            "inter": lin("intermediate.dense"), "out": lin("output.dense"),
            "out_ln": ln("output.LayerNorm"),
        })
    return {"embeddings": emb, "layers": layers}
