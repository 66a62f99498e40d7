"""Parameter trees for the port: from the JAX package's pytrees, or random
from an explicit torch.Generator.

The port computes on nested dicts of float32 tensors in the JAX layouts
(core/layers.py), so a JAX tree converts leaf by leaf and both packages
compute with the same weights. Random trees randomize the BatchNorm running
statistics and the LayerNorm parameters: identity statistics would hide a
BN or LN that is skipped or applied twice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jegal_torch.config import D_MODEL_TEXT
from jegal_torch.models.gestsync import CHANNELS, VGG_SPEC
from jegal_torch.models.jegal import AUDIO_CHANNELS, AUDIO_CNN_SPEC
from jegal_torch.models.roberta import XLMR_BASE, RobertaConfig


def tree_to_torch(tree, device="cpu"):
    """Nested dicts/lists of array or tensor leaves -> the same nesting of
    float32 tensors on `device` (integer leaves keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    if tree is None:
        return None
    t = (tree if isinstance(tree, torch.Tensor)
         else torch.tensor(np.asarray(tree)))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def gestsync_params_from_jax(tree, device="cpu"):
    """jegal_tpu GestSync pytree (G.init_params / G.params_from_torch
    layout) -> the port's tree. The unused audio sync branch is dropped."""
    return tree_to_torch({k: tree[k] for k in
                          ("net_vid", "transformer", "ff1", "ff2")}, device)


def jegal_params_from_jax(tree, device="cpu"):
    """jegal_tpu JEGAL pytree (J.init_params / J.params_from_torch layout)
    -> the port's tree."""
    return tree_to_torch(dict(tree), device)


def roberta_params_from_jax(tree, device="cpu"):
    """jegal_tpu XLM-R tree (R.params_from_hf layout: "embeddings" and the
    list of "layers") -> the port's tree. models.roberta.stack_layers adds
    the stack kernel's operands (JegalEngine does at load)."""
    return tree_to_torch({"embeddings": tree["embeddings"],
                          "layers": list(tree["layers"])}, device)


# ---------------------------------------------------------------------------
# Random trees
# ---------------------------------------------------------------------------

def _uniform(g, shape, bound):
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def _linear(g, d_in, d_out):
    """torch nn.Linear default init."""
    bound = 1.0 / math.sqrt(d_in)
    return {"kernel": _uniform(g, (d_in, d_out), bound),
            "bias": _uniform(g, (d_out,), bound)}


def _conv(g, kshape):
    """kshape HWIO / DHWIO. He-uniform kernels keep the signal alive
    through a stack of random conv+ReLU blocks (torch's default bound
    shrinks its power ~6x a block, which leaves the GestSync tokens nearly
    constant across frames); biases take torch's default bound."""
    fan_in = int(np.prod(kshape[:-1]))
    return {"kernel": _uniform(g, kshape, math.sqrt(6.0 / fan_in)),
            "bias": _uniform(g, (kshape[-1],), 1.0 / math.sqrt(fan_in))}


def _norm(g, d):
    return {"scale": 1.0 + 0.1 * torch.randn(d, generator=g),
            "bias": 0.1 * torch.randn(d, generator=g)}


def _batch_norm(g, d):
    return dict(_norm(g, d), mean=0.1 * torch.randn(d, generator=g),
                var=0.5 + torch.rand(d, generator=g))


def _encoder_layer(g, d, d_ff):
    return {"attn": {k: _linear(g, d, d) for k in ("q", "k", "v", "o")},
            "ff": {"w1": _linear(g, d, d_ff), "w2": _linear(g, d_ff, d)},
            "norm1": _norm(g, d), "norm2": _norm(g, d)}


def init_gestsync_params(generator: torch.Generator, device="cpu"):
    """Random GestSync tree at full width (6 conv blocks, 6 layers)."""
    g = generator
    net_vid = [{"conv": _conv(g, spec["k"] + (CHANNELS[i], CHANNELS[i + 1])),
                "bn": _batch_norm(g, CHANNELS[i + 1])}
               for i, spec in enumerate(VGG_SPEC)]
    return tree_to_torch({
        "net_vid": net_vid,
        "transformer": {"layers": [_encoder_layer(g, 512, 2048)
                                   for _ in range(6)]},
        "ff1": _linear(g, 512, 512),
        "ff2": _linear(g, 512, 1024),
    }, device)


def init_roberta_params(generator: torch.Generator,
                        cfg: RobertaConfig = XLMR_BASE, device="cpu"):
    """Random XLM-R tree (R.params_from_hf layout) at the width of `cfg`:
    embeddings N(0, 0.02) as HF initializes them, nn.Linear-default
    linears, randomized LayerNorm parameters."""
    g = generator
    d, dff = cfg.hidden_size, cfg.intermediate_size

    def table(n):
        return 0.02 * torch.randn(n, d, generator=g)

    emb = {"word": table(cfg.vocab_size),
           "position": table(cfg.max_position_embeddings),
           "token_type": table(1), "ln": _norm(g, d)}
    layers = [{"q": _linear(g, d, d), "k": _linear(g, d, d),
               "v": _linear(g, d, d), "attn_out": _linear(g, d, d),
               "attn_ln": _norm(g, d), "inter": _linear(g, d, dff),
               "out": _linear(g, dff, d), "out_ln": _norm(g, d)}
              for _ in range(cfg.num_layers)]
    return tree_to_torch({"embeddings": emb, "layers": layers}, device)


def init_jegal_params(generator: torch.Generator, device="cpu"):
    """Random JEGAL tree at full width. The text branch's leaves are drawn
    after all the others, so a seed gives the gesture and audio branches
    the same weights with or without them."""
    g = generator
    cnn = []
    for i, spec in enumerate(AUDIO_CNN_SPEC):
        blk = {"conv": _conv(g, spec["k"] + (AUDIO_CHANNELS[i],
                                             AUDIO_CHANNELS[i + 1]))}
        if spec["bn"]:
            blk["bn"] = _batch_norm(g, AUDIO_CHANNELS[i + 1])
        cnn.append(blk)

    def mlp2():
        return [_linear(g, 512, 512), _linear(g, 512, 512)]

    tree = {
        "proj_ip_rgb": [_linear(g, 1024, 512), _linear(g, 512, 512)],
        "proj_ip_ln": _norm(g, 512),
        "encoder_rgb": {"layers": [_encoder_layer(g, 512, 2048)
                                   for _ in range(6)],
                        "norm": _norm(g, 512)},
        "proj_op_rgb": _linear(g, 512, 512),
        "cnn": cnn,
        "proj_op_audio": _linear(g, 256, 256),
        "proj_op_fusion_content": mlp2(),
        "proj_op_align_gesture": mlp2(),
        "proj_op_align_content": mlp2(),
    }
    tree["encoder_text"] = {
        "layers": [_encoder_layer(g, D_MODEL_TEXT, 3072) for _ in range(3)],
        "norm": _norm(g, D_MODEL_TEXT)}
    tree["proj_op_text"] = _linear(g, D_MODEL_TEXT, 256)
    return tree_to_torch(tree, device)
