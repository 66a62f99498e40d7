"""The GestSync tower alone: the engine `extract-feats` builds
(jegal_torch/cli/main.py `_extract_feats`: no JEGAL, XLM-R or tokenizer
parameters), and its work."""

from __future__ import annotations

import torch

from h100_bench.lib.counts import encoders, model, stem


def build(config: dict, weights: dict, device):
    from jegal_torch.api import JegalEngine

    return JegalEngine(jegal_params=None,
                       gestsync_params=weights["gestsync"], device=device,
                       dtype=torch.float32, **config["engine"])


def tower_launches(g: dict, b: int, t_bucket: int) -> dict:
    """A batched tower chunk of b padded clips at the T bucket: the stem
    over each clip's edge-padded frames, and the window head's six
    attention and FFN sublayers over b * T * 21 rows."""
    h, w, _ = g["frame"]
    t_in = t_bucket + 2 * g["edge_pad"]
    seg = g["window"] - g["kernels"][0][0] + 1
    r = b * t_bucket * seg
    d = g["d_model"]
    layers = g["num_layers"]
    return {"stem": [(stem.flops(t_in, h, w), stem.nbytes(t_in, h, w))] * b,
            "encoders": ([encoders.attn(r, d, seg, False)] * layers
                         + [encoders.ffn(r, d, g["d_ff"])] * layers)}


def launched(config: dict, chunk: dict) -> dict:
    return tower_launches(config["gestsync"], chunk["b"], chunk["t"])


def model_flops(config: dict, clip: dict) -> float:
    return model.tower_flops(config["gestsync"], clip["t"])
