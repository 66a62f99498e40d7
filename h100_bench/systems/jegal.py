"""JEGAL with XLM-R: the engine `extract-embs` builds (GestSync, JEGAL and
XLM-R parameters and a word tokenizer over the benchmark's piece
tokenizer), and its work."""

from __future__ import annotations

import torch

from h100_bench.lib.counts import encoders, model
from h100_bench.lib.tokenizer import PieceTokenizer
from h100_bench.systems import gestsync


def build(config: dict, weights: dict, device):
    from jegal_torch.api import JegalEngine
    from jegal_torch.models.roberta import RobertaConfig
    from jegal_torch.text.tokenizer import WordTokenizer

    x = config["xlmr"]
    cfg = RobertaConfig(vocab_size=x["vocab_size"],
                        hidden_size=x["hidden_size"],
                        num_layers=x["num_layers"], num_heads=x["num_heads"],
                        intermediate_size=x["intermediate_size"],
                        max_position_embeddings=x["max_position_embeddings"],
                        layer_norm_eps=x["layer_norm_eps"])
    return JegalEngine(weights["jegal"], gestsync_params=weights["gestsync"],
                       device=device, roberta_params=weights["xlmr"],
                       tokenizer=WordTokenizer(PieceTokenizer(x["vocab_size"])),
                       roberta_cfg=cfg, dtype=torch.float32,
                       fusion_strategy=config["jegal"]["fusion"],
                       **config["engine"])


def launched(config: dict, chunk: dict) -> dict:
    """A fused `vta` chunk of b padded samples: the tower, the gesture
    encoder over b * T rows, the text encoder over b * S rows, and XLM-R
    as one stack launch over them."""
    j, x = config["jegal"], config["xlmr"]
    b, t, s = chunk["b"], chunk["t"], chunk["s"]
    out = gestsync.tower_launches(config["gestsync"], b, t)
    d, dt = j["d_model"], j["d_text"]
    out["encoders"] += (
        [encoders.attn(b * t, d, t, True)] * j["gesture_layers"]
        + [encoders.ffn(b * t, d, j["d_ff"])] * j["gesture_layers"]
        + [encoders.attn(b * s, dt, s, True)] * j["text_layers"]
        + [encoders.ffn(b * s, dt, j["d_ff_text"])] * j["text_layers"]
        + [encoders.stack(b * s, x["hidden_size"], x["intermediate_size"],
                          s, x["num_layers"], True)])
    return out


def model_flops(config: dict, clip: dict) -> float:
    return model.jegal_flops(config, clip["t"], clip["tokens"], clip["words"],
                             clip["mel"])
