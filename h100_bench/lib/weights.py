"""Seeded random weights for a configuration, made on the device in a few
large calls, in `jegal_torch.convert`'s parameter layout (nested dicts of
float32 tensors: linear {"kernel" (in, out), "bias"}, conv {"kernel"
DHWIO / HWIO, "bias"}, norm {"scale", "bias"}, batch norm {"scale",
"bias", "mean", "var"}).

The distributions follow `jegal_torch.convert`'s random trees: nn.Linear's
default bounds, He-uniform convolution kernels (a random conv tower keeps
its signal alive), N(0, 0.02) embedding tables, and randomised LayerNorm
and BatchNorm parameters and running statistics (identity statistics would
hide a norm that is skipped or applied twice). The draw itself is the
benchmark's own: one uniform and one normal buffer from a generator on the
device, every leaf a view of one of them. The same seed gives the same
trees on the same device.

Every tree is built from the configuration file's sizes, so the plain
reference and the program get one set of tensors from one description."""

from __future__ import annotations

import math

import numpy as np
import torch


class _Leaf:
    __slots__ = ("shape", "kind", "arg")

    def __init__(self, shape, kind: str, arg: float = 0.0):
        self.shape, self.kind, self.arg = tuple(shape), kind, arg

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))


def _linear(d_in: int, d_out: int) -> dict:
    b = 1.0 / math.sqrt(d_in)
    return {"kernel": _Leaf((d_in, d_out), "uniform", b),
            "bias": _Leaf((d_out,), "uniform", b)}


def _conv(kshape) -> dict:
    fan_in = int(np.prod(kshape[:-1]))
    return {"kernel": _Leaf(kshape, "uniform", math.sqrt(6.0 / fan_in)),
            "bias": _Leaf((kshape[-1],), "uniform", 1.0 / math.sqrt(fan_in))}


def _norm(d: int) -> dict:
    return {"scale": _Leaf((d,), "one_plus_normal", 0.1),
            "bias": _Leaf((d,), "normal", 0.1)}


def _batch_norm(d: int) -> dict:
    return dict(_norm(d), mean=_Leaf((d,), "normal", 0.1),
                var=_Leaf((d,), "half_plus_uniform"))


def _layer(d: int, d_ff: int) -> dict:
    return {"attn": {k: _linear(d, d) for k in ("q", "k", "v", "o")},
            "ff": {"w1": _linear(d, d_ff), "w2": _linear(d_ff, d)},
            "norm1": _norm(d), "norm2": _norm(d)}


def gestsync_spec(g: dict) -> dict:
    ch = g["channels"]
    return {
        "net_vid": [{"conv": _conv(tuple(k) + (ch[i], ch[i + 1])),
                     "bn": _batch_norm(ch[i + 1])}
                    for i, k in enumerate(g["kernels"])],
        "transformer": {"layers": [_layer(g["d_model"], g["d_ff"])
                                   for _ in range(g["num_layers"])]},
        "ff1": _linear(g["d_model"], g["d_model"]),
        "ff2": _linear(g["d_model"], g["d_out"]),
    }


def jegal_spec(j: dict) -> dict:
    ch = j["audio_channels"]
    cnn = []
    for i, k in enumerate(j["audio_kernels"]):
        blk = {"conv": _conv(tuple(k) + (ch[i], ch[i + 1]))}
        if j["audio_bn"][i]:
            blk["bn"] = _batch_norm(ch[i + 1])
        cnn.append(blk)
    d = j["d_model"]

    def mlp2():
        return [_linear(d, d), _linear(d, d)]

    return {
        "proj_ip_rgb": [_linear(j["d_visual"], d), _linear(d, d)],
        "proj_ip_ln": _norm(d),
        "encoder_rgb": {"layers": [_layer(d, j["d_ff"])
                                   for _ in range(j["gesture_layers"])],
                        "norm": _norm(d)},
        "proj_op_rgb": _linear(d, d),
        "cnn": cnn,
        "proj_op_audio": _linear(ch[-1], j["d_audio_out"]),
        "proj_op_fusion_content": mlp2(),
        "proj_op_align_gesture": mlp2(),
        "proj_op_align_content": mlp2(),
        "encoder_text": {"layers": [_layer(j["d_text"], j["d_ff_text"])
                                    for _ in range(j["text_layers"])],
                         "norm": _norm(j["d_text"])},
        "proj_op_text": _linear(j["d_text"], j["d_text_out"]),
    }


def xlmr_spec(x: dict) -> dict:
    d, dff = x["hidden_size"], x["intermediate_size"]

    def table(n):
        return _Leaf((n, d), "normal", 0.02)

    return {
        "embeddings": {"word": table(x["vocab_size"]),
                       "position": table(x["max_position_embeddings"]),
                       "token_type": table(1), "ln": _norm(d)},
        "layers": [{"q": _linear(d, d), "k": _linear(d, d),
                    "v": _linear(d, d), "attn_out": _linear(d, d),
                    "attn_ln": _norm(d), "inter": _linear(d, dff),
                    "out": _linear(dff, d), "out_ln": _norm(d)}
                   for _ in range(x["num_layers"])],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


_NORMAL = ("normal", "one_plus_normal")


def _fill(tree, views: dict):
    if isinstance(tree, dict):
        return {k: _fill(v, views) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, views) for v in tree]
    return views[id(tree)]


def materialize(spec, seed: int, stream: int, device) -> dict:
    """The tensors of a spec tree: one uniform and one normal draw of all
    its leaves from a generator on `device` seeded by (seed, stream), each
    leaf transformed in place on its slice."""
    leaves = list(_leaves(spec))
    n_norm = sum(l.numel for l in leaves if l.kind in _NORMAL)
    n_unif = sum(l.numel for l in leaves if l.kind not in _NORMAL)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, stream))
    unif = torch.rand(n_unif, generator=gen, device=device)
    norm = torch.randn(n_norm, generator=gen, device=device)
    views, at_u, at_n = {}, 0, 0
    for leaf in leaves:
        if leaf.kind in _NORMAL:
            v, at_n = norm[at_n:at_n + leaf.numel], at_n + leaf.numel
        else:
            v, at_u = unif[at_u:at_u + leaf.numel], at_u + leaf.numel
        if leaf.kind == "uniform":
            v.mul_(2.0).sub_(1.0).mul_(leaf.arg)
        elif leaf.kind == "normal":
            v.mul_(leaf.arg)
        elif leaf.kind == "one_plus_normal":
            v.mul_(leaf.arg).add_(1.0)
        elif leaf.kind == "half_plus_uniform":
            v.add_(0.5)
        else:
            raise ValueError(f"unknown leaf kind {leaf.kind}")
        views[id(leaf)] = v.view(leaf.shape)
    return _fill(spec, views)


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of a run's seed (any whole
    number >= 0, larger than 32 bits too)."""
    ss = np.random.SeedSequence([int(seed), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# one stream a tree, so that a configuration without a branch draws the
# others' weights alike
STREAMS = {"gestsync": 11, "jegal": 12, "xlmr": 13}


def make_weights(config: dict, seed: int, device) -> dict:
    """{"gestsync": tree, "jegal": tree | absent, "xlmr": tree | absent}
    for the configuration's branches."""
    out = {"gestsync": materialize(gestsync_spec(config["gestsync"]), seed,
                                   STREAMS["gestsync"], device)}
    if "jegal" in config:
        out["jegal"] = materialize(jegal_spec(config["jegal"]), seed,
                                   STREAMS["jegal"], device)
    if "xlmr" in config:
        out["xlmr"] = materialize(xlmr_spec(config["xlmr"]), seed,
                                  STREAMS["xlmr"], device)
    return out
