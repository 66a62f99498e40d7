"""Reference-format state dicts for the port's checkpoint tests, with
neither JAX nor the JAX package imported.

`*_state_dict(tree)` write a parameter tree in the JAX layouts (numpy or
torch leaves) as the reference's torch modules name and lay out their
weights: (out, in) Linear weights, OIHW / OIDHW conv weights, BatchNorm
running statistics with `num_batches_tracked`, the reference's a_2 / b_2
LayerNorms and annotated `linears.{0-3}` MHA in JEGAL, torch's fused
`in_proj` MHA in GestSync's nn.TransformerEncoder, the audio CNN's
nn.Sequential indices (BatchNorm and ReLU counted), and nn.DataParallel's
`module.` prefix; GestSync's LSTM and logits_scale and HF's pooler, which
the converters skip, are written too. `redraw(tree, rng)` gives a tree of
the same shapes with every leaf drawn from a numpy Generator (BatchNorm
variances positive), so that converting a state dict written from it back
is held to the exact leaves written.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def redraw(tree, rng: np.random.Generator, _key: str = ""):
    """A tree of `tree`'s structure and shapes, every leaf drawn anew:
    BatchNorm variances from U[0.5, 1.5], all else N(0, 0.1^2) (numpy
    float32)."""
    if isinstance(tree, dict):
        return {k: redraw(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [redraw(v, rng) for v in tree]
    shape = tuple(tree.shape)
    if _key == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


class _Writer:
    def __init__(self, prefix: str):
        self.prefix, self.sd = prefix, {}

    def put(self, name: str, value):
        self.sd[self.prefix + name] = _t(value)

    def linear(self, name, p):
        self.put(f"{name}.weight", _t(p["kernel"]).T)
        if "bias" in p:
            self.put(f"{name}.bias", p["bias"])

    def norm(self, name, p, annotated: bool = False):
        w, b = ("a_2", "b_2") if annotated else ("weight", "bias")
        self.put(f"{name}.{w}", p["scale"])
        self.put(f"{name}.{b}", p["bias"])

    def batch_norm(self, name, p):
        self.norm(name, p)
        self.put(f"{name}.running_mean", p["mean"])
        self.put(f"{name}.running_var", p["var"])
        self.sd[f"{self.prefix}{name}.num_batches_tracked"] = torch.tensor(7)

    def conv(self, name, p):
        k = _t(p["kernel"])                        # HWIO or DHWIO
        self.put(f"{name}.weight", k.permute(-1, -2, *range(k.dim() - 2)))
        if "bias" in p:
            self.put(f"{name}.bias", p["bias"])


def gestsync_state_dict(tree, prefix: str = "module."):
    """A GestSync tree (`net_vid`, `transformer`, `ff1`, `ff2`, and
    `net_aud` / `ff_aud` when it has them) -> the reference checkpoint's
    state dict."""
    w = _Writer(prefix)
    branches = [("net_vid", tree["net_vid"])]
    if "net_aud" in tree:
        branches.append(("net_aud", tree["net_aud"]))
    for branch, blocks in branches:
        for i, blk in enumerate(blocks, start=1):
            w.conv(f"{branch}.{'fc6' if i == 6 else f'conv{i}'}", blk["conv"])
            w.batch_norm(f"{branch}.bn{i}", blk["bn"])
    for i, layer in enumerate(tree["transformer"]["layers"]):
        lp = f"transformer_encoder.layers.{i}"
        att = layer["attn"]
        w.put(f"{lp}.self_attn.in_proj_weight", torch.cat(
            [_t(att[n]["kernel"]).T for n in ("q", "k", "v")]))
        w.put(f"{lp}.self_attn.in_proj_bias", torch.cat(
            [_t(att[n]["bias"]) for n in ("q", "k", "v")]))
        w.linear(f"{lp}.self_attn.out_proj", att["o"])
        w.linear(f"{lp}.linear1", layer["ff"]["w1"])
        w.linear(f"{lp}.linear2", layer["ff"]["w2"])
        w.norm(f"{lp}.norm1", layer["norm1"])
        w.norm(f"{lp}.norm2", layer["norm2"])
    w.linear("ff_vid.0", tree["ff1"])
    w.linear("ff_vid.2", tree["ff2"])
    if "ff_aud" in tree:
        w.conv("ff_aud.fc7", tree["ff_aud"]["fc7"])
        w.batch_norm("ff_aud.bn7", tree["ff_aud"]["bn7"])
        w.conv("ff_aud.fc8", tree["ff_aud"]["fc8"])
    # entries the converters skip
    w.put("logits_scale.weight", np.ones((1, 1), np.float32))
    w.put("lstm.weight_ih_l0", np.zeros((8, 4), np.float32))
    return w.sd


def _annotated_stack(w: _Writer, name: str, stack):
    for i, layer in enumerate(stack["layers"]):
        lp = f"{name}.layers.{i}"
        for j, n in enumerate(("q", "k", "v", "o")):
            w.linear(f"{lp}.self_attn.linears.{j}", layer["attn"][n])
        w.linear(f"{lp}.feed_forward.w_1", layer["ff"]["w1"])
        w.linear(f"{lp}.feed_forward.w_2", layer["ff"]["w2"])
        w.norm(f"{lp}.sublayer.0.norm", layer["norm1"], annotated=True)
        w.norm(f"{lp}.sublayer.1.norm", layer["norm2"], annotated=True)
    w.norm(f"{name}.norm", stack["norm"], annotated=True)


def jegal_state_dict(tree, prefix: str = "module."):
    """A JEGAL tree -> the reference checkpoint's state dict."""
    w = _Writer(prefix)
    w.linear("proj_ip_rgb.0", tree["proj_ip_rgb"][0])
    w.norm("proj_ip_rgb.1", tree["proj_ip_ln"])
    w.linear("proj_ip_rgb.3", tree["proj_ip_rgb"][1])
    _annotated_stack(w, "encoder_rgb", tree["encoder_rgb"])
    _annotated_stack(w, "encoder_text", tree["encoder_text"])
    w.linear("proj_op_rgb", tree["proj_op_rgb"])
    w.linear("proj_op_text", tree["proj_op_text"])
    seq = 0
    for blk in tree["cnn"]:
        w.conv(f"cnn.{seq}", blk["conv"])
        seq += 1
        if "bn" in blk:
            w.batch_norm(f"cnn.{seq}", blk["bn"])
            seq += 2                                # BatchNorm, ReLU
    w.linear("proj_op_audio", tree["proj_op_audio"])
    for name in ("proj_op_fusion_content", "proj_op_align_gesture",
                 "proj_op_align_content"):
        w.linear(f"{name}.0", tree[name][0])
        w.linear(f"{name}.2", tree[name][1])
    return w.sd


def roberta_hf_state_dict(tree, prefix: str = "roberta.",
                          pooler: bool = True):
    """An XLM-R tree -> an HF XLMRobertaModel state dict, its keys under
    `prefix` ("" for a bare model), with a pooler if asked."""
    w = _Writer(prefix)
    emb = tree["embeddings"]
    w.put("embeddings.word_embeddings.weight", emb["word"])
    w.put("embeddings.position_embeddings.weight", emb["position"])
    w.put("embeddings.token_type_embeddings.weight", emb["token_type"])
    w.norm("embeddings.LayerNorm", emb["ln"])
    for i, layer in enumerate(tree["layers"]):
        p = f"encoder.layer.{i}"
        for key, name in (("q", "attention.self.query"),
                          ("k", "attention.self.key"),
                          ("v", "attention.self.value"),
                          ("attn_out", "attention.output.dense"),
                          ("inter", "intermediate.dense"),
                          ("out", "output.dense")):
            w.linear(f"{p}.{name}", layer[key])
        w.norm(f"{p}.attention.output.LayerNorm", layer["attn_ln"])
        w.norm(f"{p}.output.LayerNorm", layer["out_ln"])
    if pooler:
        d = _t(emb["word"]).shape[1]
        w.linear("pooler.dense", {"kernel": np.eye(d, dtype=np.float32),
                                  "bias": np.zeros(d, np.float32)})
    return w.sd
