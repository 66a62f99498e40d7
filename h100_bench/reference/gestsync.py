"""Plain float32 reference of the GestSync visual tower with its window
head (reference models/gestsync.py and inference_embs.py: frames /255,
masked, edge-padded +/-12; conv3d blocks with bias, BatchNorm, ReLU and
max pools; each window of 25 frames -> 21 conv tokens + the sinusoidal
table -> 6 post-norm layers -> ff1, ReLU, ff2 -> the mean over the 21
outputs).

The conv tower runs once over the padded clip (every block after the
first has a temporal extent of 1, so window w's tokens are conv tokens
[w, w + 21) of the whole clip: the same numbers as the reference's window
by window tower) in pieces of PIECE output frames, to bound memory."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100_bench.lib.repack import s2d_unpack_torch
from h100_bench.reference import common as C

PIECE = 64


def _tokens(gp, g: dict, frames):
    """frames (T_pad, H, W, 3) float32 in [0, 1] -> (T_pad - k_t + 1, C)
    conv tokens."""
    k_t = g["kernels"][0][0]
    t_out = frames.shape[0] - k_t + 1
    out = []
    for s in range(0, t_out, PIECE):
        x = frames[s:min(s + PIECE, t_out) + k_t - 1]
        x = x.permute(3, 0, 1, 2)[None]                  # (1, 3, D, H, W)
        for i, blk in enumerate(gp["net_vid"]):
            x = C.conv3d(blk["conv"], x, g["strides"][i], g["padding"][i])
            x = torch.relu(C.batch_norm(blk["bn"], x))
            pool = g["pools"][i]
            if pool is not None:
                x = F.max_pool3d(x, tuple(pool[0]), tuple(pool[1]))
        out.append(x[0, :, :, 0, 0].transpose(0, 1))
    return torch.cat(out)


def features(gp, g: dict, planar_u8):
    """A clip's planar uint8 frames (T, H/3, 27, W/3) on the device,
    already masked -> (T, d_out) GestSync features."""
    raw = s2d_unpack_torch(planar_u8).to(torch.float32) / 255.0
    pad = g["edge_pad"]
    frames = torch.cat([raw[:1].expand(pad, *raw.shape[1:]), raw,
                        raw[-1:].expand(pad, *raw.shape[1:])])
    tokens = _tokens(gp, g, frames)                      # (T + 20, d)
    n_tok = g["window"] - g["kernels"][0][0] + 1
    wins = tokens.unfold(0, n_tok, 1).transpose(1, 2)    # (T, 21, d)
    x = wins + C.sinusoid(g["pe_rows"], g["d_model"], wins.device)[:n_tok]
    for layer in gp["transformer"]["layers"]:
        x = C.post_norm_layer(layer, x, g["num_heads"])
    h = C.linear(gp["ff2"], torch.relu(C.linear(gp["ff1"], x)))
    return h.mean(dim=1)


def run(weights: dict, config: dict, clip: dict, device) -> dict:
    """The reference's outputs for one clip of a tower mix."""
    planar = torch.from_numpy(clip["frames"]).to(device)
    return {"features": features(weights["gestsync"], config["gestsync"],
                                 planar)}
