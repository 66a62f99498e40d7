"""GestSync visual tower (jegal_tpu/models/gestsync.py), frozen feature
extractor: a 6-block 3-D VGG over masked RGB frames, sinusoidal PE, a
6-layer post-norm window transformer (d=512, h=8) and a 512->512->1024
head (reference models/gestsync.py:7-162).

Shared-conv windowing, as in the JAX package: every temporal conv has
stride 1 and only block 1 has a temporal extent (k_t=5), so the conv tower
runs ONCE over the whole (T+24)-frame padded sequence and window w (frames
[w, w+25)) reads conv tokens [w, w+21). The tower runs in 160-frame chunks
with a 4-frame halo, which bounds activation memory for long clips.

Block 1 is the fused stem (ops/kernels/stem.py: the CUDA kernel on the
card, its plain twin on the CPU). Blocks 2-6 have k_t=1, so they run as
plain 2-D convolutions with frames as the batch, in channels-first layout
— in the JAX package they are XLA, not Pallas (block 2 is
`mgrid_conv2_dense` by default). The window transformer runs through
core/transformer.torch_encoder_stack (fused sublayer kernels on the card);
its ff1/ff2 head is two torch.matmul calls, as JAX leaves it to XLA.

Input: (T + 24, 270, 480, 3) float32 frames in [0, 1], masked and
edge-padded (ops/video.mask_frames_device). Output: (T, 1024).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jegal_torch.config import D_MODEL, EDGE_PAD_FRAMES, NUM_HEADS, WINDOW
from jegal_torch.core.layers import batch_norm_nchw, conv2d_nchw, linear
from jegal_torch.core.transformer import (
    sinusoidal_position_encoding,
    torch_encoder_stack,
)
from jegal_torch.ops.kernels.stem import stem_kernel_params, stem_pool

# (kernel, stride, padding, maxpool) per VGG block — reference
# models/gestsync.py:34-87. Channels: 3->64->128->256->256->256->512.
VGG_SPEC = (
    dict(k=(5, 7, 7), s=(1, 3, 3), p=(0, 0, 0), mp=((1, 3, 3), (1, 2, 2))),
    dict(k=(1, 5, 5), s=(1, 2, 2), p=(0, 0, 0), mp=None),
    dict(k=(1, 3, 3), s=(1, 2, 2), p=(0, 1, 1), mp=None),
    dict(k=(1, 3, 3), s=(1, 1, 2), p=(0, 1, 1), mp=None),
    dict(k=(1, 3, 3), s=(1, 1, 1), p=(0, 1, 1), mp=((1, 3, 3), (1, 2, 2))),
    dict(k=(1, 4, 4), s=(1, 1, 1), p=(0, 0, 0), mp=None),  # fc3d block
)
CHANNELS = (3, 64, 128, 256, 256, 256, 512)

TOKENS = WINDOW - 4          # conv tokens per window: 25 - (5 - 1)
EDGE_PAD = EDGE_PAD_FRAMES
D_OUT = 1024


def _tower_piece(params, stem_ops, piece):
    """(n + 4, H, W, 3) frames -> (n, 512) conv tokens."""
    x = stem_pool(piece, *stem_ops).permute(0, 3, 1, 2)   # (n, 64, J, Wp)
    for spec, blk in zip(VGG_SPEC[1:], params["net_vid"][1:]):
        x = conv2d_nchw(x, blk["conv"]["kernel"][0], blk["conv"].get("bias"),
                        spec["s"][1:], spec["p"][1:])
        x = torch.relu(batch_norm_nchw(blk["bn"], x))
        if spec["mp"] is not None:
            x = F.max_pool2d(x, spec["mp"][0][1:], spec["mp"][1][1:])
    return x[:, :, 0, 0]


def vgg_tower(params, x):
    """6-block conv tower, x: (B, D, H, W, 3) -> (B, D - 4, 1, 1, 512)."""
    ops = stem_kernel_params(params["net_vid"][0])
    out = torch.stack([_tower_piece(params, ops, clip) for clip in x])
    return out[:, :, None, None, :]


def conv_tokens(params, frames, chunk: int = 160):
    """The conv tower once over the padded sequence, in `chunk`-frame
    pieces with a 4-frame halo: frames (T_pad, H, W, 3) -> (T_pad - 4, 512).
    Every block after the stem is per-frame, so chunking is exact."""
    t_out = frames.shape[0] - 4
    ops = stem_kernel_params(params["net_vid"][0])
    return torch.cat([
        _tower_piece(params, ops, frames[s:min(s + chunk, t_out) + 4])
        for s in range(0, t_out, chunk)])


def _window_stack(tokens):
    """tokens (T + 20, 512) -> PE-added windows (T, 21, 512)."""
    wins = tokens.unfold(0, TOKENS, 1).transpose(1, 2)
    pe = sinusoidal_position_encoding(50, D_MODEL, tokens.device)[:TOKENS]
    return wins + pe


def window_head(params, tokens):
    """Per-window transformer + head over sliding 21-token windows:
    (T + 20, 512) -> (T, 1024), the mean over each window's 21 head
    outputs (reference inference_embs.py:510-511)."""
    h = torch_encoder_stack(params["transformer"], _window_stack(tokens),
                            None, NUM_HEADS)
    h = linear(params["ff2"], torch.relu(linear(params["ff1"], h)))
    return h.mean(dim=1)


def extract_features(params, frames, chunk: int = 160):
    """Masked, edge-padded frames (T + 24, 270, 480, 3) -> (T, 1024)."""
    return window_head(params, conv_tokens(params, frames, chunk=chunk))


def forward_vid_windowed(params, clips):
    """Reference-exact per-window path, the oracle of the shared-conv path:
    clips (B, 25, 270, 480, 3) -> (B, 1024, 21) like reference forward_vid
    (models/gestsync.py:148-162)."""
    x = vgg_tower(params, clips)[:, :, 0, 0, :]                # (B, 21, 512)
    x = x + sinusoidal_position_encoding(50, D_MODEL, x.device)[:x.shape[1]]
    x = torch_encoder_stack(params["transformer"], x, None, NUM_HEADS)
    x = linear(params["ff2"], torch.relu(linear(params["ff1"], x)))
    return x.transpose(1, 2)
