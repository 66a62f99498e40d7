"""GestSync visual tower (jegal_tpu/models/gestsync.py), frozen feature
extractor: a 6-block 3-D VGG over masked RGB frames, sinusoidal PE, a
6-layer post-norm window transformer (d=512, h=8) and a 512->512->1024
head (reference models/gestsync.py:7-162).

Shared-conv windowing, as in the JAX package: every temporal conv has
stride 1 and only block 1 has a temporal extent (k_t=5), so the conv tower
runs ONCE over the whole (T+24)-frame padded sequence and window w (frames
[w, w+25)) reads conv tokens [w, w+21). The tower runs in 160-frame pieces
with a 4-frame halo, which bounds activation memory for long clips.

`_tower_piece` is the one tower body (the JAX package's
`_make_stem_chunk_fn`), shared by the single-clip and batched entries, on
either input: float frames in [0, 1], masked and edge-padded
(ops/video.mask_frames_device), or host-repacked planar uint8
(ops/video.s2d_repack), edge-padded here. Block 1 is the fused stem
(ops/kernels/stem.py), `stem_impl` "band" (the default) or "window".
Block 2 is cuDNN's convolution with `conv2_impl="dense"` (the default, the
counterpart of the JAX package's `mgrid_conv2_dense`) or the fused block-2
kernel with "kernel" (ops/kernels/conv2.py), which raises for a stem output
smaller than its 5x5 window rather than running cuDNN instead. Blocks 3-6 have
k_t=1, so they run as plain 2-D convolutions with frames as the batch, in
channels-first layout — in the JAX package they are XLA, not Pallas. On a
CPU tensor every kernel is its plain twin. The window transformer runs
through core/transformer.torch_encoder_stack (fused sublayer kernels on the
card); its ff1/ff2 head is two torch.matmul calls, as JAX leaves it to XLA.

Output: (T, 1024) a clip, (B, T, 1024) from the batched entries.

The reference checkpoint also holds an audio sync branch (`net_aud`,
`ff_aud`, reference models/gestsync.py:23-32,89-168), which the gesture
pipeline never runs: `forward_aud` computes it (cuDNN convolutions, as the
JAX package leaves it to XLA), and `params_from_torch` keeps it when the
state dict has it. The LSTM head is dead weight in the reference too and
is not converted.
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
from jegal_torch.ops.kernels.conv2 import conv2_bn_relu, conv2_kernel_params
from jegal_torch.ops.kernels.stem import (
    stem_kernel_params,
    stem_pool,
    stem_pool_planar,
)
from jegal_torch.ops.video import edge_pad, mask_frames_device

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
CONV2_IMPLS = ("dense", "kernel")       # block 2: cuDNN, or csrc/conv2.cu


def param_dtype(params):
    """The tower's compute dtype: its parameters' (the engine casts every
    floating leaf once, as the JAX engine does)."""
    return params["net_vid"][0]["conv"]["kernel"].dtype


def tower_ops(params):
    """Block 1's and block 2's folded kernel operands, once per call of an
    entry point: (stem_kernel_params, conv2_kernel_params)."""
    return (stem_kernel_params(params["net_vid"][0]),
            conv2_kernel_params(params["net_vid"][1]))


def _tower_piece(params, ops, piece, planar: bool = False,
                 stem_impl: str = "band", conv2_impl: str = "dense"):
    """(n + 4, H, W, 3) float frames, or (n + 4, H3, 27, W3) planar uint8
    with planar=True -> (n, 512) conv tokens."""
    if conv2_impl not in CONV2_IMPLS:
        raise ValueError(f"conv2_impl must be one of {CONV2_IMPLS}, got "
                         f"{conv2_impl!r}")
    stem_ops, c2_ops = ops
    stem = stem_pool_planar if planar else stem_pool
    y = stem(piece, *stem_ops, impl=stem_impl)            # (n, J, Wp, 64)
    blocks = list(zip(VGG_SPEC[1:], params["net_vid"][1:]))
    if conv2_impl == "kernel":
        y = conv2_bn_relu(y, *c2_ops)                     # (n, J2, W2, 128)
        blocks = blocks[1:]
    x = y.permute(0, 3, 1, 2)
    for spec, blk in blocks:
        x = conv2d_nchw(x, blk["conv"]["kernel"][0], blk["conv"].get("bias"),
                        spec["s"][1:], spec["p"][1:])
        x = torch.relu(batch_norm_nchw(blk["bn"], x))
        if spec["mp"] is not None:
            x = F.max_pool2d(x, spec["mp"][0][1:], spec["mp"][1][1:])
    return x[:, :, 0, 0]


def vgg_tower(params, x):
    """6-block conv tower, x: (B, D, H, W, 3) -> (B, D - 4, 1, 1, 512)."""
    ops = tower_ops(params)
    out = torch.stack([_tower_piece(params, ops, clip) for clip in x])
    return out[:, :, None, None, :]


def conv_tokens(params, frames, chunk: int = 160, planar: bool = False,
                stem_impl: str = "band", conv2_impl: str = "dense",
                ops=None):
    """The conv tower once over the padded sequence, in `chunk`-frame
    pieces with a 4-frame halo: frames (T_pad, H, W, 3), or planar uint8
    (T_pad, H3, 27, W3) with planar=True -> (T_pad - 4, 512). Every block
    after the stem is per-frame, so chunking is exact."""
    t_out = frames.shape[0] - 4
    ops = tower_ops(params) if ops is None else ops
    return torch.cat([
        _tower_piece(params, ops, frames[s:min(s + chunk, t_out) + 4],
                     planar, stem_impl, conv2_impl)
        for s in range(0, t_out, chunk)])


def _window_stack(tokens):
    """tokens (..., T + 20, 512) -> PE-added windows (..., T, 21, 512)."""
    wins = tokens.unfold(-2, TOKENS, 1).transpose(-1, -2)
    pe = sinusoidal_position_encoding(50, D_MODEL, tokens.device)[:TOKENS]
    return wins + pe.to(tokens.dtype)


def _window_head_flat(params, wins):
    """Per-window transformer + head: (N, 21, 512) -> (N, 1024), the mean
    over each window's 21 head outputs (reference
    inference_embs.py:510-511)."""
    h = torch_encoder_stack(params["transformer"], wins, None, NUM_HEADS)
    h = linear(params["ff2"], torch.relu(linear(params["ff1"], h)))
    return h.mean(dim=1)


def window_head(params, tokens):
    """Sliding 21-token windows of a clip's tokens: (T + 20, 512) ->
    (T, 1024)."""
    return _window_head_flat(params, _window_stack(tokens))


def extract_features(params, frames, chunk: int = 160,
                     stem_impl: str = "band", conv2_impl: str = "dense"):
    """Masked, edge-padded frames (T + 24, 270, 480, 3) -> (T, 1024)."""
    return window_head(params, conv_tokens(
        params, frames, chunk=chunk, stem_impl=stem_impl,
        conv2_impl=conv2_impl))


def extract_features_planar(params, planar_u8, chunk: int = 160,
                            stem_impl: str = "band",
                            conv2_impl: str = "dense"):
    """Host-repacked planar uint8 frames (T, H3, 27, W3), masked but not
    edge-padded (ops/video.s2d_repack) -> (T, 1024). The +/-12 edge pad
    happens here in uint8 and the stem reads the bytes."""
    return window_head(params, conv_tokens(
        params, edge_pad(planar_u8), chunk=chunk, planar=True,
        stem_impl=stem_impl, conv2_impl=conv2_impl))


def conv_tokens_batch(params, frames, chunk: int = 160, planar: bool = False,
                      stem_impl: str = "band", conv2_impl: str = "dense"):
    """Cross-clip conv tower: frames (B, T_pad, ...) of one form ->
    (B, T_pad - 4, 512), clip by clip and piece by piece (the JAX package
    maps the same (clip, piece) units)."""
    ops = tower_ops(params)
    return torch.stack([
        conv_tokens(params, clip, chunk=chunk, planar=planar,
                    stem_impl=stem_impl, conv2_impl=conv2_impl, ops=ops)
        for clip in frames])


def _batch_tokens_to_feats(params, tokens):
    """Shared tail of the batched entries: (B, T + 20, 512) tokens -> one
    window head over all B * T windows -> (B, T, 1024)."""
    wins = _window_stack(tokens)                         # (B, T, 21, 512)
    b, t = wins.shape[:2]
    return _window_head_flat(params, wins.reshape(b * t, TOKENS, D_MODEL)) \
        .reshape(b, t, D_OUT)


def extract_features_batch(params, frames, chunk: int = 160,
                           stem_impl: str = "band",
                           conv2_impl: str = "dense"):
    """Masked, edge-padded frames (B, T + 24, 270, 480, 3) -> (B, T,
    1024), one window head for the batch."""
    return _batch_tokens_to_feats(params, conv_tokens_batch(
        params, frames, chunk=chunk, stem_impl=stem_impl,
        conv2_impl=conv2_impl))


def extract_features_batch_raw(params, frames_u8, cut, chunk: int = 160,
                               stem_impl: str = "band",
                               conv2_impl: str = "dense"):
    """Raw decoder frames (B, T, 270, 480, 3) uint8 and chin rows (B, T)
    -> (B, T, 1024). Each clip is masked and edge-padded on its own
    (mask_frames_device), so one clip's float frames are alive at a time."""
    ops = tower_ops(params)
    dt = param_dtype(params)
    tokens = torch.stack([
        conv_tokens(params, mask_frames_device(clip, c, dt), chunk=chunk,
                    stem_impl=stem_impl, conv2_impl=conv2_impl, ops=ops)
        for clip, c in zip(frames_u8, cut)])
    return _batch_tokens_to_feats(params, tokens)


def extract_features_batch_planar(params, planar_u8, chunk: int = 160,
                                  stem_impl: str = "band",
                                  conv2_impl: str = "dense"):
    """Host-repacked planar uint8 (B, T, H3, 27, W3), masked but not
    edge-padded -> (B, T, 1024)."""
    ops = tower_ops(params)
    tokens = torch.stack([
        conv_tokens(params, edge_pad(clip), chunk=chunk, planar=True,
                    stem_impl=stem_impl, conv2_impl=conv2_impl, ops=ops)
        for clip in planar_u8])
    return _batch_tokens_to_feats(params, tokens)


def shard_batch_tower(fn, mesh):
    """The data-parallel contract of the batched tower entries (the JAX
    package's shard_map over 'data'): wrap fn(params, frames (B, ...), cut
    (B, T) | None) -> (B, T, 1024) so that each rank runs it on its rows
    [d B / dp, (d + 1) B / dp) alone, with the params replicated, and the
    rows are gathered over 'data' (parallel/mesh.gather_rows), every rank
    returning the whole (B, T, 1024). Clips are independent, so the tower
    itself needs no collective. B must be a multiple of dp, else
    ValueError. The one wrapper of the raw and planar entries, so their
    row specs cannot diverge; fn itself without a mesh."""
    from jegal_torch.parallel import mesh as M

    if mesh is None:
        return fn

    def sharded(params, frames, cut=None):
        rows = M.batch_rows(frames.shape[0], mesh)
        return M.gather_rows(fn(params, frames[rows],
                                None if cut is None else cut[rows]), mesh)

    return sharded


def extract_features_batch_raw_sharded(params, frames_u8, cut, mesh,
                                       chunk: int = 160,
                                       stem_impl: str = "band",
                                       conv2_impl: str = "dense"):
    """extract_features_batch_raw with the clips over 'data'
    (shard_batch_tower)."""
    def fn(p, frames, c):
        return extract_features_batch_raw(p, frames, c, chunk=chunk,
                                          stem_impl=stem_impl,
                                          conv2_impl=conv2_impl)

    return shard_batch_tower(fn, mesh)(params, frames_u8, cut)


def extract_features_batch_planar_sharded(params, planar_u8, mesh,
                                          chunk: int = 160,
                                          stem_impl: str = "band",
                                          conv2_impl: str = "dense"):
    """extract_features_batch_planar with the clips over 'data'
    (shard_batch_tower)."""
    def fn(p, frames, _):
        return extract_features_batch_planar(p, frames, chunk=chunk,
                                             stem_impl=stem_impl,
                                             conv2_impl=conv2_impl)

    return shard_batch_tower(fn, mesh)(params, planar_u8)


def forward_vid_windowed(params, clips):
    """Reference-exact per-window path, the oracle of the shared-conv path:
    clips (B, 25, 270, 480, 3) -> (B, 1024, 21) like reference forward_vid
    (models/gestsync.py:148-162)."""
    x = vgg_tower(params, clips)[:, :, 0, 0, :]                # (B, 21, 512)
    x = x + sinusoidal_position_encoding(
        50, D_MODEL, x.device)[:x.shape[1]].to(x.dtype)
    x = torch_encoder_stack(params["transformer"], x, None, NUM_HEADS)
    x = linear(params["ff2"], torch.relu(linear(params["ff1"], x)))
    return x.transpose(1, 2)


# ---------------------------------------------------------------------------
# Audio sync branch (in the reference checkpoint, unused by the gesture
# pipeline; reference models/gestsync.py:89-168)
# ---------------------------------------------------------------------------

AUD_SPEC = (
    dict(k=(3, 3), s=(2, 2), p=(1, 1), mp=((3, 3), (2, 2))),
    dict(k=(3, 3), s=(1, 2), p=(1, 1), mp=((3, 3), (2, 2))),
    dict(k=(3, 3), s=(1, 1), p=(1, 1), mp=None),
    dict(k=(3, 3), s=(1, 1), p=(1, 1), mp=None),
    dict(k=(3, 3), s=(1, 1), p=(1, 1), mp=((2, 3), (2, 2))),
    dict(k=(4, 2), s=(1, 1), p=(0, 0), mp=None),  # fc2d block
)
AUD_CHANNELS = (1, 64, 192, 384, 256, 256, 512)


def aud_feature_map(params, x):
    """Audio sync branch before the squeeze: x (B, F, T, 1) NHWC -> the
    NCHW map (B, 1024, F', T') of the reference's net_aud -> NetFC_2D
    (models/gestsync.py:164-167), channels-first inside. F 80 gives F' 1;
    the reference's 100-frame window gives T' 1."""
    x = x.permute(0, 3, 1, 2)
    for spec, blk in zip(AUD_SPEC, params["net_aud"]):
        x = conv2d_nchw(x, blk["conv"]["kernel"], blk["conv"].get("bias"),
                        spec["s"], spec["p"])
        x = torch.relu(batch_norm_nchw(blk["bn"], x))
        if spec["mp"] is not None:
            x = F.max_pool2d(x, spec["mp"][0], spec["mp"][1])
    # NetFC_2D head: 1x1 convs 512 -> 512 -> 1024, BN and ReLU between
    ff = params["ff_aud"]
    x = conv2d_nchw(x, ff["fc7"]["kernel"], ff["fc7"].get("bias"))
    x = torch.relu(batch_norm_nchw(ff["bn7"], x))
    return conv2d_nchw(x, ff["fc8"]["kernel"], ff["fc8"].get("bias"))


def forward_aud(params, x):
    """x (B, F, T, 1) NHWC -> (B, 1024, F'), F' 1 for 80 mel bins: the
    reference forward_aud (models/gestsync.py:164-168) on its 100-frame
    window, where T' is 1. At other T the reference's squeeze(-1) keeps
    all T' columns; this keeps the first, as the JAX package does
    (x[:, :, 0, :] in NHWC)."""
    return aud_feature_map(params, x)[:, :, :, 0]


# ---------------------------------------------------------------------------
# Checkpoint conversion
# ---------------------------------------------------------------------------

def params_from_torch(sd):
    """The reference GestSync state dict (DataParallel-prefixed torch .pth,
    reference inference_embs.py:92-119) -> the port's tree; `net_aud` and
    `ff_aud` when the state dict has the audio branch. The LSTM and
    logits_scale entries are skipped."""
    from jegal_torch.convert import torch_import as TI

    sd = TI.strip_module_prefix(sd)

    def blocks(branch, conv):
        names = [f"conv{i}" for i in range(1, 6)] + ["fc6"]
        return [{"conv": conv(sd, f"{branch}.{name}"),
                 "bn": TI.batch_norm_from_torch(sd, f"{branch}.bn{i}")}
                for i, name in enumerate(names, start=1)]

    params = {
        "net_vid": blocks("net_vid", TI.conv3d_from_torch),
        "transformer": TI.torch_encoder_stack_from_torch(
            sd, "transformer_encoder", 6),
        "ff1": TI.linear_from_torch(sd, "ff_vid.0"),
        "ff2": TI.linear_from_torch(sd, "ff_vid.2"),
    }
    if "net_aud.conv1.weight" in sd:
        params["net_aud"] = blocks("net_aud", TI.conv2d_from_torch)
        params["ff_aud"] = {
            "fc7": TI.conv2d_from_torch(sd, "ff_aud.fc7"),
            "bn7": TI.batch_norm_from_torch(sd, "ff_aud.bn7"),
            "fc8": TI.conv2d_from_torch(sd, "ff_aud.fc8"),
        }
    return params
