"""JEGAL tri-modal embedding model (the JAX package's models/jegal.py,
reference models/jegal.py:16-420):

  gesture: 1024 -> proj_ip (Linear+LN+ReLU+Linear) -> +PE ->
           6x pre-norm transformer d=512 h=8 -> proj_op_rgb ->
           [inference] proj_op_align_gesture
  text:    XLM-R last_hidden_state -> 3x pre-norm transformer d=768 h=8 ->
           proj_op_text 768->256 -> subword->word mean pooling
  audio:   log-mel (B,T,80) -> 6x conv2d CNN (time/4, freq 80->1) -> 256 ->
           proj_op_audio -> frame->word mean pooling
  fusion:  concat([audio, text]) (or the warned 'avg') -> 512 ->
           proj_op_fusion_content ->
           [inference] proj_op_align_content

A missing content branch is replaced by zeros, as in the reference
(jegal.py:393-402).
"""

from __future__ import annotations

import warnings

import torch

from jegal_torch.config import D_MODEL, NUM_HEADS, PE_MAX_LEN
from jegal_torch.core.layers import (
    batch_norm_nchw,
    conv2d_nchw,
    linear,
    std_layer_norm,
)
from jegal_torch.core.transformer import (
    encoder_stack,
    sinusoidal_position_encoding,
)
from jegal_torch.models import roberta as R
from jegal_torch.ops.pooling import pool_words

# audio CNN: (kernel, stride, padding, has_bn_relu) — reference jegal.py:41-63
AUDIO_CNN_SPEC = (
    dict(k=(5, 5), s=(1, 1), p=(2, 2), bn=True),
    dict(k=(3, 3), s=(2, 2), p=(1, 1), bn=True),
    dict(k=(3, 3), s=(2, 2), p=(1, 1), bn=True),
    dict(k=(3, 3), s=(1, 3), p=(1, 1), bn=True),
    dict(k=(3, 3), s=(1, 3), p=(1, 1), bn=True),
    dict(k=(1, 1), s=(1, 3), p=(0, 0), bn=False),
)
AUDIO_CHANNELS = (1, 32, 64, 128, 256, 256, 256)


def _mlp2(params, x):
    """Linear -> ReLU -> Linear (the align/fusion head shape)."""
    return linear(params[1], torch.relu(linear(params[0], x)))


def forward_gestures(params, visual_feats, visual_mask, fused: bool = True):
    """(B, T, 1024), (B, T) -> (B, T, 512) gesture embeddings (pre-align).
    The PE table extends past the reference's 500 rows with the same
    formula, so long clips work. fused=False runs the encoder's layer loop
    (training: the fused sublayer kernels have no backward)."""
    x = linear(params["proj_ip_rgb"][0], visual_feats)
    x = torch.relu(std_layer_norm(params["proj_ip_ln"], x))
    x = linear(params["proj_ip_rgb"][1], x)
    t = x.shape[1]
    pe = sinusoidal_position_encoding(max(PE_MAX_LEN, t), D_MODEL, x.device)
    x = x + pe[None, :t]
    mask = visual_mask[:, None, :] if visual_mask is not None else None
    x = encoder_stack(params["encoder_rgb"], x, mask, NUM_HEADS, fused=fused)
    return linear(params["proj_op_rgb"], x)


def forward_text(params, roberta_out, text_mask, fused: bool = True):
    """(B, S, 768), (B, S) -> (B, S, 256) subword embeddings. fused as in
    `forward_gestures`."""
    mask = text_mask[:, None, :] if text_mask is not None else None
    x = encoder_stack(params["encoder_text"], roberta_out, mask, NUM_HEADS,
                      fused=fused)
    return linear(params["proj_op_text"], x)


def forward_audio(params, mel, valid_lens=None):
    """(B, T_mel, 80) -> (B, (T_mel-1)//4+1, 256) audio tokens at 25 Hz.

    valid_lens: optional (B,) true mel lengths of a bucket-padded mel. The
    invalid tail is re-zeroed after every layer, so a padded run's valid
    tokens see the conv zero padding a natural-length run sees."""
    x = mel[:, None]                                  # (B, 1, time, freq)
    v = None if valid_lens is None else valid_lens.to(torch.int64)
    for spec, blk in zip(AUDIO_CNN_SPEC, params["cnn"]):
        x = conv2d_nchw(x, blk["conv"]["kernel"], blk["conv"].get("bias"),
                        spec["s"], spec["p"])
        if spec["bn"]:
            x = torch.relu(batch_norm_nchw(blk["bn"], x))
        if v is not None:
            if spec["s"][0] == 2:   # temporal stride halves the valid length
                v = (v - 1) // 2 + 1
            rows = torch.arange(x.shape[2], device=x.device)
            keep = rows[None, None, :, None] < v[:, None, None, None]
            x = torch.where(keep, x, torch.zeros((), device=x.device))
    x = x[:, :, :, 0].transpose(1, 2)                 # freq collapsed to 1
    return linear(params["proj_op_audio"], x)


def fuse_content(params, audio_words, text_words, align: bool,
                 strategy: str = "concat"):
    """Fusion -> MLP (-> align MLP): (B, W, 512). strategy: 'concat' (the
    reference's default, [audio, text] order, jegal.py:319-320) or 'avg'.
    The reference's 'avg' (jegal.py:321-322) is 256-d, which the 512-d
    fusion MLP cannot take; as in the JAX package, the 256-d average is
    tiled twice to 512-d, with a warning that the outputs match no
    reference output."""
    if strategy == "concat":
        content = torch.cat([audio_words, text_words], dim=-1)
    elif strategy == "avg":
        warnings.warn(
            "fusion_strategy='avg' tiles the 256-d average to 512-d; the "
            "reference's 'avg' crashes, so these outputs are not comparable "
            "to any reference output", stacklevel=2)
        avg = (audio_words + text_words) / 2
        content = torch.cat([avg, avg], dim=-1)
    else:
        raise ValueError(f"unknown fusion strategy: {strategy}")
    content = _mlp2(params["proj_op_fusion_content"], content)
    if align:
        content = _mlp2(params["proj_op_align_content"], content)
    return content


def forward_inference(params, roberta_params=None, *, use_v: bool,
                      use_t: bool, use_a: bool, visual_feats=None,
                      visual_mask=None, input_ids=None, text_mask=None,
                      text_pool=None, audio_mel=None, audio_pool=None,
                      audio_valid=None, roberta_cfg=None,
                      fusion_strategy: str = "concat"):
    """Reference forward_inference (models/jegal.py:377-420) for the seven
    combos of v, t and a. text_pool / audio_pool: (B, W, S) / (B, W,
    T_audio) pooling matrices (ops/pooling.py); fusion_strategy as
    `fuse_content`'s strategy. -> (gesture_emb | None, content_emb |
    None)."""
    if not (use_v or use_t or use_a):
        raise ValueError("forward_inference needs at least one modality")
    gesture = None
    if use_v:
        g = forward_gestures(params, visual_feats, visual_mask)
        gesture = _mlp2(params["proj_op_align_gesture"], g)
        if not (use_t or use_a):
            return gesture, None
    text_words = audio_words = None
    if use_t:
        hidden = R.forward(roberta_params, input_ids, text_mask,
                           roberta_cfg or R.XLMR_BASE)
        text_words = pool_words(text_pool,
                                forward_text(params, hidden, text_mask))
    if use_a:
        audio_words = pool_words(audio_pool,
                                 forward_audio(params, audio_mel, audio_valid))
    if text_words is None:
        text_words = torch.zeros_like(audio_words)
    if audio_words is None:
        audio_words = torch.zeros_like(text_words)
    return gesture, fuse_content(params, audio_words, text_words, align=True,
                                 strategy=fusion_strategy)
