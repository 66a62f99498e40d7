"""The operation and byte counts against hand counts at small shapes."""

from __future__ import annotations

import json

import pytest

from h100_bench.lib import peaks
from h100_bench.lib.counts import encoders, model, stem
from h100_bench.tests.conftest import BENCH


def test_stem_at_a_small_frame():
    # 30 x 33 frames: conv 8 x 9, pooled 3 x 4; the pool reads 7 x 9
    assert stem.pooled_shape(6, 30, 33) == (2, 3, 4, 64)
    assert stem.flops(6, 30, 33) == 2 * 2 * 7 * 9 * 64 * 5 * 7 * 7 * 3
    assert stem.nbytes(6, 30, 33) == (6 * 30 * 33 * 3 + 4 * (5 * 7 * 7 * 3
                                                           * 64 + 128)
                                      + 4 * 2 * 3 * 4 * 64)


def test_stem_at_the_decoder_frame():
    # 270 x 480: conv 88 x 158, pooled 43 x 78, the pool reads 87 x 157
    assert stem.pooled_shape(152, 270, 480) == (148, 43, 78, 64)
    assert stem.flops(5) == 2 * 87 * 157 * 64 * 735


def test_encoder_sublayers():
    r, d, seg, dff = 6, 4, 3, 8
    ops, nbytes = encoders.attn(r, d, seg, True)
    assert ops == 2 * 6 * 4 * 12 + 4 * 6 * 3 * 4 + 2 * 6 * 4 * 4
    assert nbytes == 4 * (2 * 24 + 48 + 12 + 16 + 4 + 8 + 6)
    ops, nbytes = encoders.ffn(r, d, dff)
    assert ops == 2 * 6 * 4 * 8 * 2
    assert nbytes == 4 * (2 * 24 + 64 + 8 + 4 + 8)
    s_ops, s_bytes = encoders.stack(r, d, dff, seg, 2, False)
    assert s_ops == 2 * (encoders.attn(r, d, seg, False)[0]
                         + encoders.ffn(r, d, dff)[0])
    layer_w = (48 + 12 + 16 + 4 + 8) + (64 + 8 + 4 + 8)
    assert s_bytes == 4 * (2 * 24 + 2 * layer_w)


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(495e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(495e12, 6.7e12) == pytest.approx(2.0)


def test_model_counts_grow_with_the_clip():
    cfg = json.loads((BENCH / "configs" / "jegal-xlmr-base.json").read_text())
    g = cfg["gestsync"]
    # the tower dominates: ~2.9 GFLOP a frame at T 160
    per_frame = model.tower_flops(g, 160) / 160
    assert 2.5e9 < per_frame < 3.5e9
    one = model.jegal_flops(cfg, 100, 20, 10, 400)
    assert one > model.tower_flops(g, 100)
    # the +/-12 edge pad is paid once a clip
    assert 1.8 * one < model.jegal_flops(cfg, 200, 40, 20, 800) < 2 * one
