"""A clip's model operations at its natural length (no bucket or batch
padding), from the configuration's sizes: what `mfu` divides by the
window and the peak. Products and convolutions are counted (a multiply-add
is two operations); norms, activations, softmax and pooling's means are
left out. The host's log-mel is not model work on the card and is not
counted."""

from __future__ import annotations

from . import stem


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def layer_flops(tokens: int, seg: int, d: int, dff: int) -> float:
    """One encoder layer over `tokens` rows in segments of `seg`."""
    return 2.0 * tokens * (4 * d * d + 2 * d * dff) + 4.0 * tokens * seg * d


def tower_flops(g: dict, t: int) -> float:
    """The GestSync tower and window head for a T-frame clip: the stem on
    the edge-padded T + 2 pad frames, blocks 2-6 on every conv token, and
    the window transformer and head on T windows of its tokens."""
    h, w, _ = g["frame"]
    t_in = t + 2 * g["edge_pad"]
    k_t = g["kernels"][0][0]
    n_tok = t_in - k_t + 1
    ops = stem.flops(t_in, h, w)
    _, hh, ww, _ = stem.pooled_shape(t_in, h, w)
    ch = g["channels"]
    for i in range(1, len(g["kernels"])):
        _, kh, kw = g["kernels"][i]
        _, sh, sw = g["strides"][i]
        _, ph, pw = g["padding"][i]
        hh, ww = _conv_out(hh, kh, sh, ph), _conv_out(ww, kw, sw, pw)
        ops += 2.0 * n_tok * hh * ww * ch[i + 1] * ch[i] * kh * kw
        pool = g["pools"][i]
        if pool is not None:
            hh = _conv_out(hh, pool[0][1], pool[1][1], 0)
            ww = _conv_out(ww, pool[0][2], pool[1][2], 0)
    win = g["window"] - k_t + 1
    d = g["d_model"]
    rows = t * win
    ops += g["num_layers"] * layer_flops(rows, win, d, g["d_ff"])
    ops += 2.0 * rows * (d * d + d * g["d_out"])
    return ops


def jegal_flops(config: dict, t: int, tokens: int, words: int,
                mel_rows: int) -> float:
    """JEGAL's `vta` inference of one clip: the tower, the gesture branch,
    XLM-R and the text branch over `tokens` pieces, the audio CNN over the
    clip's `mel_rows` mel frames, and the word-level heads over `words`
    words."""
    j, x, a = config["jegal"], config["xlmr"], config["audio"]
    g = config["gestsync"]
    d, dt = j["d_model"], j["d_text"]
    ops = tower_flops(g, t)
    # gesture branch
    ops += 2.0 * t * (j["d_visual"] * d + d * d)
    ops += j["gesture_layers"] * layer_flops(t, t, d, j["d_ff"])
    ops += 2.0 * t * 3 * d * d
    # text branch
    ops += x["num_layers"] * layer_flops(tokens, tokens, x["hidden_size"],
                                         x["intermediate_size"])
    ops += j["text_layers"] * layer_flops(tokens, tokens, dt, j["d_ff_text"])
    ops += 2.0 * tokens * dt * j["d_text_out"]
    ops += 2.0 * words * tokens * j["d_text_out"]
    # audio branch
    hh, ww = mel_rows, a["n_mels"]
    ch = j["audio_channels"]
    for i, (kh, kw) in enumerate(j["audio_kernels"]):
        sh, sw = j["audio_strides"][i]
        ph, pw = j["audio_padding"][i]
        hh, ww = _conv_out(hh, kh, sh, ph), _conv_out(ww, kw, sw, pw)
        ops += 2.0 * hh * ww * ch[i + 1] * ch[i] * kh * kw
    ops += 2.0 * hh * ch[-1] * j["d_audio_out"]
    ops += 2.0 * words * hh * j["d_audio_out"]
    # fusion and the two align heads
    ops += 2.0 * words * 2 * d * d + 2.0 * words * 2 * d * d
    return ops

