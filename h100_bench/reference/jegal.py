"""Plain float32 reference of JEGAL's `vta` inference (reference
models/jegal.py forward_inference and inference_embs.py), one clip at its
natural length:

  gesture: GestSync features (reference/gestsync.py) -> Linear, LayerNorm,
           ReLU, Linear -> + the sinusoidal table -> the 6-layer pre-norm
           encoder -> proj_op_rgb -> the gesture align MLP -> unit rows
  text:    words (a single-space split) -> pieces through the tokenizer,
           <s> ... </s> -> XLM-R (HF's post-norm layers, exact GELU) -> the
           3-layer pre-norm encoder -> proj_op_text -> each word the mean
           of its pieces (the last word's span runs to the end of the
           sequence, </s> included)
  audio:   log-mel (torch.stft semantics: reflect pad, a periodic Hann of
           320 in 512, hop 160, the last frame dropped, Slaney mel, log(+
           1e-20)) -> the audio CNN -> proj_op_audio -> each word the mean
           of the audio tokens in its frame span
  content: concat(audio, text) -> the fusion MLP -> the content align MLP
           -> unit rows

It tokenizes, computes the mel and uses XLM-R's per-layer weights itself:
nothing the program derived from the inputs or the weights is read."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.lib.tokenizer import PieceTokenizer
from h100_bench.reference import common as C
from h100_bench.reference import gestsync as GS

CLS, PAD, SEP = 0, 1, 2


# --------------------------------------------------------------------------
# text
# --------------------------------------------------------------------------

def tokenize(text: str, tok: PieceTokenizer):
    """-> (ids (S,), word start indices): a single-space split, each word
    encoded pretokenized, a word starting where a piece's offset is 0."""
    words = text.split(" ")
    enc = tok.encode_batch([words], is_pretokenized=True)[0]
    ids = [i for i, m in zip(enc.ids, enc.attention_mask) if m]
    starts = [k for k, (i, off) in enumerate(zip(ids, enc.offsets))
              if off[0] == 0 and i not in (CLS, SEP, PAD)]
    if len(starts) != len(words):
        raise ValueError("the tokenizer merged words")
    return ids, starts


def text_pooling(starts, seq_len: int, device):
    p = torch.zeros(len(starts), seq_len, device=device)
    for w, lo in enumerate(starts):
        hi = starts[w + 1] if w + 1 < len(starts) else seq_len
        p[w, lo:hi] = 1.0 / (hi - lo)
    return p


def xlmr(rp, x_cfg: dict, ids):
    """HF XLMRobertaModel's last_hidden_state of one unpadded sequence."""
    ids = torch.as_tensor(ids, device=rp["embeddings"]["word"].device)
    emb = rp["embeddings"]
    pos = torch.arange(ids.shape[0], device=ids.device) + x_cfg["pad_token_id"] + 1
    eps = x_cfg["layer_norm_eps"]
    x = emb["word"][ids] + emb["position"][pos] + emb["token_type"][0]
    x = C.std_layer_norm(emb["ln"], x, eps)[None]
    heads = x_cfg["num_heads"]
    for layer in rp["layers"]:
        a = C.attention({"q": layer["q"], "k": layer["k"], "v": layer["v"],
                         "o": layer["attn_out"]}, x, heads)
        x = C.std_layer_norm(layer["attn_ln"], x + a, eps)
        h = F.gelu(C.linear(layer["inter"], x))
        x = C.std_layer_norm(layer["out_ln"], x + C.linear(layer["out"], h),
                             eps)
    return x[0]


# --------------------------------------------------------------------------
# audio
# --------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-12)
                                               / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def slaney_mel(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels) (htk=False, norm='slaney',
    fmin 0, fmax sr / 2)."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    return (w * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


def log_mel(wav, a: dict):
    """wav (N,) float32 tensor -> (N // hop, n_mels)."""
    n_fft, hop, win = a["n_fft"], a["hop"], a["win_length"]
    x = F.pad(wav[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    frames = x.unfold(0, n_fft, hop)                      # (1 + N // hop, n_fft)
    n = torch.arange(win, dtype=torch.float64, device=wav.device)
    hann = torch.zeros(n_fft, dtype=torch.float64, device=wav.device)
    left = (n_fft - win) // 2
    hann[left:left + win] = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win))
    mag = torch.fft.rfft(frames * hann.to(torch.float32), dim=-1).abs()[:-1]
    mel = torch.from_numpy(slaney_mel(a["sample_rate"], n_fft, a["n_mels"])) \
        .to(wav.device)
    return torch.log(mag @ mel.T + a["log_offset"])


def audio_tokens(jp, j: dict, mel):
    """(T_mel, 80) -> (T_audio, d_audio_out)."""
    x = mel[None, None]                                   # (1, 1, time, freq)
    for i, blk in enumerate(jp["cnn"]):
        x = C.conv2d(blk["conv"], x, j["audio_strides"][i],
                     j["audio_padding"][i])
        if j["audio_bn"][i]:
            x = torch.relu(C.batch_norm(blk["bn"], x))
    return C.linear(jp["proj_op_audio"], x[0, :, :, 0].transpose(0, 1))


def audio_pooling(word_boundaries, t_audio: int, device):
    first = int(word_boundaries[0][1])
    p = torch.zeros(len(word_boundaries), t_audio, device=device)
    for w, (_, start, end) in enumerate(word_boundaries):
        lo = min(int(start) - first, t_audio)
        hi = max(0, min(int(end) - first + 1, t_audio))
        if lo < 0 or hi <= lo:
            raise ValueError("an empty or negative word span")
        p[w, lo:hi] = 1.0 / (hi - lo)
    return p


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def gesture(jp, j: dict, feats):
    x = C.linear(jp["proj_ip_rgb"][0], feats)
    x = torch.relu(C.std_layer_norm(jp["proj_ip_ln"], x))
    x = C.linear(jp["proj_ip_rgb"][1], x)
    t = x.shape[0]
    x = x + C.sinusoid(max(j["pe_max_len"], t), j["d_model"], x.device)[:t]
    x = C.pre_norm_stack(jp["encoder_rgb"], x[None], j["num_heads"])[0]
    return C.unit_rows(C.mlp2(jp["proj_op_align_gesture"],
                              C.linear(jp["proj_op_rgb"], x)))


def content(jp, rp, config: dict, clip: dict, tok: PieceTokenizer, device):
    j = config["jegal"]
    ids, starts = tokenize(clip["text"], tok)
    hidden = xlmr(rp, config["xlmr"], ids)
    text = C.linear(jp["proj_op_text"], C.pre_norm_stack(
        jp["encoder_text"], hidden[None], j["num_heads"])[0])
    text_words = text_pooling(starts, len(ids), device) @ text
    wav = torch.from_numpy(np.ascontiguousarray(clip["wav"], np.float32)) \
        .to(device)
    tokens = audio_tokens(jp, j, log_mel(wav, config["audio"]))
    audio_words = audio_pooling(clip["word_boundaries"], tokens.shape[0],
                                device) @ tokens
    if j["fusion"] != "concat":
        raise ValueError("the reference fuses by concatenation")
    fused = C.mlp2(jp["proj_op_fusion_content"],
                   torch.cat([audio_words, text_words], dim=-1))
    return C.unit_rows(C.mlp2(jp["proj_op_align_content"], fused))


def run(weights: dict, config: dict, clip: dict, device) -> dict:
    """The reference's outputs for one clip of a `vta` mix."""
    tok = PieceTokenizer(config["xlmr"]["vocab_size"])
    planar = torch.from_numpy(clip["frames"]).to(device)
    feats = GS.features(weights["gestsync"], config["gestsync"], planar)
    return {"gesture_emb": gesture(weights["jegal"], config["jegal"], feats),
            "content_emb": content(weights["jegal"], weights["xlmr"], config,
                                   clip, tok, device)}
