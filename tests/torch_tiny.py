"""The tiny training setup of the port's training tests, shared by the
one-process tests (tests/test_torch_training.py) and the gloo ranks of the
mesh tests (tests/torch_mesh_worker.py), which must draw the same weights
and batches from the same seeds. It imports neither JAX nor the JAX
package, so a rank starts quickly.

Weights are drawn by jegal_torch.convert.init_* (randomized BatchNorm
statistics and LayerNorm parameters) with the encoders cut to a few layers
and XLM-R to one layer (hidden 768, 12 heads) of a small vocabulary."""

import numpy as np
import torch

from jegal_torch.convert import init_jegal_params, init_roberta_params
from jegal_torch.models import roberta as TR_R
from jegal_torch.ops import pooling as P


def tiny_jegal(seed: int, layers: int):
    params = init_jegal_params(torch.Generator().manual_seed(seed))
    for enc in ("encoder_rgb", "encoder_text"):
        params[enc]["layers"] = params[enc]["layers"][:layers]
    return params


def tiny_roberta(seed: int, vocab: int, max_pos: int):
    cfg = TR_R.RobertaConfig(vocab_size=vocab, num_layers=1,
                             max_position_embeddings=max_pos)
    return init_roberta_params(torch.Generator().manual_seed(seed), cfg), cfg


def tiny_batch(rng, b, t, s, w, mel, vocab):
    """A training batch of b clips: t frames (the second clip's last two
    masked), an 11-token text of w words (its subwords after the first w-1
    starts pool into the last word), w audio words over the mel's tokens,
    and a word mask with one clip's last word masked."""
    ids = np.full((b, s), 1, np.int32)
    ids[:, 0], ids[:, 12] = 0, 2
    ids[:, 1:12] = rng.integers(4, vocab, (b, 11))
    tpool, _, _ = P.build_text_pooling([[1, 3, 6, 8]] * b, [w] * b, s, w)
    wbs = [["w", 2 * i, 2 * i + 1] for i in range(w)]
    apool, valid, _ = P.build_audio_pooling([wbs] * b, mel // 4, w)
    assert valid.all()
    vmask = np.ones((b, t), np.float32)
    vmask[1, t - 2:] = 0.0
    wmask = np.ones((b, w), np.float32)
    wmask[2, w - 1:] = 0.0
    return {
        "visual_feats": rng.standard_normal((b, t, 1024)).astype(np.float32),
        "visual_mask": vmask,
        "input_ids": ids,
        "text_mask": (ids != 1).astype(np.float32),
        "text_pool": tpool,
        "audio_mel": rng.standard_normal((b, mel, 80)).astype(np.float32),
        "audio_pool": apool,
        "audio_valid": np.array([mel, mel - 4, mel, mel - 12], np.int32)[:b],
        "word_mask": wmask,
    }


def setup_step(layers: int = 2):
    """The step tests' setup: (JEGAL tree with encoders of `layers`
    layers, XLM-R tree, its config, a 4-clip batch of CPU tensors)."""
    jp = tiny_jegal(1, layers)
    rp, cfg = tiny_roberta(2, 128, 32)
    batch = tiny_batch(np.random.default_rng(0), b=4, t=8, s=16, w=4,
                       mel=32, vocab=128)
    return jp, rp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}


def transcript_rows(n=10):
    words = ["Hello,", "world", "--", "a", "Bob's", "lo", "w0", "ab", "he",
             "wo"]
    return [f"{words[i % len(words)]}, {i * 0.4:.2f}, {i * 0.4 + 0.3:.2f}, 0.9"
            for i in range(n)]


def write_corpus(root):
    """Three clips under `root` in the reference's formats (a (110, 1024)
    feature file, a 5 s wav, a 10-word transcript) and the corpus CSV ->
    {"rows", "feat_dir", "csv"}."""
    from scipy.io import wavfile

    feat_dir = root / "feats"
    feat_dir.mkdir()
    rng = np.random.default_rng(5)
    rows = []
    for i in range(3):
        np.save(feat_dir / f"c{i}.npy",
                rng.standard_normal((110, 1024)).astype(np.float32))
        wav_path = root / f"c{i}.wav"
        wavfile.write(wav_path, 16000, (rng.standard_normal(16000 * 5) * 300)
                      .astype(np.int16))
        txt_path = root / f"c{i}.txt"
        txt_path.write_text("Text: x\nLang: en\n\nWORD, START, END, SCORE\n"
                            + "\n".join(transcript_rows(10)) + "\n")
        rows.append({"filename": f"c{i}", "text_path": str(txt_path),
                     "audio_path": str(wav_path)})
    csv_path = root / "corpus.csv"
    csv_path.write_text("filename,text_path,audio_path\n" + "".join(
        f"{r['filename']},{r['text_path']},{r['audio_path']}\n" for r in rows))
    return dict(rows=rows, feat_dir=str(feat_dir), csv=str(csv_path))
