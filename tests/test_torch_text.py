"""The port's text branch against the JAX package on the CPU: the word
tokenizer and the text pooling builders on the tiny BPE tokenizer of
tests/tok_util.py (wrapped by each package's WordTokenizer), forward_text,
and forward_inference in the four combos with text. Weights are drawn by
jegal_torch.convert.init_* (randomized LN parameters) and handed to JAX as
numpy; the XLM-R is tiny (1 layer, d 768: the text encoder's width).

Tolerance rtol = atol = 2e-5 unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.models import jegal as JJ
from jegal_tpu.models import roberta as JR
from jegal_tpu.ops import pooling as JP
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from jegal_torch.convert import (
    init_jegal_params,
    init_roberta_params,
    jegal_params_from_jax,
    roberta_params_from_jax,
)
from jegal_torch.models import jegal as TJ
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.ops import pooling as TP
from jegal_torch.text.tokenizer import WordTokenizer
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
TEXTS = ["hello world abc", "ab lo", "zebra hello wolf 42 x",
         "hello  world"]     # the double space makes an empty word


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def batches():
    """Each package's WordBatch for TEXTS, encoded together."""
    return (WordTokenizer(make_tiny_tokenizer()).encode_words(TEXTS),
            JaxWordTokenizer(make_tiny_tokenizer()).encode_words(TEXTS))


def test_word_batches_equal_jax(batches):
    got, want = batches
    for name in ("input_ids", "attention_mask", "offsets"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert got.words == want.words
    assert got.special_ids == want.special_ids


def test_text_pooling_equals_jax(batches):
    """Word starts and pooling matrices over a padded batch: the last
    detected word runs to the end of the padded axis, and the sample with
    an empty word (more words than starts) is invalid."""
    got, want = batches
    starts = TP.text_word_starts(got.input_ids, got.offsets, got.special_ids)
    assert starts == JP.text_word_starts(want.input_ids, want.offsets,
                                         want.special_ids)
    counts = [len(w) for w in got.words]
    seq = got.input_ids.shape[1]
    for n_words, w_max in ((counts, 8), ([2, 1, 3, 2], 4)):
        t = TP.build_text_pooling(starts, n_words, seq, w_max)
        j = JP.build_text_pooling(starts, n_words, seq, w_max)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    _, valid, _ = TP.build_text_pooling(starts, counts, seq, 8)
    assert valid.tolist() == [True, True, True, False]


def test_tokenizer_pads_to_a_length():
    got = WordTokenizer(make_tiny_tokenizer()).encode_words(TEXTS[:1],
                                                            pad_to=16)
    want = JaxWordTokenizer(make_tiny_tokenizer()).encode_words(TEXTS[:1],
                                                                pad_to=16)
    assert got.input_ids.shape == (1, 16)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)


@pytest.fixture(scope="module")
def params():
    jp = _as_numpy(init_jegal_params(torch.Generator().manual_seed(4)))
    rp = _as_numpy(init_roberta_params(torch.Generator().manual_seed(5),
                                       RobertaConfig(**TINY_XLMR)))
    return jp, jegal_params_from_jax(jp), rp, roberta_params_from_jax(rp)


def _text_arrays(rng, b=1, s=16, n_valid=11):
    ids = rng.integers(3, 64, (b, s))
    ids[:, 0], ids[:, n_valid - 1], ids[:, n_valid:] = 0, 2, 1
    mask = (np.arange(s) < n_valid).astype(np.float32)[None].repeat(b, 0)
    pool = np.zeros((b, 8, s), np.float32)
    pool[:, 0, 1:3], pool[:, 1, 3:7], pool[:, 2, 7:s] = 1 / 2, 1 / 4, 1 / 9
    return {"input_ids": ids, "text_mask": mask, "text_pool": pool}


def test_forward_text_matches_jax(params, rng):
    """XLM-R hidden states -> 3-layer text encoder -> proj_op_text, with a
    pad tail masked."""
    jp, tp, _, _ = params
    hidden = rng.standard_normal((2, 16, 768)).astype(np.float32)
    mask = np.ones((2, 16), np.float32)
    mask[1, 9:] = 0.0
    want = np.asarray(JJ.forward_text(jp, jnp.asarray(hidden),
                                      jnp.asarray(mask), fused=False))
    got = TJ.forward_text(tp, torch.from_numpy(hidden),
                          torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 16, 256)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1, :9], want[1, :9], **TOL)


@pytest.mark.parametrize("combo", ["vta", "vt", "ta", "t"])
def test_forward_inference_text_combos(params, rng, combo):
    jp, tp, rjp, rtp = params
    use_v, use_a = "v" in combo, "a" in combo
    arrays = _text_arrays(rng)
    if use_v:
        arrays["visual_feats"] = rng.standard_normal(
            (1, 32, 1024)).astype(np.float32)
        arrays["visual_mask"] = (np.arange(32) < 27).astype(np.float32)[None]
    if use_a:
        arrays["audio_mel"] = rng.standard_normal((1, 128, 80)).astype(
            np.float32)
        pool = np.zeros((1, 8, 32), np.float32)
        pool[0, 0, 0:3], pool[0, 1, 3:9], pool[0, 2, 9:20] = 1 / 3, 1 / 6, 1 / 11
        arrays["audio_pool"] = pool
        arrays["audio_valid"] = np.array([121])
    want = JJ.forward_inference(
        jp, rjp, use_v=use_v, use_t=True, use_a=use_a,
        roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    got = TJ.forward_inference(
        tp, rtp, use_v=use_v, use_t=True, use_a=use_a,
        roberta_cfg=RobertaConfig(**TINY_XLMR),
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
