"""The traffic generator: a seed's pool and calls repeat exactly, and every
seed asks for the same lengths, counts and buckets."""

from __future__ import annotations

import json

import numpy as np
import torch

from h100_bench.entries import extract_many, tower_many
from h100_bench.lib import traffic
from h100_bench.lib.tokenizer import PieceTokenizer
from h100_bench.tests.conftest import BENCH

CPU = torch.device("cpu")


def tiny_mix(name="avspeech_vta_b16", **pool):
    mix = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    mix.update(batch_size=2, clips_per_call=4)
    mix["pool"].update(clips=2, seconds=[0.32, 0.48], **pool)
    return mix


def test_lengths_and_counts_follow_the_published_range():
    mix = traffic.load(BENCH / "workloads" / "avspeech_vta_b16.json")
    ts = traffic.lengths(mix)
    assert (ts[0], ts[-1], len(ts)) == (75, 250, 32)
    assert ts == sorted(ts)
    assert traffic.word_counts(mix)[0] == 8
    assert traffic.word_counts(mix)[-1] == 25


def test_pool_repeats_for_a_seed_and_differs_across_seeds():
    mix = tiny_mix(words_per_second=10)
    seed = 2 ** 40 + 3
    a, b = traffic.make_pool(mix, seed, CPU), traffic.make_pool(mix, seed, CPU)
    c = traffic.make_pool(mix, seed + 1, CPU)
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x["frames"], y["frames"])
        assert np.array_equal(x["wav"], y["wav"])
        assert x["text"] == y["text"]
        assert x["word_boundaries"] == y["word_boundaries"]
        assert not np.array_equal(x["frames"], z["frames"])
        assert x["frames"].shape == z["frames"].shape
        assert x["wav"].shape == z["wav"].shape
        assert len(x["text"]) == len(z["text"])
        assert [w[1:] for w in x["word_boundaries"]] \
            == [w[1:] for w in z["word_boundaries"]]


def test_call_order_repeats_and_covers_the_pool_evenly():
    mix = traffic.load(BENCH / "workloads" / "avspeech_vta_b16.json")
    o = traffic.call_order(mix, 12345678901, 3)
    assert o == traffic.call_order(mix, 12345678901, 3)
    assert o != traffic.call_order(mix, 12345678901, 4)
    assert sorted(o) == sorted(list(range(32)) * 2)


def _metas(mix, pool):
    tok = PieceTokenizer()
    return [{"t": c["frames"].shape[0],
             "tokens": len(tok.encode_batch([c["text"].split(" ")])[0].ids),
             "words": len(c["text"].split(" ")), "mel": len(c["wav"]) // 160}
            for c in pool]


def test_every_seed_meets_the_same_buckets():
    """The cell's chunks (the program's buckets and batch ladder) are the
    same for every seed and every call: what the warm call captures is
    all that the window replays. Checked on the full-size pool's shapes,
    computed without making its frames."""
    mix = traffic.load(BENCH / "workloads" / "avspeech_vta_b16.json")
    small = tiny_mix(words_per_second=10)
    for seed in (1, 2 ** 35 + 9):
        pool = traffic.make_pool(small, seed, CPU)
        metas = _metas(small, pool)
        assert extract_many.chunks(small, metas) \
            == extract_many.chunks(small, metas[::-1])
    ts = traffic.lengths(mix)
    ns = traffic.word_counts(mix)
    metas = [{"t": t, "tokens": 2 * n, "words": n, "mel": 4 * t}
             for t, n in zip(ts, ns)]
    for k in (1, 2):
        order = traffic.call_order(mix, 99, k)
        got = extract_many.chunks(mix, [metas[i] for i in order])
        assert sorted(map(str, got)) == sorted(map(str, [
            {"b": 4, "t": 128, "s": 16, "w": 8, "mel": 512},
            {"b": 16, "t": 128, "s": 32, "w": 16, "mel": 512},
            {"b": 16, "t": 256, "s": 32, "w": 16, "mel": 1024},
            {"b": 16, "t": 256, "s": 64, "w": 32, "mel": 1024},
            {"b": 16, "t": 256, "s": 64, "w": 32, "mel": 1024}]))
        tower = tower_many.chunks(mix, [metas[i] for i in order])
        assert sorted(map(str, tower)) == sorted(map(str, [
            {"b": 16, "t": 128}, {"b": 4, "t": 128}, {"b": 16, "t": 256},
            {"b": 16, "t": 256}, {"b": 16, "t": 256}]))


def test_tokens_follow_the_word_count():
    """First and last words of 3 letters (one piece), the others of 5 (two
    pieces): 2 n tokens with <s> and </s>."""
    mix = tiny_mix(words_per_second=10)
    pool = traffic.make_pool(mix, 7, CPU)
    for c, m in zip(pool, _metas(mix, pool)):
        assert m["tokens"] == 2 * m["words"]
