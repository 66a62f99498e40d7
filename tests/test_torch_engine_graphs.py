"""The port engine's graph surface on the CPU, against the JAX engine:
`fusion_strategy`, `extract_to_pkl`, `extract_many(ladder=False)`, the
graph ledger's LRU (`max_cached_graphs`, `cached_graphs`), `warmup_all`'s
records, and `warmup(frames_kind=...)` warming the graph that live calls
then hit.

On the CPU a ledger entry holds the eager forward (on the card, a captured
CUDA graph; tests/test_torch_kernels_cuda.py), so the ledger's policy is
tested here: the same call sequences leave the same (key, shape signature)
entries in both engines. Weights are shared through
`convert.*_params_from_jax`; text goes through a tiny XLM-R (1 layer, d
768, 8 heads) and the tiny BPE of tests/tok_util.py.

Tolerance: rtol = atol = 2e-5 on unit-norm embeddings, the JAX suite's
path-equality bar (the same float32 sums in another order by oneDNN and
XLA:CPU)."""

import pickle

import numpy as np
import pytest
import torch

import jax

from jegal_tpu import api as JAPI
from jegal_tpu.models import roberta as JR
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from jegal_torch import api as TAPI
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
    jegal_params_from_jax,
    roberta_params_from_jax,
)
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.ops.video import s2d_repack
from jegal_torch.text.tokenizer import WordTokenizer
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
AVG_WARNING = "tiles the 256-d average"


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def weights():
    """JAX-layout numpy trees: JEGAL, GestSync (randomized BatchNorm
    statistics and LayerNorm parameters) and the tiny XLM-R."""
    return (_as_numpy(init_jegal_params(torch.Generator().manual_seed(61))),
            _as_numpy(init_gestsync_params(torch.Generator().manual_seed(62))),
            _as_numpy(init_roberta_params(torch.Generator().manual_seed(63),
                                          RobertaConfig(**TINY_XLMR))))


def _engines(weights, **kw):
    """(JAX engine, port engine on the CPU) on the same weights, with the
    same engine arguments."""
    jp, gp, rp = weights
    jax_eng = JAPI.JegalEngine(
        jegal_params=jp, gestsync_params=gp, roberta_params=rp,
        roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()), **kw)
    port = TAPI.JegalEngine(
        jegal_params_from_jax(jp), gestsync_params_from_jax(gp),
        device="cpu", roberta_params=roberta_params_from_jax(rp),
        roberta_cfg=RobertaConfig(**TINY_XLMR),
        tokenizer=WordTokenizer(make_tiny_tokenizer()), **kw)
    return jax_eng, port


@pytest.fixture(scope="module")
def content():
    rng = np.random.default_rng(64)
    return dict(wav=(rng.standard_normal(8000) * 1000).astype(np.float32),
                word_boundaries=[["a", 0, 3], ["b", 4, 8], ["c", 9, 12]],
                text="hello world abc")


def _same(got, want):
    assert got.keys() == want.keys()
    assert got["info"] == want["info"]
    for key in ("gesture_emb", "content_emb"):
        if want[key] is None:
            assert got[key] is None
        else:
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], **TOL)


def test_fusion_avg_matches_jax(weights, content):
    """'avg' fusion warns, matches the JAX engine's, and differs from
    'concat'; any other strategy raises."""
    jax_eng, port = _engines(weights, fusion_strategy="avg")
    kw = dict(modalities="ta", fname="f", **content)
    with pytest.warns(UserWarning, match=AVG_WARNING):
        got = port.extract(**kw)
    _same(got, jax_eng.extract(**kw))
    concat = _engines(weights)[1].extract(**kw)
    assert np.abs(got["content_emb"] - concat["content_emb"]).max() > 1e-3
    for eng in _engines(weights, fusion_strategy="sum"):
        with pytest.raises(ValueError, match="unknown fusion strategy"):
            eng.extract(**kw)


def test_extract_to_pkl_matches_jax(weights, content, tmp_path):
    """The same file name and .pkl schema as the JAX engine's, embeddings
    within 2e-5; an invalid sample writes nothing."""
    jax_eng, port = _engines(weights)
    kw = dict(modalities="ta", fname="clip7", **content)
    got_path = port.extract_to_pkl(str(tmp_path / "port"), **kw)
    want_path = jax_eng.extract_to_pkl(str(tmp_path / "jax"), **kw)
    assert got_path == str(tmp_path / "port" / "clip7.pkl")
    assert want_path == str(tmp_path / "jax" / "clip7.pkl")
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    with open(want_path, "rb") as f:
        want = pickle.load(f)
    _same(got, want)
    bad = dict(kw, text="hello world", fname="bad")   # 2 words, 3 boundaries
    assert port.extract_to_pkl(str(tmp_path / "port"), **bad) is None
    assert not (tmp_path / "port" / "bad.pkl").exists()


def test_extract_many_without_ladder_matches_jax(weights, content):
    """ladder=False pads a 2-sample chunk to batch_size 4 (the ladder
    would pad it to 2): the same rows and the same graph signatures as the
    JAX engine's."""
    rng = np.random.default_rng(65)
    samples = [dict(visual_feats=rng.standard_normal((t, 1024)).astype(
        np.float32), fname=f"s{t}", **content) for t in (14, 20)]
    jax_eng, port = _engines(weights)
    want = jax_eng.extract_many(samples, "vta", batch_size=4, ladder=False)
    got = port.extract_many(samples, "vta", batch_size=4, ladder=False)
    for g, w in zip(got, want):
        _same(g, w)
    assert port.cached_graphs == jax_eng.cached_graphs
    (key, shapes), = port.cached_graphs
    assert key == (True, True, True)
    assert {shape[0] for _, shape in shapes} == {4}
    port.extract_many(samples, "vta", batch_size=4)
    assert {shape[0] for _, shape in port.cached_graphs[-1][1]} == {2}


@pytest.mark.parametrize("budget,calls,left", [
    # three T buckets of 'v', then a fourth graph in another combo: the
    # least recently used combo ('v') loses all its graphs
    (3, [dict(t=16), dict(t=32), dict(t=64),
         dict(modalities="a", w=8, mel=64)], 1),
    # the budget exceeded within one combo: only the shape in flight stays
    (2, [dict(t=16), dict(t=32), dict(t=64)], 1),
])
def test_graph_ledger_matches_jax(weights, budget, calls, left):
    jax_eng, port = _engines(weights, max_cached_graphs=budget)
    for kw in calls:
        kw = dict(dict(modalities="v"), **kw)
        jax_eng.warmup(**kw)
        port.warmup(**kw)
    assert len(port.cached_graphs) == left
    assert port.cached_graphs == jax_eng.cached_graphs
    # evicted graphs are dropped with their ledger entries; on the CPU an
    # entry holds the eager forward
    assert set(port._graphs) == set(port.cached_graphs)
    assert all(g.graph is None and callable(g.fn)
               for g in port._graphs.values())
    out = port.extract(modalities="v",
                       visual_feats=np.ones((20, 1024), np.float32))
    assert out["gesture_emb"].shape == (20, 512)


def test_warmup_all_records_match_jax(weights):
    """The same records (combo, axes, batch) in the same order as the JAX
    engine's, the same graphs, and a live request at a warmed bucket adds
    no graph."""
    jax_eng, port = _engines(weights)
    kw = dict(combos=("va", "v", "a"), t_buckets=(32,), w_buckets=(8,),
              mel_buckets=(128,))
    got, want = port.warmup_all(**kw), jax_eng.warmup_all(**kw)
    assert all(r.pop("seconds") > 0 for r in got)
    assert got == [{k: v for k, v in r.items() if k != "seconds"}
                   for r in want]
    assert [r["combo"] for r in got] == ["va", "v", "a"]
    assert port.cached_graphs == jax_eng.cached_graphs
    n = len(port.cached_graphs)
    rng = np.random.default_rng(66)
    out = port.extract(modalities="va", wav=rng.standard_normal(
        16000).astype(np.float32), word_boundaries=[["a", 0, 10],
                                                    ["b", 11, 20]],
        visual_feats=rng.standard_normal((14, 1024)).astype(np.float32))
    assert out["content_emb"].shape == (2, 512)
    assert len(port.cached_graphs) == n


def test_warmup_frames_kind_is_hit_by_live_calls(weights):
    """warmup(frames_kind=...) registers the graph that a following live
    extract (a single clip) or extract_many (a chunk) hits, with no new
    ledger entry (JAX: tests/test_fused_engine.py:249-300); a frames_kind
    on a combo without 'v' raises."""
    _, port = _engines(weights)
    rng = np.random.default_rng(67)
    frames = rng.integers(0, 256, (6, 270, 480, 3), dtype=np.uint8)
    chin = rng.integers(90, 200, 6)
    port.warmup(modalities="v", t=32, frames_kind="raw")
    n = len(port.cached_graphs)
    single = port.extract(modalities="v", frames=frames, chin_rows=chin)
    assert len(port.cached_graphs) == n
    assert port.cached_graphs[-1][0] == ("fused", "raw", False, False, False)
    port.warmup(modalities="v", t=32, batch=2, frames_kind="planar")
    n = len(port.cached_graphs)
    many, = port.extract_many([dict(frames=s2d_repack(frames, chin))], "v",
                              batch_size=2, ladder=False)
    assert len(port.cached_graphs) == n
    key, shapes = port.cached_graphs[-1]
    assert key == ("fused", "planar", False, False, True)
    assert dict(shapes)["frames"] == (2, 32, 90, 27, 160)
    np.testing.assert_allclose(many["gesture_emb"], single["gesture_emb"],
                               **TOL)
    with pytest.raises(ValueError, match="frames_kind"):
        port.warmup(modalities="ta", frames_kind="raw")
