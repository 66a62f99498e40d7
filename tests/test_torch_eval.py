"""The port's evaluation (jegal_torch/eval) against the JAX package's
(jegal_tpu/eval) on the CPU, on synthetic embedding sets drawn by a seeded
numpy Generator like tests/test_eval.py's: each numpy path equal to the
JAX package's, and each device path, run with device="cpu", equal to the
JAX device path and to the numpy path at the 500-row scale of
tests/test_eval.py:58,184,278. Ranks, hits and counts are integers and
must be equal; rates are compared with pytest.approx's default (rel 1e-6),
as tests/test_eval.py does."""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from jegal_tpu import config as JC
from jegal_tpu.eval import asd as JASD
from jegal_tpu.eval import common as JCOM
from jegal_tpu.eval import retrieval as JRET
from jegal_tpu.eval import spotting as JSPOT
from jegal_torch import config as TC
from jegal_torch.eval import asd, common, heatmap, retrieval, spotting


def _write_pkl(path, gesture, content, info):
    with open(path, "wb") as f:
        pickle.dump({"gesture_emb": gesture, "content_emb": content,
                     "info": info}, f)


@pytest.fixture(scope="module")
def emb_dir(tmp_path_factory):
    """500 videos whose video-level gesture and content embeddings are
    noisy pairs: ragged T and W, most but not all ranks 0."""
    rng = np.random.default_rng(10)
    d = tmp_path_factory.mktemp("embs")
    base = rng.standard_normal((500, 64)).astype(np.float32)
    for i in range(500):
        t, w = int(rng.integers(4, 12)), int(rng.integers(2, 6))
        gesture = base[i] + 1.5 * rng.standard_normal((t, 64))
        content = base[i] + 1.5 * rng.standard_normal((w, 64))
        _write_pkl(d / f"vid{i:03d}.pkl", gesture.astype(np.float32),
                   content.astype(np.float32), {"fname": f"vid{i:03d}"})
    return str(d)


@pytest.fixture(scope="module")
def spot_dir(tmp_path_factory):
    """tests/test_eval.py's 500 spotting videos (ragged T, W; about half
    with the target word's peak planted in its span), and three long
    outliers (T 600, 900, 1500)."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("spot")
    lengths = [int(rng.integers(20, 48)) for _ in range(500)]
    for i, t in enumerate(lengths + [600, 900, 1500]):
        w = int(rng.integers(2, 9))
        content = rng.standard_normal((w, 64)).astype(np.float32)
        gesture = 0.05 * rng.standard_normal((t, 64)).astype(np.float32)
        wi = int(rng.integers(0, w))
        span = sorted(rng.integers(0, t, size=2).tolist())
        if i % 2 == 0:
            gesture[min(span[0], t - 1)] = content[wi] * 8
        wbs = [[f"w{j}", j, j + 1] for j in range(w)]
        wbs[wi] = [f"w{wi}", span[0], span[1]]
        _write_pkl(d / f"v{i:03d}.pkl", gesture, content,
                   {"word_boundaries": str(wbs),
                    "target_word_boundary": str(wbs[wi])})
    return str(d)


class Rows:
    """A table with only `iterrows()`, as the port's ASD accepts."""

    def __init__(self, rows):
        self.rows = rows

    def iterrows(self):
        return enumerate(self.rows)


@pytest.fixture(scope="module")
def asd_set(tmp_path_factory):
    """tests/test_eval.py's 500 ASD queries over a 40-speaker pool with
    ragged negative lists (some missing files, some shorter than the
    largest speaker count)."""
    rng = np.random.default_rng(12)
    d = tmp_path_factory.mktemp("asd")
    base = rng.standard_normal((40, 512)).astype(np.float32)
    names = [f"s{i}/clip" for i in range(40)]
    for i, n in enumerate(names):
        noise = 0.8 * rng.standard_normal((512,)).astype(np.float32)
        _write_pkl(d / (n.replace("/", "__") + ".pkl"),
                   np.tile(base[i] + noise, (5, 1)),
                   np.tile(base[i], (3, 1)), {})
    rows = []
    for i in range(500):
        qi = int(rng.integers(0, 40))
        negs = [names[j] for j in rng.permutation(40)[:int(rng.integers(1, 8))]
                if j != qi]
        if i % 7 == 0:
            negs.append("missing/x")
        rows.append({"filename": names[qi], "neg_files": str(negs)})
    rows.append({"filename": "missing/query", "neg_files": "[]"})
    return str(d), rows


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def test_eval_constants_match_jax():
    assert TC.TEMPERATURE == JC.DEFAULT.model.temperature == common.TEMP
    ev = JC.DEFAULT.eval
    assert (TC.SPOT_THRESHOLD, TC.SPOT_FRAME_THRESHOLD, TC.ASD_SPEAKERS,
            TC.HEATMAP_THRESHOLD, TC.HEATMAP_ALPHA) == (
        ev.spot_threshold, ev.spot_frame_threshold, tuple(ev.asd_speakers),
        ev.heatmap_threshold, ev.heatmap_alpha)


def test_common_helpers_match_jax():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((12, 32)).astype(np.float32)
    c = rng.standard_normal((4, 32)).astype(np.float32)
    np.testing.assert_array_equal(common.attention_matrix(g, c),
                                  JCOM.attention_matrix(g, c))
    np.testing.assert_array_equal(common.l2_normalize(g),
                                  JCOM.l2_normalize(g))
    assert common.parse_word_boundaries("[['a', 1, 2]]") == \
        JCOM.parse_word_boundaries("[['a', 1, 2]]") == [["a", 1, 2]]


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------

def test_retrieval_numpy_matches_jax(emb_dir):
    got = retrieval.evaluate(emb_dir)
    assert got == JRET.evaluate(emb_dir)
    assert 0 < got["c2g"]["R1"] < 1          # ranks other than 0 occur


def test_retrieval_known_ranks():
    """tests/test_eval.py's hand-built matrix: the diagonal second best in
    every row -> R1 0, R5 1, MR 2, on both paths."""
    n = 6
    sim = np.zeros((n, n), np.float32)
    for i in range(n):
        sim[i, i], sim[i, (i + 1) % n] = 0.8, 0.9
    assert retrieval.compute_metrics(sim) == JRET.compute_metrics(sim)
    assert retrieval.compute_metrics(sim)["MR"] == 2.0


def test_retrieval_device_matches_numpy_and_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((500, 512)).astype(np.float32)
    k = 0.7 * q + 0.3 * rng.standard_normal((500, 512)).astype(np.float32)
    host = retrieval.compute_metrics(retrieval.similarity_matrix(q, k))
    dev = retrieval.compute_metrics_device(q, k, device="cpu")
    assert dev == pytest.approx(host)
    assert dev == pytest.approx(JRET.compute_metrics_device(q, k))
    # an even row count: the median is the mean of the two middle ranks
    q2 = rng.standard_normal((40, 16)).astype(np.float32)
    k2 = q2 + 2.0 * rng.standard_normal((40, 16)).astype(np.float32)
    dev2 = retrieval.compute_metrics_device(q2, k2, device="cpu")
    assert dev2 == pytest.approx(retrieval.compute_metrics(
        retrieval.similarity_matrix(q2, k2)))


def test_retrieval_evaluate_device(emb_dir):
    got = retrieval.evaluate_device(emb_dir, device="cpu")
    host = retrieval.evaluate(emb_dir)
    want = JRET.evaluate_device(emb_dir)
    for mode in ("c2g", "g2c"):
        assert got[mode] == pytest.approx(host[mode])
        assert got[mode] == pytest.approx(want[mode])


# ---------------------------------------------------------------------------
# Spotting
# ---------------------------------------------------------------------------

def test_spot_word_matches_jax():
    """tests/test_eval.py's hit and miss."""
    rng = np.random.default_rng(1)
    content = rng.standard_normal((3, 16)).astype(np.float32)
    gesture = 0.01 * rng.standard_normal((40, 16)).astype(np.float32)
    gesture[20], gesture[5] = content[1] * 10, content[2] * 10
    wbs = [["a", 0, 5], ["b", 18, 22], ["c", 30, 35]]
    for target, hit in ((["b", 18, 22], True), (["c", 30, 35], False)):
        got = spotting.spot_word(gesture, content, wbs, target)
        assert got == JSPOT.spot_word(gesture, content, wbs, target)
        assert got[0] is hit


def test_spotting_numpy_matches_jax(spot_dir):
    got = spotting.evaluate(spot_dir)
    assert got == JSPOT.evaluate(spot_dir)
    assert 0 < got["correct"] < got["total"] == 503


def test_spotting_device_matches_numpy_and_jax(spot_dir):
    host = spotting.evaluate(spot_dir)
    assert spotting.evaluate_device(spot_dir, device="cpu") == host
    assert JSPOT.evaluate_device(spot_dir) == host


def test_spotting_predictions_match_spot_word(spot_dir):
    """Per video, the device path's argmax frame equals spot_word's and
    its score agrees within 1e-6."""
    got = spotting.predict_device(spot_dir, device="cpu")
    files = common.list_embedding_files(spot_dir)
    assert len(got) == len(files) == 503
    for (target, pred, score), fname in zip(got, files):
        feats = common.load_pkl(fname)
        info = feats["info"]
        _, want_pred, want_score = spotting.spot_word(
            feats["gesture_emb"], feats["content_emb"],
            info["word_boundaries"], info["target_word_boundary"])
        assert target == common.parse_word_boundaries(
            info["target_word_boundary"])
        assert pred == want_pred, fname
        assert score == pytest.approx(want_score, abs=1e-6), fname


def test_spotting_device_multi_group(spot_dir, monkeypatch):
    """A shrunk group budget splits the set into many length groups (the
    long-outlier guard); the scatter back through the sorted order must
    still give the numpy result."""
    monkeypatch.setattr(spotting, "MAX_GROUP_ELEMS", 1 << 13)
    assert spotting.evaluate_device(spot_dir, device="cpu") == \
        spotting.evaluate(spot_dir)


def test_spotting_empty_dir(tmp_path):
    want = {"accuracy": 0.0, "correct": 0, "total": 0}
    assert spotting.evaluate_device(str(tmp_path), device="cpu") == want
    assert JSPOT.evaluate_device(str(tmp_path)) == want


# ---------------------------------------------------------------------------
# Active speaker detection
# ---------------------------------------------------------------------------

def test_asd_numpy_matches_jax(asd_set):
    res_dir, rows = asd_set
    got = asd.evaluate(res_dir, pd.DataFrame(rows))
    assert got == JASD.evaluate(res_dir, pd.DataFrame(rows))
    assert asd.evaluate(res_dir, Rows(rows)) == got
    assert got["evaluated"] == 500


@pytest.mark.parametrize("table", ["pandas", "rows"])
def test_asd_device_matches_numpy_and_jax(asd_set, table):
    res_dir, rows = asd_set
    df = pd.DataFrame(rows) if table == "pandas" else Rows(rows)
    host = asd.evaluate(res_dir, pd.DataFrame(rows))
    got = asd.evaluate_device(res_dir, df, device="cpu")
    want = JASD.evaluate_device(res_dir, pd.DataFrame(rows))
    assert sorted(got) == sorted(host) == sorted(want)
    assert got["evaluated"] == host["evaluated"] == 500
    for k in host:
        assert got[k] == pytest.approx(host[k]), k
        assert got[k] == pytest.approx(want[k]), k


def test_asd_no_query_found(tmp_path):
    rows = [{"filename": "a/b", "neg_files": "[]"}]
    want = JASD.evaluate_device(str(tmp_path), pd.DataFrame(rows))
    assert asd.evaluate_device(str(tmp_path), Rows(rows),
                               device="cpu") == want


def test_cosine_scores_match_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal(32).astype(np.float32)
    c = rng.standard_normal((5, 32)).astype(np.float32)
    np.testing.assert_array_equal(asd.cosine_scores(q, c),
                                  JASD.cosine_scores(q, c))


# ---------------------------------------------------------------------------
# No card, heatmap
# ---------------------------------------------------------------------------

def test_device_paths_raise_without_a_card(emb_dir, spot_dir, asd_set,
                                           monkeypatch):
    """device="cuda" (the default) with no card raises; nothing falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res_dir, rows = asd_set
    for run in (lambda: retrieval.evaluate_device(emb_dir),
                lambda: spotting.evaluate_device(spot_dir),
                lambda: asd.evaluate_device(res_dir, Rows(rows))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_heatmap_render(tmp_path, emb_dir):
    pytest.importorskip("matplotlib")
    src = tmp_path / "vid.pkl"
    with open(os.path.join(emb_dir, "vid000.pkl"), "rb") as f:
        feats = pickle.load(f)
    w = feats["content_emb"].shape[0]
    feats["info"]["word_boundaries"] = str(
        [[f"word{i}", i, i + 1] for i in range(w)])
    with open(src, "wb") as f:
        pickle.dump(feats, f)
    out = heatmap.plot_from_pkl(str(src), fname=str(tmp_path / "hm"))
    assert out == str(tmp_path / "hm.png")
    assert os.path.getsize(out) > 1000
