"""Data-parallel inference on the port's ('data', 'model') mesh
(jegal_torch/parallel/mesh.py over torch.distributed), on gloo CPU ranks
(tests/torch_mesh_worker.py, `infer` task), against the JAX package's own
mesh calls on the 8-virtual-device CPU mesh (`make_mesh(2, 1)`, run as
tests/test_batch_extract.py runs them) and the port's one-rank calls on
the same weights (seeded trees, numpy data from seeds).

- Meshes: (2, 1), where a chunk of 3 samples pads to 4 rows, 2 a rank;
  (2, 2) on the cheap `ta` combo, where the two model ranks of a data
  index compute the same rows.
- `shard_batch_tower` (raw and planar frames) and the engine's
  `gestsync_features_from_raw_many(mesh=)` against the JAX engine's
  `gestsync_features_from_raw_many(mesh=)`, which wraps its CPU tower in
  JAX's `shard_batch_tower` (JAX's `extract_features_batch_raw_sharded`
  reaches the Pallas stem, interpreted at full size off the TPU);
  `extract_many(mesh=)` on `ta` (visual features) and on `v` from raw
  frames against JAX's `extract_many(mesh=)` and the port's one rank;
  every rank returning the same results, bit for bit.
- `warmup(mesh=)` then live calls of the same shapes: no graph added.
- The three `evaluate_device(mesh=)` against JAX's and the port's one
  rank, with sets that pad (51, 23 and 25 rows).
- A two-rank server (rank 0 serves, rank 1 follows) answering concurrent
  requests as one rank does, then shutting down; `serve(mesh=)` without
  a window raises.
- The CLI: `extract-embs --batch_size 2` under two torchrun-style ranks
  writes the one rank's .pkl files; `extract-feats --data_parallel` under
  two (the decoder replaced by the clips' repack) saves JAX's features
  from rank 0 alone; an explicit `--rank` / `--nshard` under a data mesh
  exits.

Tolerances: the JAX tests' own (tests/test_batch_extract.py), rtol = atol
= 2e-5 for gesture embeddings and tower features, 5e-4 for the `ta`
content embeddings.
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from jegal_tpu import api as JAPI
from jegal_tpu.eval import asd as JASD
from jegal_tpu.eval import retrieval as JRET
from jegal_tpu.eval import spotting as JSPOT
from jegal_tpu.models import roberta as JR
from jegal_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from jegal_torch import serving as TS
from jegal_torch.cli import main as TCLI
from jegal_torch.convert import checkpoints as TCK
from jegal_torch.eval import asd, retrieval, spotting
from jegal_torch.parallel import mesh as M
from tok_util import make_tiny_tokenizer
from torch_mesh_worker import (
    CLIP_T,
    TINY_XLMR,
    Job,
    cli_ranks,
    finish_ranks,
    infer_clips,
    infer_engine,
    infer_samples,
    infer_weights,
    start_cli_ranks,
)
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
CONTENT_TOL = dict(rtol=5e-4, atol=5e-4)


def _write_pkl(path, gesture, content, info):
    with open(path, "wb") as f:
        pickle.dump({"gesture_emb": gesture, "content_emb": content,
                     "info": info}, f)


@pytest.fixture(scope="module")
def eval_sets(tmp_path_factory):
    """51 retrieval videos and 25 ASD queries over 12 speakers, noisy
    enough that ranks and picks spread; 23 spotting videos (every other
    with its target's peak planted)."""
    rng = np.random.default_rng(76)
    root = tmp_path_factory.mktemp("evals")
    ret, spot, asd_dir = root / "ret", root / "spot", root / "asd"
    for d in (ret, spot, asd_dir):
        d.mkdir()
    base = rng.standard_normal((51, 64)).astype(np.float32)
    for i in range(51):
        t, w = int(rng.integers(4, 12)), int(rng.integers(2, 6))
        _write_pkl(ret / f"v{i:02d}.pkl",
                   (base[i] + 6.0 * rng.standard_normal((t, 64)))
                   .astype(np.float32),
                   (base[i] + 6.0 * rng.standard_normal((w, 64)))
                   .astype(np.float32), {"fname": f"v{i:02d}"})
    for i in range(23):
        t, w = int(rng.integers(20, 48)), int(rng.integers(2, 9))
        content = rng.standard_normal((w, 64)).astype(np.float32)
        gesture = 0.05 * rng.standard_normal((t, 64)).astype(np.float32)
        wi = int(rng.integers(0, w))
        span = sorted(rng.integers(0, t, size=2).tolist())
        if i % 2 == 0:
            gesture[span[0]] = content[wi] * 8
        wbs = [[f"w{j}", j, j + 1] for j in range(w)]
        wbs[wi] = [f"w{wi}", span[0], span[1]]
        _write_pkl(spot / f"v{i:02d}.pkl", gesture, content,
                   {"word_boundaries": str(wbs),
                    "target_word_boundary": str(wbs[wi])})
    speakers = rng.standard_normal((12, 512)).astype(np.float32)
    names = [f"s{i}/clip" for i in range(12)]
    for i, n in enumerate(names):
        _write_pkl(asd_dir / (n.replace("/", "__") + ".pkl"),
                   np.tile(speakers[i] + 12.0 * rng.standard_normal(512)
                           .astype(np.float32), (5, 1)),
                   np.tile(speakers[i], (3, 1)), {})
    rows = []
    for i in range(25):
        qi = int(rng.integers(0, 12))
        negs = [names[j] for j in rng.permutation(12)[:int(rng.integers(1, 7))]
                if j != qi]
        rows.append({"filename": names[qi], "neg_files": str(negs)})
    return dict(retrieval=str(ret), spotting=str(spot), asd=str(asd_dir),
                asd_rows=rows)


@pytest.fixture(scope="module")
def ckpt_files(tmp_path_factory):
    jp, gp, rp, _ = infer_weights()
    d = tmp_path_factory.mktemp("ckpts")
    paths = {k: str(d / f"{k}.npz") for k in ("jegal", "gestsync",
                                              "roberta")}
    TCK.save_npz(jp, paths["jegal"])
    TCK.save_npz(gp, paths["gestsync"])
    TCK.save_roberta_npz(rp, paths["roberta"], num_heads=8)
    paths["tok"] = str(d / "tokenizer.json")
    make_tiny_tokenizer().save(paths["tok"])
    return paths


@pytest.fixture(scope="module")
def started(eval_sets, ckpt_files, tmp_path_factory):
    """Every gloo launch of the module, started before the references are
    computed here, so that they run beside them: the `infer` task at (2,
    1) with every case and at (2, 2) on `ta`, and `extract-feats
    --data_parallel --batch_size 4` on clip0..clip2 under two ranks, with
    `_decode_for_features` replaced by the clips' repack."""
    d = tmp_path_factory.mktemp("feats")
    (d / "feats.csv").write_text(
        "filename\n" + "".join(f"clip{i}\n" for i in range(len(CLIP_T))))
    feats = start_cli_ranks(
        ["extract-feats", "--file_path", str(d / "feats.csv"),
         "--video_dir", str(d), "--res_dir", str(d / "out"),
         "--checkpoint_path", ckpt_files["gestsync"], "--batch_size", "4",
         "--decode_workers", "1", "--data_parallel", "--device", "cpu"],
        2, d / "logs", prelude=(
            "import torch_mesh_worker as W\n"
            "from jegal_torch.cli import main as CLI\n"
            "CLI._decode_for_features = W.fake_decode\n"))
    return {
        (2, 1): Job("infer", 2, tmp_path_factory.mktemp("infer21"),
                    dict(mp=1, tower=True, evals=eval_sets, serve=True)),
        (2, 2): Job("infer", 4, tmp_path_factory.mktemp("infer22"),
                    dict(mp=2)),
        "feats": (feats, d),
    }


@pytest.fixture(scope="module")
def ranks21(started, jax_refs, one_rank):
    return started[(2, 1)].results()


@pytest.fixture(scope="module")
def ranks22(started, jax_refs, one_rank):
    return started[(2, 2)].results()


@pytest.fixture(scope="module")
def cli_feats(started, jax_refs, one_rank):
    """-> (each extract-feats rank's stdout, its features directory)."""
    procs, d = started["feats"]
    return finish_ranks(procs, d / "logs"), d / "out"


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def jax_refs(started, eval_sets):
    """The JAX package's mesh calls at (2, 1) on the same inputs."""
    jp, gp, rp, _ = infer_weights()
    engine = JAPI.JegalEngine(
        jegal_params=_np(jp), gestsync_params=_np(gp),
        roberta_params=_np(rp), roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()))
    mesh = jax_make_mesh(2, model_parallel=1)
    clips = infer_clips()
    with mesh:
        out = dict(
            ta=engine.extract_many(infer_samples(), "ta", batch_size=4,
                                   mesh=mesh),
            v=engine.extract_many(
                [dict(frames=f, chin_rows=c, fname=f"clip{i}")
                 for i, (f, c) in enumerate(clips)], "v", batch_size=4,
                mesh=mesh),
            tower=[np.asarray(x) for x in
                   engine.gestsync_features_from_raw_many(
                       clips, batch_size=4, mesh=mesh)],
            retrieval=JRET.evaluate_device(eval_sets["retrieval"], mesh),
            spotting=JSPOT.evaluate_device(eval_sets["spotting"], mesh=mesh),
            asd=JASD.evaluate_device(eval_sets["asd"],
                                     pd.DataFrame(eval_sets["asd_rows"]),
                                     mesh))
    return out


@pytest.fixture(scope="module")
def one_rank(started, eval_sets):
    """The port's one-rank calls (no mesh) on the same inputs."""
    engine = infer_engine()
    out = dict(
        ta=engine.extract_many(infer_samples(), "ta", batch_size=4),
        v=engine.extract_many(
            [dict(frames=f, chin_rows=c, fname=f"clip{i}")
             for i, (f, c) in enumerate(infer_clips())], "v", batch_size=4),
        retrieval=retrieval.evaluate_device(eval_sets["retrieval"], "cpu"),
        spotting=spotting.evaluate_device(eval_sets["spotting"],
                                          device="cpu"),
        spot_preds=spotting.predict_device(eval_sets["spotting"], "cpu"),
        asd=asd.evaluate_device(eval_sets["asd"],
                                TCLI.Rows(eval_sets["asd_rows"]), "cpu"))
    engine.close()
    return out


def _same_emb(got, want, key, tol):
    if want[key] is None:
        assert got[key] is None
        return
    assert got[key].shape == want[key].shape and got[key].dtype == np.float32
    np.testing.assert_allclose(got[key], want[key], **tol, err_msg=key)


def _ranks_equal(ranks, key):
    """Every rank's `key` results bit for bit rank 0's."""
    first = ranks[0][key]
    for r in ranks[1:]:
        for a, b in zip(r[key], first):
            if isinstance(b, dict):
                for k in ("gesture_emb", "content_emb"):
                    assert (a[k] is None) == (b[k] is None)
                    if b[k] is not None:
                        np.testing.assert_array_equal(a[k], b[k])
                assert a["info"] == b["info"]
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["tower_raw", "tower_planar", "raw_many"])
def test_sharded_tower_matches_jax(ranks21, jax_refs, kind):
    """shard_batch_tower on raw and on planar frames, and the engine's
    batched tower under the mesh, clip by clip."""
    _ranks_equal(ranks21, kind)
    for got, want, t in zip(ranks21[0][kind], jax_refs["tower"], CLIP_T):
        assert np.asarray(got).shape == (t, 1024)
        np.testing.assert_allclose(np.asarray(got), want, **TOL)


@pytest.mark.parametrize("combo", ["ta", "v"])
def test_extract_many_mesh_matches_jax_and_one_rank(ranks21, jax_refs,
                                                    one_rank, combo):
    _ranks_equal(ranks21, combo)
    tol = CONTENT_TOL if combo == "ta" else TOL
    for got, want, one in zip(ranks21[0][combo], jax_refs[combo],
                              one_rank[combo]):
        for key in ("gesture_emb", "content_emb"):
            _same_emb(got, want, key, tol)
            _same_emb(got, one, key, tol)
        assert got["info"] == one["info"]


def test_model_ranks_replicate_2x2(ranks22, jax_refs, one_rank):
    """At (2, 2) the four ranks return the same `ta` results, JAX's and
    one rank's."""
    assert len(ranks22) == 4
    _ranks_equal(ranks22, "ta")
    for got, want, one in zip(ranks22[0]["ta"], jax_refs["ta"],
                              one_rank["ta"]):
        _same_emb(got, want, "content_emb", CONTENT_TOL)
        _same_emb(got, one, "content_emb", CONTENT_TOL)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_warmup_mesh_leaves_nothing_to_capture(ranks21, ranks22, mesh):
    """warmup(mesh=) captures what the live mesh calls replay: the `ta`
    chunk and (2, 1) the fused `v` chunk, each of b / dp = 2 rows."""
    ranks = ranks21 if mesh == "2x1" else ranks22
    for r in ranks:
        assert r["graphs_added"] == []
        assert r["graphs"] == (2 if mesh == "2x1" else 1)


@pytest.mark.parametrize("name", ["retrieval", "spotting", "asd"])
def test_evaluate_device_mesh(ranks21, jax_refs, one_rank, name):
    """Every rank's metrics those of JAX's mesh call and the port's one
    rank (counts equal, rates within 1e-6); spotting's predicted frames
    equal and scores within 1e-6 on every rank."""
    def flat(res):
        return {f"{k}/{kk}": float(vv) for k, v in res.items()
                for kk, vv in (v.items() if isinstance(v, dict)
                               else [("", v)])}

    want = flat(one_rank[name])
    assert flat(jax_refs[name]) == pytest.approx(want, abs=1e-6)
    for r in ranks21:
        assert flat(r[name]) == pytest.approx(want, abs=1e-6)
    if name == "spotting":
        for r in ranks21:
            for (tg, p, sc), (tw, pw, sw) in zip(r["spot_preds"],
                                                 one_rank["spot_preds"]):
                assert (tg, p) == (tw, pw) and sc == pytest.approx(sw,
                                                                   abs=1e-6)


def test_two_rank_server_answers_as_one_rank(ranks21, one_rank):
    """Rank 0 answered three concurrent `ta` requests as one rank's
    extract_many, /healthz was ok, and rank 1 followed until the server
    closed (both ranks exited 0)."""
    assert ranks21[1]["followed"] is True
    assert ranks21[0]["healthz"]["ok"] is True
    for (status, got), one in zip(ranks21[0]["served"], one_rank["ta"]):
        assert status == 200 and got["gesture_emb"] is None
        np.testing.assert_allclose(got["content_emb"], one["content_emb"],
                                   **CONTENT_TOL)


def test_serve_mesh_needs_a_window():
    for call in (lambda: TS.serve(None, mesh="mesh", batch_window_ms=0),
                 lambda: TS.create_server(None, mesh="mesh", port=0)):
        with pytest.raises(ValueError, match="batch_window_ms > 0"):
            call()


def test_extract_feats_data_parallel(cli_feats, jax_refs):
    """Rank 0 prints the stats and saves each clip's features (JAX's);
    rank 1 prints nothing."""
    outs, res_dir = cli_feats
    assert json.loads(outs[0]) == {"done": 3, "skipped": 0, "failed": 0}
    assert outs[1] == ""
    for i, want in enumerate(jax_refs["tower"]):
        np.testing.assert_allclose(np.load(res_dir / f"clip{i}.npy"), want,
                                   **TOL)


def _corpus(root):
    """A 5-row AVS-style CSV (spk/c<i>: visual features, a wav, a 3-word
    phrase)."""
    import csv

    from scipy.io import wavfile

    rng = np.random.default_rng(77)
    (root / "feats" / "spk").mkdir(parents=True)
    (root / "videos" / "spk").mkdir(parents=True)
    rows = []
    for i in range(5):
        np.save(root / "feats" / "spk" / f"c{i}.npy",
                rng.standard_normal((20 + 4 * i, 1024)).astype(np.float32))
        wavfile.write(root / "videos" / "spk" / f"c{i}.wav", 16000,
                      (rng.standard_normal(16000) * 3000).astype(np.int16))
        wbs = [["ab", 1, 8], ["hello", 11, 18], ["x", 21, 28]]
        rows.append([f"spk/c{i}", "ab hello x", str(wbs)])
    with open(root / "set.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "phrase", "word_boundaries"])
        w.writerows(rows)


def test_extract_embs_two_ranks_writes_one_ranks_files(ckpt_files,
                                                       tmp_path, capsys):
    _corpus(tmp_path)
    common = ["extract-embs", "--file_path", str(tmp_path / "set.csv"),
              "--checkpoint_path", ckpt_files["jegal"],
              "--roberta_path", ckpt_files["roberta"],
              "--tokenizer_path", ckpt_files["tok"],
              "--video_dir", str(tmp_path / "videos"),
              "--feature_dir", str(tmp_path / "feats"), "--batch_size", "2",
              "--device", "cpu"]
    TCLI.main(common + ["--res_dir", str(tmp_path / "one")])
    one = json.loads(capsys.readouterr().out)
    outs = cli_ranks(common + ["--res_dir", str(tmp_path / "two")], 2,
                     tmp_path / "logs")
    assert json.loads(outs[0]) == one == {"done": 5, "skipped": 0,
                                          "failed": 0, "invalid": 0}
    assert outs[1] == ""
    names = sorted(os.listdir(tmp_path / "one" / "vta"))
    assert len(names) == 5 and sorted(os.listdir(tmp_path / "two" / "vta")) \
        == names
    for name in names:
        with open(tmp_path / "one" / "vta" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "two" / "vta" / name, "rb") as f:
            got = pickle.load(f)
        _same_emb(got, want, "gesture_emb", TOL)
        _same_emb(got, want, "content_emb", CONTENT_TOL)
        assert got["info"] == want["info"]


@pytest.mark.parametrize("argv", [
    ["extract-feats", "--data_parallel", "--rank", "0"],
    ["extract-embs", "--batch_size", "2", "--nshard", "2"],
], ids=["extract_feats_rank", "extract_embs_nshard"])
def test_explicit_shard_under_data_mesh_exits(argv, monkeypatch):
    required = {
        "extract-feats": ["--file_path", "x.csv", "--video_dir", "v",
                          "--res_dir", "r", "--checkpoint_path", "g.npz"],
        "extract-embs": ["--file_path", "x.csv", "--checkpoint_path", "j",
                         "--res_dir", "r", "--video_dir", "v",
                         "--feature_dir", "f"],
    }[argv[0]]
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="conflict with the data mesh"):
        TCLI.main(argv[:1] + required + argv[1:] + ["--device", "cpu"])


class _FakeMesh:
    """What batch_rows reads of a DeviceMesh: the 'data' size and index."""

    def __init__(self, dp, d):
        self.dp, self.d = dp, d

    def size(self, dim):
        return self.dp

    def get_local_rank(self, axis):
        return self.d


def test_row_helpers():
    assert M.data_size(None) == 1 and M.round_to_data(3, None) == 3
    assert M.batch_rows(5, None) == slice(0, 5)
    mesh = _FakeMesh(2, 1)
    assert M.data_size(mesh) == 2 and M.round_to_data(3, mesh) == 4
    assert M.batch_rows(4, mesh) == slice(2, 4)
    with pytest.raises(ValueError, match="equal"):
        M.batch_rows(3, mesh)
    x = torch.arange(6.0)
    assert M.gather_rows(x, None) is x
    assert M.broadcast_object({"a": 1}, None) == {"a": 1}
    M.check_same([1], None, "nothing")
