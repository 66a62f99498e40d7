"""The port's CLI (`python -m jegal_torch`, jegal_torch/cli/main.py, with
data/datasets.py and verify.py under it) against the JAX package's CLI on
the CPU, both on the same files: a full-width JEGAL and GestSync `.npz`, a
one-layer XLM-R `.npz` (d 768, 8 heads) and the tiny BPE tokenizer of
tests/tok_util.py as a tokenizer.json, all drawn from seeds.

- `infer` (ta, t, a) through both CLIs, the port with `--device cpu`:
  every .pkl row within rtol = atol = 2e-5 (tests/test_torch_api.py's bar
  on the same kind of weights), info equal.
- `extract-embs` (vta) on a 4-row CSV through both: rows within 2e-5, and
  `info` equal in keys, values and value types (the JAX package stores a
  pandas row; the port reads the CSV with the stdlib, typed as pandas
  does). The port runs batched (batch 2), the JAX CLI per sample.
- `eval-retrieval`, `eval-spotting` and `eval-asd` on the port's files,
  with and without `--on_device`: the same ranks, hits and counts, rates
  within 1e-6, and the same results as the JAX CLI's on its own files.
- `convert`, `verify` (the tower stubbed, as tests/test_verify.py does),
  `warmup` at tiny buckets, and the refusals: missing inputs, `--bf16`,
  `--data_parallel`, `--model_parallel 3` at a world of 4, and every device
  subcommand without a card unless given `--device cpu`; `train
  --model_parallel 2` under two gloo ranks.
- With libav: `extract-feats` on two decoded 270x480 clips (batch 2, two
  decode threads) against the engine on the same decoded planar frames
  (2e-5), then a second run that skips both; and `infer --modalities vta`
  from a video file against `JegalEngine.extract` on its decoded frames,
  with a `--profile_dir` trace.
- `gestsync_features_from_raw_many` refuses a call that mixes host clips
  with clips on a device (meta tensors stand in for the card here).
"""

import json
import os
import pickle
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jegal_torch import api as TAPI
from jegal_torch.cli import main as TCLI
from jegal_torch.convert import checkpoints as TCK
from jegal_torch.convert import (
    init_gestsync_audio_params,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
)
from jegal_torch.models.roberta import RobertaConfig
from jegal_tpu.cli import main as jax_main
from jegal_tpu.convert import checkpoints as JCK
from tok_util import make_tiny_tokenizer
from torch_ref_state_dicts import gestsync_state_dict, jegal_state_dict
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
WORDS = [("hello", 0.04, 0.36), ("big", 0.4, 0.72), ("world", 0.8, 1.2),
         ("abc", 1.24, 1.6)]


def _have_libav() -> bool:
    return shutil.which("pkg-config") is not None and subprocess.run(
        ["pkg-config", "--exists", "libavformat"]).returncode == 0


def write_transcript(path, words):
    lines = ["Text: " + " ".join(w for w, _, _ in words), "Lang: en", "",
             "WORD, START, END, SCORE"]
    lines += [f"{w}, {s}, {e}, 0.9" for w, s, e in words]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_wav(path, seconds: float, seed: int):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    wavfile.write(path, 16000, (rng.standard_normal(int(16000 * seconds))
                                * 3000).astype(np.int16))


def port(argv, capsys=None):
    """The port's CLI on the CPU -> its stdout's JSON, when capsys given."""
    TCLI.main(argv + ["--device", "cpu"])
    if capsys is not None:
        return json.loads(capsys.readouterr().out)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    paths = {k: str(d / f"{k}.npz") for k in ("jegal", "gestsync", "roberta")}
    TCK.save_npz(init_jegal_params(torch.Generator().manual_seed(31)),
                 paths["jegal"])
    TCK.save_npz(init_gestsync_params(torch.Generator().manual_seed(32)),
                 paths["gestsync"])
    TCK.save_roberta_npz(init_roberta_params(
        torch.Generator().manual_seed(33), RobertaConfig(**TINY_XLMR)),
        paths["roberta"], num_heads=8)
    paths["tok"] = str(d / "tokenizer.json")
    make_tiny_tokenizer().save(paths["tok"])
    return paths


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("sample")
    write_transcript(str(d / "clip.txt"), WORDS)
    write_wav(str(d / "clip.wav"), 2.0, 4)
    return {"text": str(d / "clip.txt"), "audio": str(d / "clip.wav")}


def _text_args(ckpts):
    return ["--roberta_path", ckpts["roberta"],
            "--tokenizer_path", ckpts["tok"]]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_rows(got, want):
    for key in ("gesture_emb", "content_emb"):
        if want[key] is None:
            assert got[key] is None, key
            continue
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


@pytest.mark.parametrize("combo", ["ta", "t", "a"])
def test_infer_matches_jax(ckpts, sample, tmp_path, combo):
    common = ["infer", "--checkpoint_path_jegal", ckpts["jegal"],
              *_text_args(ckpts), "--modalities", combo,
              "--text_path", sample["text"], "--audio_path", sample["audio"]]
    jax_main(common + ["--res_dir", str(tmp_path / "jax")])
    port(common + ["--res_dir", str(tmp_path / "port")])
    got = _load(tmp_path / "port" / "clip.pkl")
    want = _load(tmp_path / "jax" / "clip.pkl")
    _same_rows(got, want)
    assert got["content_emb"].shape == (len(WORDS), 512)
    assert got["info"] == want["info"]


def test_infer_missing_args(ckpts):
    for combo in ("a", "v"):
        with pytest.raises(SystemExit):
            port(["infer", "--checkpoint_path_jegal", ckpts["jegal"],
                  "--modalities", combo])


def _train_two_ranks(ckpts, root):
    """`python -m jegal_torch train --model_parallel 2 --device cpu` as two
    ranks of a torchrun launch (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR
    and a free MASTER_PORT on localhost; gloo) over a 3-clip corpus, 2
    steps -> each rank's printed result."""
    import socket
    import sys

    from torch_mesh_worker import finish_ranks, start_ranks
    from torch_tiny import write_corpus

    corpus = write_corpus(root)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_ = s.getsockname()[1]
    argv = [sys.executable, "-m", "jegal_torch", "train", "--file_path",
            corpus["csv"], "--feature_dir", corpus["feat_dir"],
            *_text_args(ckpts), "--steps", "2", "--batch_size", "2",
            "--model_parallel", "2", "--device", "cpu", "--ckpt_dir",
            str(root / "ckpt"), "--log_path", str(root / "train.jsonl")]
    procs = start_ranks([(argv, dict(RANK=str(r), LOCAL_RANK=str(r),
                                     WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                                     MASTER_PORT=str(port_)))
                         for r in range(2)], root / "logs")
    return [json.loads(out.strip().splitlines()[-1])
            for out in finish_ranks(procs, root / "logs")]


@pytest.mark.parametrize("argv", [
    ["infer", "--bf16"], ["extract-feats", "--bf16"],
    ["extract-feats", "--data_parallel"], ["extract-embs", "--bf16"],
    ["verify", "--bf16"], ["warmup", "--bf16"], ["train", "--model_parallel", "2"],
    ["train", "--model_parallel", "3"],
], ids=lambda a: "_".join(a).replace("-", ""))
def test_unported_options_exit(ckpts, argv, monkeypatch, tmp_path):
    """No option waits for a ROADMAP item any more. `--bf16` reaches its
    subcommand with the bf16 dtype. `extract-feats --data_parallel` reaches
    it with no mesh in one process, and with the (2, 1) data mesh under
    two gloo ranks of a torchrun-style launch. `train --model_parallel`
    at 2 trains 2 steps under two gloo ranks, both ranks returning the
    same finite loss, and at 3 with WORLD_SIZE 4 it exits naming the
    divisibility."""
    required = {
        "infer": ["--checkpoint_path_jegal", ckpts["jegal"]],
        "extract-feats": ["--file_path", "x.csv", "--video_dir", "v",
                          "--res_dir", "r", "--checkpoint_path", "g.npz"],
        "extract-embs": ["--file_path", "x.csv", "--checkpoint_path", "j",
                         "--res_dir", "r", "--video_dir", "v",
                         "--feature_dir", "f"],
        "verify": ["--checkpoint_path_jegal", "j", "--samples_dir", "s"],
        "warmup": ["--checkpoint_path", "j"],
        "train": ["--file_path", "x.csv", "--feature_dir", "f",
                  "--roberta_path", "r", "--tokenizer_path", "t"],
    }[argv[0]]
    if argv[1] == "--bf16":
        seen = []
        monkeypatch.setitem(TCLI.COMMANDS, argv[0],
                            lambda args: seen.append(TCLI._dtype(args)))
        port(argv[:1] + required + argv[1:])
        assert seen == [torch.bfloat16]
        return
    if argv == ["train", "--model_parallel", "2"]:
        ranks = _train_two_ranks(ckpts, tmp_path)
        assert ranks[0] == ranks[1] and ranks[0]["steps"] == 2
        assert np.isfinite(ranks[0]["final_loss"])
        lines = (tmp_path / "train.jsonl").read_text().splitlines()
        assert [json.loads(x)["step"] for x in lines] == [1, 2]
        return
    if argv[0] == "train":
        monkeypatch.setenv("WORLD_SIZE", "4")
        with pytest.raises(SystemExit, match="does not divide the 4 ranks"):
            port(argv[:1] + required + argv[1:])
        return
    from torch_mesh_worker import cli_ranks

    seen = []
    monkeypatch.setattr(TCLI, "_extract_feats",
                        lambda args, mesh: seen.append(mesh))
    port(argv[:1] + required + argv[1:])
    assert seen == [None]
    outs = cli_ranks(argv[:1] + required + argv[1:] + ["--device", "cpu"], 2,
                     tmp_path, prelude=(
                         "import json\n"
                         "from jegal_torch.cli import main as M\n"
                         "M._extract_feats = lambda args, mesh: print("
                         "json.dumps([list(mesh.shape), mesh.get_rank()]))"))
    assert [json.loads(o) for o in outs] == [[[2, 1], 0], [[2, 1], 1]]


def test_convert_round_trip(ckpts, tmp_path):
    """Reference-format .pth files -> `convert` -> .npz that both packages
    load to the tree written; an XLM-R .npz converts to one with its head
    count."""
    gs = dict(init_gestsync_params(torch.Generator().manual_seed(1)),
              **init_gestsync_audio_params(torch.Generator().manual_seed(2)))
    jg = init_jegal_params(torch.Generator().manual_seed(3))
    for model, tree, sd in (("gestsync", gs, gestsync_state_dict(gs)),
                            ("jegal", jg, jegal_state_dict(jg))):
        src, dst = str(tmp_path / f"{model}.pth"), str(tmp_path / f"{model}.npz")
        torch.save({"state_dict": sd}, src)
        TCLI.main(["convert", "--model", model, "--src", src, "--dst", dst])
        want = TCK.flatten(tree)
        for got in (TCK.flatten(TCK.load_npz(dst)),
                    JCK._flatten(JCK.load_npz(dst))):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    dst = str(tmp_path / "roberta.npz")
    TCLI.main(["convert", "--model", "roberta", "--src", ckpts["roberta"],
               "--dst", dst])
    _, cfg = JCK.load_roberta(dst)
    assert (cfg.num_layers, cfg.num_heads, cfg.hidden_size) == (1, 8, 768)
    params, _ = TCK.load_roberta(dst)
    want, _ = TCK.load_roberta(ckpts["roberta"])
    for k, v in TCK.flatten(want).items():
        np.testing.assert_array_equal(TCK.flatten(params)[k], v)


# ---------------------------------------------------------------------------
# extract-embs and the evals
# ---------------------------------------------------------------------------

N_ROWS = 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 4-row AVS-style CSV (filename, phrase, word_boundaries,
    target_word_boundary, neg_files, and an int and a float column with an
    empty cell), a .npy GestSync feature bank and a .wav per clip."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(8)
    rows = []
    names = [f"spk{i}/clip{i}" for i in range(N_ROWS)]
    for i, name in enumerate(names):
        os.makedirs(d / "feats" / f"spk{i}", exist_ok=True)
        os.makedirs(d / "videos" / f"spk{i}", exist_ok=True)
        np.save(d / "feats" / f"{name}.npy",
                rng.standard_normal((40, 1024)).astype(np.float32))
        write_wav(str(d / "videos" / f"{name}.wav"), 1.6, 20 + i)
        words = [w for w, _, _ in WORDS[:3 + i % 2]]
        wbs = [[w, 1 + 10 * j, 8 + 10 * j] for j, w in enumerate(words)]
        rows.append([name, " ".join(words), str(wbs), str(wbs[i % len(wbs)]),
                     str([n for n in names if n != name]), 100 + i,
                     "" if i == 2 else f"{0.5 + i}"])
    import csv

    with open(d / "set.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "phrase", "word_boundaries",
                    "target_word_boundary", "neg_files", "start", "score"])
        w.writerows(rows)
    return d


@pytest.fixture(scope="module")
def embs(ckpts, corpus, tmp_path_factory):
    """`extract-embs --modalities vta` through both CLIs -> (port dir, JAX
    dir)."""
    out = tmp_path_factory.mktemp("embs")
    common = ["extract-embs", "--file_path", str(corpus / "set.csv"),
              "--checkpoint_path", ckpts["jegal"], *_text_args(ckpts),
              "--video_dir", str(corpus / "videos"),
              "--feature_dir", str(corpus / "feats")]
    jax_main(common + ["--res_dir", str(out / "jax")])
    port(common + ["--res_dir", str(out / "port"), "--batch_size", "2"])
    return out / "port" / "vta", out / "jax" / "vta"


def test_extract_embs_matches_jax(embs):
    port_dir, jax_dir = embs
    files = sorted(os.listdir(jax_dir))
    assert len(files) == N_ROWS and sorted(os.listdir(port_dir)) == files
    for name in files:
        got, want = _load(port_dir / name), _load(jax_dir / name)
        _same_rows(got, want)
        assert list(got["info"]) == list(want["info"])
        for k, w in want["info"].items():
            g = got["info"][k]
            assert type(g) is type(w), (k, type(g), type(w))
            assert g == w or (np.isnan(g) and np.isnan(w)), (k, g, w)


def test_extract_embs_resumes(ckpts, corpus, embs, capsys):
    port_dir, _ = embs
    stats = port(["extract-embs", "--file_path", str(corpus / "set.csv"),
                  "--checkpoint_path", ckpts["jegal"], *_text_args(ckpts),
                  "--video_dir", str(corpus / "videos"),
                  "--feature_dir", str(corpus / "feats"),
                  "--res_dir", str(port_dir.parent), "--batch_size", "2"],
                 capsys)
    assert stats == {"done": 0, "skipped": N_ROWS, "failed": 0, "invalid": 0}


def _eval_argv(name, path, corpus):
    argv = [name, "--path", str(path)]
    if name == "eval-asd":
        argv += ["--file", str(corpus / "set.csv")]
    return argv


def _same_results(got, want):
    """Counts and ranks equal, rates within 1e-6, nested as the evals
    return them."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _same_results(got[k], w)
        elif isinstance(w, int) or k in ("MR",):
            assert got[k] == w, k
        else:
            assert abs(got[k] - w) <= 1e-6, (k, got[k], w)


@pytest.mark.parametrize("name", ["eval-retrieval", "eval-spotting",
                                  "eval-asd"])
def test_eval_on_device_matches_host(embs, corpus, capsys, name):
    port_dir, jax_dir = embs
    host = port(_eval_argv(name, port_dir, corpus), capsys)
    dev = port(_eval_argv(name, port_dir, corpus) + ["--on_device"], capsys)
    _same_results(dev, host)
    jax_main(_eval_argv(name, jax_dir, corpus))
    _same_results(host, json.loads(capsys.readouterr().out))


def test_heatmap(embs, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    port_dir, _ = embs
    pkl = sorted(port_dir.iterdir())[0]
    TCLI.main(["heatmap", "--path", str(pkl),
               "--fname", str(tmp_path / "h")])
    out = json.loads(capsys.readouterr().out)["saved"]
    assert os.path.exists(out)


# ---------------------------------------------------------------------------
# verify, warmup, the device refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def samples_dir(tmp_path):
    for i, seed in ((1, 5), (2, 6)):
        write_transcript(str(tmp_path / f"sample{i}.txt"), WORDS[:2 + i])
        write_wav(str(tmp_path / f"sample{i}.wav"), 2.0, seed)
    return tmp_path


def test_verify_against_goldens(ckpts, samples_dir, tmp_path, capsys):
    """Goldens from a first run pass (exit 0); one rolled golden row fails
    with exit 1."""
    base = ["verify", "--checkpoint_path_jegal", ckpts["jegal"],
            *_text_args(ckpts), "--samples_dir", str(samples_dir)]
    golden = tmp_path / "golden"
    verdict = port(base + ["--res_dir", str(golden)], capsys)
    assert verdict["ok"] and verdict["combos"] == ["ta", "t", "a"]
    verdict = port(base + ["--res_dir", str(tmp_path / "again"),
                           "--golden_dir", str(golden)], capsys)
    assert verdict["ok"]
    assert verdict["samples"]["sample1"]["ta"]["golden"]["ok"]
    d = _load(golden / "sample1_ta.pkl")
    d["content_emb"] = np.roll(d["content_emb"], 1, axis=0)
    with open(golden / "sample1_ta.pkl", "wb") as f:
        pickle.dump(d, f)
    with pytest.raises(SystemExit) as e:
        port(base + ["--res_dir", str(tmp_path / "bad"),
                     "--golden_dir", str(golden)])
    assert e.value.code == 1
    verdict = json.loads(capsys.readouterr().out)
    assert not verdict["samples"]["sample1"]["ta"]["golden"]["ok"]
    assert verdict["samples"]["sample2"]["ta"]["golden"]["ok"]


def test_verify_visual_combos(ckpts, samples_dir, tmp_path, capsys,
                              monkeypatch):
    """With GestSync weights every combo runs and the retrieval smoke
    fires; the decode and the tower are stubbed to keep this CPU-fast (the
    tower is held to JAX elsewhere), as tests/test_verify.py does."""
    rng = np.random.default_rng(0)
    monkeypatch.setattr(TCLI, "_decode_for_features", lambda path: (
        np.zeros((40, 90, 27, 160), np.uint8), None))
    monkeypatch.setattr(
        TAPI.JegalEngine, "_tower", lambda self, kind, frames, cut, batched:
        torch.from_numpy(rng.standard_normal(
            (1, frames.shape[0], 1024)).astype(np.float32)))
    verdict = port(["verify", "--checkpoint_path_jegal", ckpts["jegal"],
                    "--checkpoint_path_gestsync", ckpts["gestsync"],
                    *_text_args(ckpts), "--samples_dir", str(samples_dir),
                    "--res_dir", str(tmp_path / "v")], capsys)
    assert verdict["ok"], verdict
    assert verdict["combos"] == ["vta", "vt", "va", "ta", "v", "t", "a"]
    assert verdict["samples"]["sample1"]["vta"]["gesture_shape"] == [40, 512]
    assert set(verdict["retrieval_smoke"]) == {"c2g", "g2c"}


def test_warmup_cli(ckpts, capsys):
    out = port(["warmup", "--checkpoint_path", ckpts["jegal"],
                "--modalities", "a", "--w_buckets", "8",
                "--mel_buckets", "64"], capsys)
    assert [(g["combo"], g["w"], g["mel"]) for g in out["graphs"]] == [
        ("a", 8, 64)]
    assert out["total_seconds"] > 0


@pytest.mark.parametrize("cmd", ["infer", "extract-feats", "extract-embs",
                                 "eval-retrieval", "verify", "warmup",
                                 "train"])
def test_device_subcommands_need_a_card(ckpts, sample, corpus, embs,
                                        tmp_path, cmd):
    """Without `--device cpu` each device subcommand runs on the card, and
    with no card it raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = {
        "infer": ["--checkpoint_path_jegal", ckpts["jegal"],
                  "--modalities", "a", "--audio_path", sample["audio"],
                  "--text_path", sample["text"]],
        "extract-feats": ["--file_path", str(corpus / "set.csv"),
                          "--video_dir", str(tmp_path), "--res_dir",
                          str(tmp_path / "r"), "--checkpoint_path",
                          ckpts["gestsync"]],
        "extract-embs": ["--file_path", str(corpus / "set.csv"),
                         "--checkpoint_path", ckpts["jegal"],
                         "--modalities", "a", "--res_dir", str(tmp_path),
                         "--video_dir", str(corpus / "videos"),
                         "--feature_dir", str(corpus / "feats")],
        "eval-retrieval": ["--path", str(embs[0]), "--on_device"],
        "verify": ["--checkpoint_path_jegal", ckpts["jegal"],
                   "--samples_dir", str(tmp_path)],
        "warmup": ["--checkpoint_path", ckpts["jegal"], "--modalities", "a"],
        "train": ["--file_path", str(corpus / "set.csv"), "--feature_dir",
                  str(corpus / "feats"), *_text_args(ckpts)],
    }[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main([cmd] + argv)


def test_shard_resolution(monkeypatch):
    import argparse

    import torch.distributed as dist

    ns = argparse.Namespace
    assert TCLI._resolve_shard(ns(rank=None, nshard=None)) == (0, 1)
    assert TCLI._resolve_shard(ns(rank=2, nshard=3)) == (2, 3)
    # a torchrun launch that joins no group: the launcher's RANK and
    # WORLD_SIZE, each flag still winning
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert TCLI._resolve_shard(ns(rank=None, nshard=None)) == (2, 3)
    assert TCLI._resolve_shard(ns(rank=0, nshard=None)) == (0, 3)
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert TCLI._resolve_shard(ns(rank=None, nshard=None)) == (1, 4)
    assert TCLI._resolve_shard(ns(rank=0, nshard=None)) == (0, 4)


def test_raw_many_refuses_mixed_host_and_device_clips(ckpts):
    eng = TAPI.JegalEngine(TCK.load_jegal(ckpts["jegal"]),
                           TCK.load_gestsync(ckpts["gestsync"]),
                           device="cpu")
    host = np.zeros((8, 90, 27, 160), np.uint8)
    dev = torch.empty((8, 90, 27, 160), dtype=torch.uint8, device="meta")
    with pytest.raises(TAPI.ClientError, match="not a mix"):
        eng.gestsync_features_from_raw_many([(host, None), (dev, None)])
    with pytest.raises(TAPI.ClientError, match="another device"):
        eng.gestsync_features_from_raw_many([(dev, None)])


# ---------------------------------------------------------------------------
# Decoded clips (libav): extract-feats and infer from a video file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    if not _have_libav():
        pytest.skip("no libav headers (pkg-config libavformat fails)")
    from jegal_torch.host import media

    d = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(9)
    names = ["spk/c0", "spk/c1"]
    os.makedirs(d / "spk")
    for name, t in zip(names, (8, 6)):
        base = np.linspace(0, 255, 480, dtype=np.uint8)[None, None, :, None]
        frames = np.broadcast_to(base, (t, 270, 480, 3)) + rng.integers(
            0, 16, (t, 270, 480, 3), np.uint8)
        media.encode_video(str(d / f"{name}.avi"), frames, fps=25.0)
    with open(d / "feats.csv", "w") as f:
        f.write("filename\n" + "\n".join(names) + "\n")
    return d, names


def test_extract_feats_matches_engine_and_resumes(ckpts, videos, capsys):
    d, names = videos
    argv = ["extract-feats", "--file_path", str(d / "feats.csv"),
            "--video_dir", str(d), "--res_dir", str(d / "feats"),
            "--checkpoint_path", ckpts["gestsync"], "--batch_size", "2",
            "--decode_workers", "2"]
    assert port(argv, capsys) == {"done": 2, "skipped": 0, "failed": 0}
    eng = TAPI.JegalEngine(None, TCK.load_gestsync(ckpts["gestsync"]),
                           device="cpu")
    for name, t in zip(names, (8, 6)):
        planar, chin = TCLI._decode_for_features(str(d / f"{name}.avi"))
        assert planar.shape == (t, 90, 27, 160) and chin is None
        got = np.load(d / "feats" / f"{name}.npy")
        np.testing.assert_allclose(got, eng.gestsync_features(planar), **TOL)
    assert port(argv, capsys) == {"done": 0, "skipped": 2, "failed": 0}


def test_infer_vta_from_video(ckpts, sample, videos, tmp_path):
    d, names = videos
    video = str(d / f"{names[0]}.avi")
    TCLI.main(["infer", "--checkpoint_path_jegal", ckpts["jegal"],
               "--checkpoint_path_gestsync", ckpts["gestsync"],
               *_text_args(ckpts), "--modalities", "vta",
               "--video_path", video, "--text_path", sample["text"],
               "--audio_path", sample["audio"], "--res_dir", str(tmp_path),
               "--profile_dir", str(tmp_path / "trace"), "--device", "cpu"])
    got = _load(tmp_path / "c0.pkl")
    from jegal_torch.host.media import load_audio_any
    from jegal_torch.text.normalize import load_text
    from jegal_torch.text.tokenizer import WordTokenizer

    eng = TAPI.JegalEngine(
        TCK.load_jegal(ckpts["jegal"]), TCK.load_gestsync(ckpts["gestsync"]),
        device="cpu", roberta_params=TCK.load_roberta(ckpts["roberta"])[0],
        roberta_cfg=TCK.load_roberta(ckpts["roberta"])[1],
        tokenizer=WordTokenizer.from_file(ckpts["tok"]))
    text, wbs = load_text(sample["text"])
    planar, _ = TCLI._decode_for_features(video)
    want = eng.extract("vta", frames=planar, text=text, word_boundaries=wbs,
                       wav=load_audio_any(sample["audio"]), fname="c0")
    _same_rows(got, want)
    assert got["gesture_emb"].shape == (8, 512)
    assert got["info"] == want["info"]
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")


def test_profiling_utilities(tmp_path):
    """`--profile_dir`'s trace (a Chrome trace holding annotated regions),
    time_jitted and device_sync."""
    from jegal_torch.utils import profiling as P

    with P.trace(str(tmp_path)):
        with P.annotate("jegal-region"):
            torch.ones(8) @ torch.ones(8)
    trace, = tmp_path.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert "jegal-region" in {e.get("name") for e in events}
    assert P.time_jitted(lambda x: x * 2, (torch.ones(4),), iters=3) > 0
    P.device_sync({"a": torch.ones(2), "b": [torch.zeros(1)]})
