"""The port's training slice (jegal_torch/training, parallel/checkpoint.py)
against the JAX package on the CPU: the loss and every JEGAL gradient leaf,
the optimizer (AdamW under warmup / cosine schedules and MultiSteps
accumulation) against optax, the modality gates, remat, accumulation, the
data pipeline's windows and batches, checkpoints, and the loop with resume.

Weights are drawn by jegal_torch.convert.init_* (randomized BatchNorm
statistics and LayerNorm parameters, which identity values would let a
skipped or doubled norm pass) and handed to JAX as numpy; the encoders are
cut to 2 layers and XLM-R to 1 layer of a 128-token vocabulary to keep the
JAX side's compile short. Tolerances: loss rtol = atol = 2e-5, gradients
rtol 1e-4 / atol 1e-5, optimizer parameters atol 1e-6."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.models import roberta as JR
from jegal_tpu.training import data as JD
from jegal_tpu.training import trainer as JTR
from jegal_torch.convert import (
    init_jegal_params,
    init_roberta_params,
    tree_to_torch,
)
from jegal_torch.models import roberta as TR_R
from jegal_torch.ops import pooling as P
from jegal_torch.parallel import checkpoint as CK
from jegal_torch.text.tokenizer import WordTokenizer
from jegal_torch.training import data as TD
from jegal_torch.training import loop as TL
from jegal_torch.training import trainer as TR
from tok_util import make_tiny_tokenizer, make_word_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def _tiny_jegal(seed: int, layers: int):
    params = init_jegal_params(torch.Generator().manual_seed(seed))
    for enc in ("encoder_rgb", "encoder_text"):
        params[enc]["layers"] = params[enc]["layers"][:layers]
    return params


def _tiny_roberta(seed: int, vocab: int, max_pos: int):
    cfg = TR_R.RobertaConfig(vocab_size=vocab, num_layers=1,
                             max_position_embeddings=max_pos)
    return init_roberta_params(torch.Generator().manual_seed(seed), cfg), cfg


def _batch(rng, b, t, s, w, mel, vocab):
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


@pytest.fixture(scope="module")
def setup():
    jp = _tiny_jegal(1, 2)
    rp, cfg = _tiny_roberta(2, 128, 32)
    batch = _batch(np.random.default_rng(0), b=4, t=8, s=16, w=4, mel=32,
                   vocab=128)
    jax_cfg = JR.RobertaConfig(**vars(cfg))
    rp_j = jax.tree.map(jnp.asarray, _as_numpy(rp))
    batch_j = jax.tree.map(jnp.asarray, batch)

    @jax.jit
    def jax_loss_grad(params, gates):
        return jax.value_and_grad(lambda p: JTR.info_nce(
            *JTR.video_level_embeddings(p, rp_j, batch_j, jax_cfg, gates)))(
                params)

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return dict(jp=jp, jp_np=_as_numpy(jp), rp=rp, cfg=cfg, batch=tbatch,
                jax_loss_grad=jax_loss_grad)


@pytest.mark.parametrize("gates", [(1.0, 1.0), (0.0, 1.0), (1.0, 0.0)])
def test_loss_and_every_gradient_match_jax(setup, gates):
    want_loss, want_grads = setup["jax_loss_grad"](setup["jp_np"], gates)
    params = TR._trainable(setup["jp"])
    leaves = TR.param_leaves(params)
    loss = TR.loss_fn(params, setup["rp"], setup["batch"], gates,
                      setup["cfg"])
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = TR.param_leaves(tree_to_torch(want_grads))
    assert len(want) == len(leaves)
    for i, (g, w) in enumerate(zip(grads, want)):
        g = torch.zeros_like(w) if g is None else g
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL,
                                   err_msg=f"leaf {i} {tuple(w.shape)}")


def test_unused_heads_get_zero_gradients_and_bn_statistics_train(setup):
    params = TR._trainable(setup["jp"])
    loss = TR.loss_fn(params, setup["rp"], setup["batch"], (1.0, 1.0),
                      setup["cfg"])
    heads = TR.param_leaves([params["proj_op_align_gesture"],
                             params["proj_op_align_content"]])
    bn = TR.param_leaves([[blk["bn"]["mean"], blk["bn"]["var"]]
                          for blk in params["cnn"] if "bn" in blk])
    grads = torch.autograd.grad(loss, heads + bn, allow_unused=True)
    assert all(g is None for g in grads[:len(heads)])
    assert all(g is not None and g.abs().max() > 0 for g in grads[len(heads):])


def test_remat_gives_the_same_loss_and_gradients(setup):
    out = []
    for remat in (False, True):
        params = TR._trainable(setup["jp"])
        loss = TR.loss_fn(params, setup["rp"], setup["batch"], (1.0, 1.0),
                          setup["cfg"], remat=remat)
        g = torch.autograd.grad(loss, params["proj_op_rgb"]["kernel"])[0]
        out.append((loss.item(), g))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-5, atol=1e-7)


def test_accumulation_updates_every_k(setup):
    opt = TR.make_optimizer(lr=3e-4, accum_steps=2)
    state = TR.init_state(setup["jp"], opt)
    p0 = state.params["proj_op_rgb"]["kernel"].detach().clone()
    kw = dict(roberta_params=setup["rp"], roberta_cfg=setup["cfg"],
              optimizer=opt)
    state, l1 = TR.train_step(state, setup["batch"], (1.0, 1.0), **kw)
    torch.testing.assert_close(state.params["proj_op_rgb"]["kernel"], p0,
                               rtol=0, atol=0)
    state, l2 = TR.train_step(state, setup["batch"], (1.0, 1.0), **kw)
    assert (state.params["proj_op_rgb"]["kernel"] - p0).abs().max() > 0
    assert state.step == 2 and state.opt_state.gradient_step == 1
    assert np.isfinite([l1.item(), l2.item()]).all()
    # the caller's tree is never updated in place
    torch.testing.assert_close(setup["jp"]["proj_op_rgb"]["kernel"], p0,
                               rtol=0, atol=0)


def test_modality_drop_gates_distribution():
    g = torch.Generator().manual_seed(0)
    gates = np.array([TR.modality_drop_gates(g) for _ in range(400)])
    both = ((gates[:, 0] == 1) & (gates[:, 1] == 1)).mean()
    only_text = ((gates[:, 0] == 0) & (gates[:, 1] == 1)).mean()
    only_audio = ((gates[:, 0] == 1) & (gates[:, 1] == 0)).mean()
    assert 0.4 < both < 0.6
    assert 0.15 < only_text < 0.35
    assert 0.15 < only_audio < 0.35
    assert not ((gates[:, 0] == 0) & (gates[:, 1] == 0)).any()


def _opt_tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)},
            "z": rng.standard_normal((2, 2)).astype(np.float32)}


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, warmup_steps=3, total_steps=8, accum_steps=2),
    dict(lr=1e-2, warmup_steps=1, total_steps=8, accum_steps=3),
    dict(lr=1e-2, total_steps=6),
    dict(lr=1e-2, warmup_steps=4),
    dict(lr=1e-2, weight_decay=0.1),
], ids=["warmup-cosine-accum2", "warmup-below-accum3", "cosine",
        "warmup-only", "constant"])
def test_optimizer_matches_optax(kw):
    """8 updates; leaf "z" always has a zero gradient and is still
    weight-decayed, as optax decays every leaf."""
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng)
    grads = []
    for _ in range(8):
        g = _opt_tree(rng)
        g["z"] = np.zeros_like(g["z"])
        grads.append(g)

    jopt = JTR.make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    topt = TR.make_optimizer(**kw)
    state = TR.init_state(tree_to_torch(tree), topt)
    leaves = TR.param_leaves(state.params)
    for g in grads:
        up, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                 jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, up)
        topt.update(leaves, TR.param_leaves(tree_to_torch(g)),
                    state.opt_state)
    want = TR.param_leaves(tree_to_torch(jparams))
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(), rtol=0,
                                   atol=1e-6)
    assert not np.allclose(state.params["z"].detach().numpy(), tree["z"])


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    opt = TR.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=6,
                            accum_steps=2)
    state = TR.init_state(tree_to_torch(_opt_tree(rng)), opt)
    leaves = TR.param_leaves(state.params)
    for _ in range(3):                  # one applied update, one pending
        opt.update(leaves, TR.param_leaves(tree_to_torch(_opt_tree(rng))),
                   state.opt_state)
        state.step += 1
    for _ in range(4):
        CK.save_train_state(str(tmp_path), state, step=state.step)
        state.step += 1
    assert CK.checkpoint_steps(str(tmp_path)) == [4, 5, 6]    # max_to_keep
    fresh = TR.init_state(tree_to_torch(_opt_tree(np.random.default_rng(9))),
                          opt)
    CK.restore_train_state(str(tmp_path), fresh)
    assert fresh.step == 6 and fresh.opt_state.mini_step == 1
    assert fresh.opt_state.gradient_step == 1
    for a, b in zip(TR.param_leaves(fresh.params), leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(fresh.opt_state.acc, state.opt_state.acc):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # both continue identically
    g = TR.param_leaves(tree_to_torch(_opt_tree(rng)))
    for s in (state, fresh):
        opt.update(TR.param_leaves(s.params), g, s.opt_state)
    for a, b in zip(TR.param_leaves(fresh.params), leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        CK.restore_train_state(str(tmp_path / "empty"), fresh)


# ---------------------------------------------------------------------------
# Data pipeline and loop
# ---------------------------------------------------------------------------

def _rows(n=10):
    words = ["Hello,", "world", "--", "a", "Bob's", "lo", "w0", "ab", "he",
             "wo"]
    return [f"{words[i % len(words)]}, {i * 0.4:.2f}, {i * 0.4 + 0.3:.2f}, 0.9"
            for i in range(n)]


def test_sample_word_window_equals_jax():
    for seed in range(6):
        g_t, g_j = np.random.default_rng(seed), np.random.default_rng(seed)
        for n in (4, 10, 25):
            for _ in range(5):
                assert TD.sample_word_window(_rows(n), g_t) == \
                    JD.sample_word_window(_rows(n), g_j)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("corpus")
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
                            + "\n".join(_rows(10)) + "\n")
        rows.append({"filename": f"c{i}", "text_path": str(txt_path),
                     "audio_path": str(wav_path)})
    csv_path = root / "corpus.csv"
    csv_path.write_text("filename,text_path,audio_path\n" + "".join(
        f"{r['filename']},{r['text_path']},{r['audio_path']}\n" for r in rows))
    return dict(rows=rows, feat_dir=str(feat_dir), csv=str(csv_path))


def test_load_and_collate_equal_jax(corpus):
    g_t, g_j = np.random.default_rng(1), np.random.default_rng(1)
    got_s = [TD.load_training_sample(r, corpus["feat_dir"], g_t)
             for r in corpus["rows"]]
    want_s = [JD.load_training_sample(r, corpus["feat_dir"], g_j)
              for r in corpus["rows"]]
    for a, b in zip(got_s, want_s):
        assert a["text"] == b["text"]
        assert a["word_boundaries"] == b["word_boundaries"]
        np.testing.assert_array_equal(a["visual_feats"], b["visual_feats"])
        np.testing.assert_array_equal(a["wav"], b["wav"])
    got = TD.collate_training_batch(got_s, WordTokenizer(make_tiny_tokenizer()))
    want = JD.collate_training_batch(want_s, make_word_tokenizer())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].device.type == "cpu" and tuple(got[k].shape) == w.shape
        if k == "audio_mel":
            # the numpy log-mel vs XLA's: log-domain values of order 10
            # agree to ~1e-4 (tests/test_torch_ops.py)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_missing_files_return_none(tmp_path):
    row = {"filename": "x", "text_path": str(tmp_path / "no.txt"),
           "audio_path": str(tmp_path / "no.wav")}
    assert TD.load_training_sample(row, str(tmp_path),
                                   np.random.default_rng(0)) is None
    assert TD.collate_training_batch([None, None], None) is None


def test_loop_trains_checkpoints_and_resumes(corpus, tmp_path):
    jp = _tiny_jegal(6, 1)
    rp, cfg = _tiny_roberta(7, 64, 64)
    tok = WordTokenizer(make_tiny_tokenizer())
    ckpt, log = tmp_path / "ckpt", tmp_path / "train.jsonl"
    kw = dict(batch_size=2, lr=1e-3, warmup_steps=1, cosine_decay=True,
              ckpt_dir=str(ckpt), ckpt_every=1, log_path=str(log), seed=3,
              device="cpu")
    p0 = jp["proj_op_rgb"]["kernel"].clone()
    out = TL.train(corpus["csv"], corpus["feat_dir"], jp, rp, cfg, tok,
                   steps=2, **kw)
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert CK.checkpoint_steps(str(ckpt)) == [1, 2]
    torch.testing.assert_close(jp["proj_op_rgb"]["kernel"], p0, rtol=0,
                               atol=0)
    out = TL.train(corpus["csv"], corpus["feat_dir"], jp, rp, cfg, tok,
                   steps=3, **kw)
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
    assert CK.checkpoint_steps(str(ckpt)) == [1, 2, 3]
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines)
    assert TL.step_gates(3, 5) == TL.step_gates(3, 5)


def test_loop_refuses_what_it_does_not_run(corpus):
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TL.train(corpus["csv"], corpus["feat_dir"], {}, {}, None, None,
                 model_parallel=2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.train(corpus["csv"], corpus["feat_dir"], {}, {}, None, None)
