"""The port's sharded training (training/trainer.py's shard_training and
make_train_step on a (data, model) mesh, parallel/checkpoint.py across
meshes, training/loop.py on several ranks) on gloo ranks on the CPU, held
to one rank; and the one-rank step to the JAX package.

Each rank is a process of tests/torch_mesh_worker.py; the jobs of every
mesh start together. The setup is tests/torch_tiny.py's (1-layer
encoders, a 1-layer XLM-R of hidden 768 with its 12 heads, B 4), AdamW at
lr 1e-4. At meshes (2, 1), (1, 2) and (2, 2), and gates (1, 1), (0, 1) and
(1, 0), the sharded step against the one-rank step on the same weights and
the whole batch:
  - the loss within rel 1e-5;
  - the gathered gradient (every leaf, concatenated): cosine >= 0.9999 and
    norm within rel 1e-5 (the cosine alone cannot see a gradient off by a
    factor of the data ranks);
  - the parameters after one AdamW step within abs 1e-5. AdamW's first
    step moves an element by lr g / (|g| + 1e-8) (+ the decay), about lr
    times the sign of g: where the two runs' gradients differ in sign, or
    one is within a few 1e-8 of zero, float32 rounding decides the move.
    The bar holds where both gradients have one sign and are at least
    1e-7 (10 eps) in size; every element stays within 2 lr.
At (2, 2) also remat and two-step accumulation at the same bars, and a
checkpoint written at (2, 2) restored at one rank and one written at one
rank restored at (2, 2), bit for bit. loop.train at 2 ranks (data 2) for
2 steps, then to 3 resuming, logs the losses one rank's run logs (rel
1e-5) and checkpoints that one rank restores. The one-rank step's loss
equals the JAX package's video_level_embeddings + info_nce (2e-5)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_torch.parallel import checkpoint as CK
from jegal_torch.training import loop as TL
from jegal_torch.training import trainer as TR
from jegal_tpu.models import roberta as JR
from jegal_tpu.training import trainer as JTR
from torch_mesh_worker import GATES, LR, PARAM_ATOL, Job, loop_kwargs
from torch_threads import few_torch_threads  # noqa: F401
from torch_tiny import setup_step, write_corpus

MESHES = [(2, 1), (1, 2), (2, 2)]
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-5
GRAD_MIN_COS = 0.9999
GRAD_NORM_RTOL = 1e-5


def _name(m):
    return f"{m[0]}x{m[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job, started together -> {"steps": {mesh: merged results of
    its ranks}, "loop": per-rank results, "loop_args", "one_rank_loop"}."""
    root = tmp_path_factory.mktemp("train_mesh")
    corpus = write_corpus(root)
    loop_args = dict(csv=corpus["csv"], feat_dir=corpus["feat_dir"], mp=1,
                     ckpt=str(root / "loop_ckpt"),
                     log=str(root / "loop.jsonl"))
    jobs = {m: Job("step", m[0] * m[1], root / _name(m),
                   {"mp": m[1], "extras": m == (2, 2),
                    "dir": str(root / "ckpts")})
            for m in MESHES}
    loop_job = Job("loop", 2, root / "loop", loop_args)
    # the one-rank loop, here, while the ranks run
    one = dict(loop_args, ckpt=str(root / "one_ckpt"),
               log=str(root / "one.jsonl"))
    kw = loop_kwargs(one)
    one_rank = [TL.train(steps=2, **kw), TL.train(steps=3, **kw)]
    steps = {}
    for m, job in jobs.items():
        steps[m] = {}
        for out in job.results():
            steps[m].update(out)
    return dict(steps=steps, loop=loop_job.results(), loop_args=loop_args,
                one=one, one_rank_loop=one_rank)


def _check_params(p):
    assert p["max_abs_resolved"] <= PARAM_ATOL, p
    assert p["max_abs"] <= 2 * LR, p


def _check_step(r):
    assert abs(r["loss"] - r["loss_want"]) <= LOSS_RTOL * abs(r["loss_want"])
    g = r["grads"]
    assert g["cos"] >= GRAD_MIN_COS, g
    assert abs(g["norm"] - g["norm_want"]) <= GRAD_NORM_RTOL * g["norm_want"]
    _check_params(r["params"])


@pytest.mark.parametrize("gates", GATES, ids=lambda g: f"gates{g[0]:g}{g[1]:g}")
@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_sharded_step_matches_one_rank(runs, mesh, gates):
    _check_step(runs["steps"][mesh][gates])


def test_remat_under_mesh(runs):
    _check_step(runs["steps"][(2, 2)]["remat"])


def test_accumulation_under_mesh(runs):
    acc = runs["steps"][(2, 2)]["accum"]
    assert acc["first_unchanged"] and acc["applied"] == (1, 1)
    _check_params(acc["params"])


def test_checkpoints_restore_across_meshes(runs):
    out = runs["steps"][(2, 2)]
    assert out["mesh_to_one"] and out["one_to_mesh"]
    assert out["restored_step"] == 1


@pytest.fixture(scope="module")
def jax_loss():
    jp, rp, cfg, batch = setup_step(layers=1)
    as_np = (lambda tree: jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tree))
    rp_j, batch_j = as_np(rp), as_np(batch)
    jax_cfg = JR.RobertaConfig(**vars(cfg))

    @jax.jit
    def loss(params, gates):
        return JTR.info_nce(*JTR.video_level_embeddings(
            params, rp_j, batch_j, jax_cfg, gates))

    return jp, rp, cfg, batch, lambda g: float(loss(as_np(jp), g))


@pytest.mark.parametrize("gates", GATES, ids=lambda g: f"gates{g[0]:g}{g[1]:g}")
def test_one_rank_step_matches_jax(jax_loss, gates):
    jp, rp, cfg, batch, want = jax_loss
    opt = TR.make_optimizer(lr=LR)
    state = TR.init_state(jp, opt)
    _, loss = TR.make_train_step(opt, cfg)(state, batch, gates, rp)
    np.testing.assert_allclose(loss.item(), want(gates), **LOSS_TOL)


def test_loop_trains_sharded_like_one_rank(runs):
    """Both ranks return what one rank's loop returns (rel 1e-5), rank 0's
    log has one rank's steps and losses, and its checkpoints restore at one
    rank."""
    want = runs["one_rank_loop"]
    for rank_out in runs["loop"]:
        for got, exp in zip(rank_out, want):
            assert got["steps"] == exp["steps"]
            assert got["final_loss"] == pytest.approx(exp["final_loss"],
                                                      rel=LOSS_RTOL)
    logs = [[json.loads(x) for x in open(runs[k]["log"])]
            for k in ("loop_args", "one")]
    assert [x["step"] for x in logs[0]] == [x["step"] for x in logs[1]] \
        == [1, 2, 3]
    for a, b in zip(*logs):
        assert a["loss"] == pytest.approx(b["loss"], rel=LOSS_RTOL, abs=2e-5)
    ckpt = runs["loop_args"]["ckpt"]
    assert CK.checkpoint_steps(ckpt) == [1, 2, 3]
    state = TR.init_state(loop_kwargs(runs["loop_args"])["jegal_params"],
                          TR.make_optimizer())
    CK.restore_train_state(ckpt, state)
    assert state.step == 3
    assert all(torch.isfinite(p).all() for p in TR.param_leaves(state.params))
