"""One gloo rank of the port's mesh tests, and the launcher the tests start
the ranks with.

    python tests/torch_mesh_worker.py TASK RANK WORLD INIT_FILE OUT_DIR ARGS

Each rank joins a gloo group through `file://INIT_FILE` (no TCP port, so
tests in parallel workers cannot collide), runs TASK on the CPU with one
intra-op thread and writes what it found to OUT_DIR/rank<RANK>.pt. The
one-rank references of the step tasks are computed by rank 0 in the same
process with no mesh (mesh=None is the one-card code path), on the same
weights and the whole batch.

Tasks:
  mesh   the (data, model) mesh's layout, its helpers, the collectives'
         forward and backward, and a shard / gather round trip;
  step   the sharded step at each set of gates against one rank: loss,
         gathered gradient, parameters after one AdamW step; with
         "extras", remat, two-step accumulation and checkpoints across
         meshes;
  loop   training.loop.train for 2 steps and then to 3 with a resume;
  infer  data-parallel inference (collective calls, every rank returning
         what it got): `warmup(mesh=)` and the graphs a live call of the
         same shapes adds, `extract_many(mesh=)` on `ta` samples and, with
         "tower", on `v` raw frames, `shard_batch_tower` on raw and
         planar frames and `gestsync_features_from_raw_many(mesh=)`; with
         "evals", the three `evaluate_device(mesh=)`; with "serve", a
         server on rank 0 (port 0, a batch window) answering `ta`
         requests from threads while rank 1 follows, then shut down.

`start_cli_ranks` / `cli_ranks` run `python -m jegal_torch` as torchrun-style
ranks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
GATES = ((1.0, 1.0), (0.0, 1.0), (1.0, 0.0))
LR, WEIGHT_DECAY = 1e-4, 1e-2
# AdamW's first step moves an element by lr (g / (|g| + 1e-8) + wd p),
# about lr times the sign of g: where two runs' gradients differ in sign,
# or one is within a few eps of zero, rounding of g decides the move. The
# parameter bar holds where both gradients have one sign and at least
# RESOLVED_GRAD (10 eps) in size, so that the two moves differ by less
# than 0.1 lr; every element stays within 2 lr.
RESOLVED_GRAD = 1e-7
PARAM_ATOL = 1e-5


def start_ranks(cmds, logs: Path):
    """Start one process per (argv, extra env) together, each writing its
    stdout and stderr to files under `logs` -> the processes."""
    base = dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    logs.mkdir(parents=True, exist_ok=True)
    procs = []
    for r, (argv, extra) in enumerate(cmds):
        with open(logs / f"out{r}.txt", "w") as out, \
                open(logs / f"err{r}.txt", "w") as err:
            procs.append(subprocess.Popen(argv, stdout=out, stderr=err,
                                          env=dict(base, **extra), cwd=ROOT))
    return procs


def finish_ranks(procs, logs: Path, timeout: float = 300.0):
    """Wait for every rank, each within `timeout` seconds, and raise if one
    fails or hangs, killing every rank first. -> the stdout of each."""
    try:
        for r, p in enumerate(procs):
            if p.wait(timeout=timeout) != 0:
                err = (logs / f"err{r}.txt").read_text()
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(logs / f"out{r}.txt").read_text() for r in range(len(procs))]


class Job:
    """`task` on `world` gloo ranks, started at construction."""

    def __init__(self, task: str, world: int, tmp: Path, args: dict):
        tmp.mkdir(parents=True, exist_ok=True)
        self.tmp, self.world = tmp, world
        self.procs = start_ranks([
            ([sys.executable, __file__, task, str(r), str(world),
              str(tmp / "pg"), str(tmp), json.dumps(args)], {})
            for r in range(world)], tmp)

    def results(self) -> list:
        """Each rank's results, once all have exited."""
        finish_ranks(self.procs, self.tmp)
        return [torch.load(self.tmp / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


# ---------------------------------------------------------------------------
# What the tests compare
# ---------------------------------------------------------------------------

def compare_leaves(got, want) -> dict:
    """Two lists of gradient or parameter leaves -> the cosine and the
    norms of their concatenations, and the max abs difference."""
    a = torch.cat([g.reshape(-1) for g in got]).double()
    b = torch.cat([w.reshape(-1) for w in want]).double()
    return dict(cos=float(a @ b / (a.norm() * b.norm())),
                norm=float(a.norm()), norm_want=float(b.norm()),
                max_abs=float((a - b).abs().max()))


def compare_params(got, want, grads, grads_want) -> dict:
    """compare_leaves of parameters after one applied AdamW update, with
    the max abs difference where the two applied gradients resolve the
    move (RESOLVED_GRAD) and the count of elements over PARAM_ATOL."""
    def flat(leaves):
        return torch.cat([x.reshape(-1) for x in leaves]).double()

    out = compare_leaves(got, want)
    g, gw = flat(grads), flat(grads_want)
    resolved = (torch.sign(g) == torch.sign(gw)) & (
        torch.minimum(g.abs(), gw.abs()) >= RESOLVED_GRAD)
    diff = (flat(got) - flat(want)).abs()
    out.update(max_abs_resolved=float(diff[resolved].max()),
               resolved=int(resolved.sum()),
               over=int((diff > PARAM_ATOL).sum()), elements=diff.numel())
    return out


# ---------------------------------------------------------------------------
# The inference tests' inputs (tests/test_torch_infer_mesh.py draws the
# same ones for the JAX package and the port's one-rank references)
# ---------------------------------------------------------------------------

TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
CLIP_T = (6, 8, 10)          # one T bucket (32): a chunk of 3, padded to 4


def infer_weights():
    """(JEGAL, GestSync, tiny XLM-R) trees in the JAX layout, and the XLM-R
    config."""
    from jegal_torch.convert import (
        init_gestsync_params,
        init_jegal_params,
        init_roberta_params,
    )
    from jegal_torch.models.roberta import RobertaConfig

    cfg = RobertaConfig(**TINY_XLMR)
    return (init_jegal_params(torch.Generator().manual_seed(71)),
            init_gestsync_params(torch.Generator().manual_seed(72)),
            init_roberta_params(torch.Generator().manual_seed(73), cfg), cfg)


def infer_engine():
    """The port's CPU engine on infer_weights."""
    from jegal_torch.api import JegalEngine
    from jegal_torch.text.tokenizer import WordTokenizer
    from tok_util import make_tiny_tokenizer

    jp, gp, rp, cfg = infer_weights()
    return JegalEngine(jp, gp, device="cpu", roberta_params=rp,
                       roberta_cfg=cfg,
                       tokenizer=WordTokenizer(make_tiny_tokenizer()))


def infer_clips():
    """Raw (T, 270, 480, 3) uint8 clips with chin rows, T of CLIP_T."""
    import numpy as np

    rng = np.random.default_rng(74)
    return [(rng.integers(0, 256, (t, 270, 480, 3), dtype=np.uint8),
             rng.integers(90, 200, t).astype(np.int64)) for t in CLIP_T]


def planar_clips():
    """infer_clips repacked and masked (ops/video.s2d_repack)."""
    from jegal_torch.ops.video import s2d_repack

    return [(s2d_repack(f, c), None) for f, c in infer_clips()]


def infer_samples():
    """Three `ta` samples (the features of `vta` beside them), one shape
    signature: a chunk of 3, padded to 4."""
    import numpy as np

    rng = np.random.default_rng(75)
    wbs = [["ab", 1, 3], ["hello", 4, 6], ["x", 7, 9]]
    return [{"visual_feats": rng.standard_normal((8 + 2 * i, 1024))
             .astype(np.float32), "text": "ab hello x",
             "word_boundaries": wbs,
             "wav": (rng.standard_normal(8000) * 300).astype(np.float32),
             "fname": f"s{i}"} for i in range(3)]


def stream_samples():
    """Six `ta` samples over two mel buckets, one invalid through its audio
    pooling (a word past the 8000-sample wav's 13 audio tokens): five
    log-mels, enough to stream on the prep pool, in two chunks at batch 4."""
    import numpy as np

    rng = np.random.default_rng(76)
    wbs = [["ab", 1, 3], ["hello", 4, 6], ["x", 7, 9]]
    out = [{"text": "ab hello x", "word_boundaries": wbs,
            "wav": (rng.standard_normal(n) * 300).astype(np.float32),
            "fname": f"m{i}"}
           for i, n in enumerate((8000, 24000, 8000, 24000, 8000, 8000))]
    out[4]["word_boundaries"] = wbs[:2] + [["x", 14, 15]]
    return out


def fake_decode(video_path: str, planar: bool = True):
    """cli.main._decode_for_features for the CLI tests' ranks: clip<i>.avi
    -> planar_clips()[i] (no decoder needed)."""
    i = int(Path(video_path).stem.removeprefix("clip"))
    return planar_clips()[i]


def start_cli_ranks(argv, world: int, root: Path, prelude: str = ""):
    """Start `python -m jegal_torch ARGV` as `world` ranks of a torchrun
    launch (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and a free
    MASTER_PORT on localhost), each running `prelude` first, their output
    under `root` -> the processes (finish_ranks waits for them)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = ("import sys\n" + prelude
            + "\nfrom jegal_torch.cli.main import main\nmain(sys.argv[1:])\n")
    return start_ranks([([sys.executable, "-c", code, *argv],
                         dict(RANK=str(r), LOCAL_RANK=str(r),
                              WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port)))
                        for r in range(world)], root)


def cli_ranks(argv, world: int, root: Path, prelude: str = ""):
    """start_cli_ranks, waited for -> each rank's stdout."""
    return finish_ranks(start_cli_ranks(argv, world, root, prelude), root)


def collective_inputs(rank: int):
    """The collective tests' tensors of a global rank: x (2, 3) and the
    weights w (2, 3), W (4, 3) of its loss (W's first 2 dp rows weigh
    gather_from_data's output)."""
    g = torch.Generator().manual_seed(100 + rank)
    return (torch.randn(2, 3, generator=g), torch.randn(2, 3, generator=g),
            torch.randn(4, 3, generator=g))


# ---------------------------------------------------------------------------
# Tasks (run in a rank)
# ---------------------------------------------------------------------------

def _mesh_task(mesh, rank, world, args):
    from jegal_torch.parallel import collectives as C
    from jegal_torch.parallel import mesh as M
    from jegal_torch.training.trainer import param_leaves
    from torch_tiny import setup_step, tiny_jegal

    out = dict(layout=mesh.mesh.tolist(), coord=list(mesh.get_coordinate()),
               shard=M.host_shard(range(10)), resolved=M.resolve_shard(),
               explicit=M.resolve_shard(3, 8))
    try:
        M.make_mesh(world, 3)
    except ValueError as e:
        out["indivisible"] = str(e)
    _, _, _, batch = setup_step()
    out["rows"] = M.put_batch([batch["visual_feats"]], mesh, "cpu")[0]
    # the collectives, forward and backward
    model, data = M.mesh_group(mesh, "model"), M.mesh_group(mesh, "data")
    x, w, big_w = collective_inputs(rank)
    shared = collective_inputs(0)[0].requires_grad_(True)
    y = C.copy_to_model(shared, model)
    (y * w).sum().backward()
    out["copy"] = (y.detach(), shared.grad)
    xr = x.clone().requires_grad_(True)
    y = C.reduce_from_model(xr, model)
    (y * w).sum().backward()
    out["reduce"] = (y.detach(), xr.grad)
    xd = x.clone().requires_grad_(True)
    y = C.gather_from_data(xd, data)
    (y * big_w[:y.shape[0]]).sum().backward()
    out["gather"] = (y.detach(), xd.grad)
    summed = [x.clone(), w.clone()]
    C.sum_over(summed, data)
    out["sum_over"] = summed
    # shard / gather round trips of the JEGAL and XLM-R trees
    jp = tiny_jegal(1, 2)
    spec = M.jegal_param_spec(2, 2)
    local = M.shard_pytree(jp, spec, mesh)
    back = M.gather_pytree(local, spec, mesh)
    out["roundtrip_jegal"] = all(
        torch.equal(a, b) for a, b in zip(param_leaves(back),
                                          param_leaves(jp)))
    layer = local["encoder_text"]["layers"][0]
    out["text_layer0"] = {k: (layer["attn"][k]["kernel"],
                              layer["attn"][k]["bias"])
                          for k in ("q", "o")}
    out["text_layer0"]["w1"] = (layer["ff"]["w1"]["kernel"],
                                layer["ff"]["w1"]["bias"])
    out["text_layer0"]["w2"] = (layer["ff"]["w2"]["kernel"],
                                layer["ff"]["w2"]["bias"])
    return out


def _fresh(jp, rp, cfg, batch, mesh, accum_steps=1):
    """A new state from `jp` (sharded on a mesh) -> (state, XLM-R, batch,
    optimizer)."""
    from jegal_torch.training import trainer as TR

    opt = TR.make_optimizer(lr=LR, weight_decay=WEIGHT_DECAY,
                            accum_steps=accum_steps)
    state = TR.init_state(jp, opt)
    if mesh is not None:
        state, rp, batch = TR.shard_training(mesh, state, rp, batch)
    return state, rp, batch, opt


def _full(state, mesh):
    """The state's parameter leaves as whole tensors."""
    from jegal_torch.parallel import mesh as M
    from jegal_torch.training import trainer as TR

    if mesh is None:
        return [p.detach() for p in TR.param_leaves(state.params)]
    return TR.param_leaves(M.gather_pytree(
        state.params, TR.param_spec(state.params), mesh))


def _grads_and_step(jp, rp, cfg, batch, gates, mesh, remat=False):
    """One step, as trainer.train_step takes it -> (loss, whole gradient
    leaves, whole parameter leaves after the AdamW update)."""
    from jegal_torch.parallel import mesh as M
    from jegal_torch.training import trainer as TR

    state, rps, b, opt = _fresh(jp, rp, cfg, batch, mesh)
    loss, grads = TR.loss_and_grads(state.params, rps, b, gates, cfg, remat,
                                    mesh)
    opt.update(TR.param_leaves(state.params), grads, state.opt_state)
    if mesh is not None:
        specs = M.spec_leaves(TR.param_spec(state.params))
        grads = M.gather_leaves(grads, specs, mesh)
    return float(loss), grads, _full(state, mesh)


def _compare(got, want) -> dict:
    (loss, grads, params), (loss_w, grads_w, params_w) = got, want
    return dict(loss=loss, loss_want=loss_w,
                grads=compare_leaves(grads, grads_w),
                params=compare_params(params, params_w, grads, grads_w))


def _applied_grads(state, mesh):
    """The gradient the first AdamW update applied, leaf by leaf (whole
    leaves): its first moment over (1 - beta1)."""
    from jegal_torch.training import trainer as TR

    sd = state.opt_state.state_dict()
    if mesh is not None:
        sd = TR.gather_opt_state(sd, state.params, mesh)
    st = sd["adam"]["state"]
    return [st[i]["exp_avg"] / (1 - 0.9) for i in sorted(st)]


def _accumulate(jp, rp, cfg, batch, gates, mesh, remat=False):
    """Two micro-steps with accum_steps 2 -> (whether the first left the
    parameters as they were, the updates applied, whole parameter leaves
    after the second, the mean gradient it applied)."""
    from jegal_torch.training import trainer as TR

    state, rps, b, opt = _fresh(jp, rp, cfg, batch, mesh, accum_steps=2)
    step = TR.make_train_step(opt, cfg, mesh=mesh)
    p0 = _full(state, mesh)
    state, _ = step(state, b, gates, rps)
    first = _full(state, mesh)
    state, _ = step(state, b, (0.0, 1.0), rps)
    return (all(torch.equal(a, b) for a, b in zip(p0, first)),
            state.opt_state.gradient_step, _full(state, mesh),
            _applied_grads(state, mesh))


def _step_task(mesh, rank, world, args):
    """The sharded runs first, in step on every rank; then each rank
    computes the one-rank references of every world-th run and compares."""
    import torch.distributed as dist

    from jegal_torch.parallel.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from jegal_torch.training import trainer as TR
    from torch_tiny import setup_step

    jp, rp, cfg, batch = setup_step(layers=1)
    runs = [(gates, _grads_and_step, gates, False) for gates in GATES]
    if args.get("extras"):
        runs += [("remat", _grads_and_step, (1.0, 1.0), True),
                 ("accum", _accumulate, (1.0, 1.0), False)]
    mine = {}
    for i, (name, fn, gates, remat) in enumerate(runs):
        got = fn(jp, rp, cfg, batch, gates, mesh, remat)
        if i % world == rank:
            mine[name] = (fn, gates, remat, got)
    out = {}
    for name, (fn, gates, remat, got) in mine.items():
        want = fn(jp, rp, cfg, batch, gates, None, remat)
        if name == "accum":
            out[name] = dict(first_unchanged=got[0], applied=(got[1],
                                                              want[1]),
                             params=compare_params(got[2], want[2], got[3],
                                                   want[3]))
        else:
            out[name] = _compare(got, want)
    if not args.get("extras"):
        return out
    # checkpoints: saved at the mesh and restored at one rank, and the
    # reverse, each against the state it was written from
    ckpt_mesh, ckpt_one = Path(args["dir"]) / "mesh", Path(args["dir"]) / "one"
    state, rps, b, opt = _fresh(jp, rp, cfg, batch, mesh)
    state, _ = TR.make_train_step(opt, cfg, mesh=mesh)(state, b, (1.0, 1.0),
                                                      rps)
    save_train_state(str(ckpt_mesh), state, mesh=mesh)
    saved = (_full(state, mesh), TR.gather_opt_state(
        state.opt_state.state_dict(), state.params, mesh))
    if rank == 1:
        one, _, _, _ = _fresh(jp, rp, cfg, batch, None)
        restore_train_state(str(ckpt_mesh), one)
        out["mesh_to_one"] = _same_state(
            (_full(one, None), one.opt_state.state_dict()), saved)
    if rank == 0:
        state1, rps1, b1, opt1 = _fresh(jp, rp, cfg, batch, None)
        state1, _ = TR.make_train_step(opt1, cfg)(state1, b1, (1.0, 0.0),
                                                  rps1)
        save_train_state(str(ckpt_one), state1)
        written = (_full(state1, None), state1.opt_state.state_dict())
    dist.barrier()
    template, _, _, _ = _fresh(jp, rp, cfg, batch, mesh)
    restore_train_state(str(ckpt_one), template, mesh=mesh)
    restored = (_full(template, mesh), TR.gather_opt_state(
        template.opt_state.state_dict(), template.params, mesh))
    if rank == 0:
        out["one_to_mesh"] = _same_state(restored, written)
        out["restored_step"] = template.step
    return out


def _same_state(a, b) -> bool:
    """Parameter leaves and optimizer state dicts bit for bit."""
    (pa, sa), (pb, sb) = a, b
    if not all(torch.equal(x, y) for x, y in zip(pa, pb)):
        return False
    ta, tb = sa["adam"]["state"], sb["adam"]["state"]
    return (sorted(ta) == sorted(tb)
            and all(torch.equal(ta[i][k], tb[i][k])
                    for i in ta for k in ta[i])
            and all(torch.equal(x, y) for x, y in zip(sa["acc"], sb["acc"]))
            and (sa["mini_step"], sa["gradient_step"])
            == (sb["mini_step"], sb["gradient_step"]))


def loop_kwargs(args: dict):
    """training.loop.train's arguments of the loop tests, beside the step
    counts."""
    from jegal_torch.text.tokenizer import WordTokenizer
    from tok_util import make_tiny_tokenizer
    from torch_tiny import tiny_jegal, tiny_roberta

    rp, cfg = tiny_roberta(7, 64, 64)
    return dict(csv_path=args["csv"], feature_dir=args["feat_dir"],
                jegal_params=tiny_jegal(6, 1), roberta_params=rp,
                roberta_cfg=cfg,
                tokenizer=WordTokenizer(make_tiny_tokenizer()),
                batch_size=2, lr=1e-3, warmup_steps=1, cosine_decay=True,
                ckpt_dir=args["ckpt"], ckpt_every=1, log_path=args["log"],
                seed=3, model_parallel=args["mp"], device="cpu")


def _loop_task(mesh, rank, world, args):
    from jegal_torch.training import loop as TL

    kw = loop_kwargs(args)
    return [TL.train(steps=2, **kw), TL.train(steps=3, **kw)]


def _shapes(engine, sample, modalities: str) -> dict:
    """The S, W and mel buckets of a sample's `modalities` arrays."""
    arrays = engine._prepare_sample(modalities, None, sample["text"],
                                    sample["word_boundaries"],
                                    sample["wav"])[0]
    return dict(s=arrays["input_ids"].shape[1],
                w=arrays["text_pool"].shape[1],
                mel=arrays["audio_mel"].shape[1])


def _post(url: str, sample: dict, modalities: str):
    """A JSON /extract request -> (status, the answer's embeddings)."""
    import urllib.request

    from jegal_torch import serving

    body = dict(modalities=modalities, text=sample["text"],
                word_boundaries=sample["word_boundaries"],
                wav=serving.encode_array(sample["wav"]),
                fname=sample["fname"])
    req = urllib.request.Request(url + "/extract",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as resp:
        ans = json.loads(resp.read())
        return resp.status, {k: serving.decode_array(ans[k])
                             for k in ("gesture_emb", "content_emb")}


def _serve_task(engine, mesh, rank, samples):
    """Rank 0 serves (a batch window, max batch 4) and sends each sample as
    a `ta` request from its own thread; the others follow until rank 0's
    server_close ends them."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from jegal_torch import serving

    if rank != 0:
        serving.follow(engine, mesh)
        return {"followed": True}
    server = serving.create_server(engine, port=0, batch_window_ms=200,
                                   max_batch=4, mesh=mesh)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with ThreadPoolExecutor(len(samples)) as ex:
            answers = list(ex.map(lambda s: _post(url, s, "ta"), samples))
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return {"served": answers, "healthz": health}


def _stream_task(engine, mesh):
    """extract_many(mesh=) on stream_samples, logging each check of the
    plan across ranks and each chunk's stage in the order they come."""
    from jegal_torch.parallel import mesh as M

    log = []
    check, stage = M.check_same, engine._staged_forward

    def logged_check(*a, **kw):
        log.append("check")
        return check(*a, **kw)

    def logged_stage(*a, **kw):
        log.append("stage")
        return stage(*a, **kw)

    M.check_same, engine._staged_forward = logged_check, logged_stage
    try:
        got = engine.extract_many(stream_samples(), "ta", batch_size=4,
                                  mesh=mesh)
    finally:
        M.check_same = check
        del engine._staged_forward
    return {"stream": got, "stream_log": log}


def _infer_task(mesh, rank, world, args):
    import numpy as np

    from jegal_torch.cli.main import Rows
    from jegal_torch.eval import asd, retrieval, spotting
    from jegal_torch.models import gestsync as G

    engine = infer_engine()
    samples = infer_samples()
    out = {}
    # warm what the live calls below replay, then hold the cache to it
    engine.warmup("ta", batch=3, mesh=mesh,
                  **_shapes(engine, samples[0], "ta"))
    if args.get("tower"):
        engine.warmup("v", t=32, batch=3, frames_kind="raw", mesh=mesh)
    warmed = list(engine.cached_graphs)
    out["ta"] = engine.extract_many(samples, "ta", batch_size=4, mesh=mesh)
    if args.get("tower"):
        clips = infer_clips()
        out["v"] = engine.extract_many(
            [dict(frames=f, chin_rows=c, fname=f"clip{i}")
             for i, (f, c) in enumerate(clips)], "v", batch_size=4,
            mesh=mesh)
    out["graphs_added"] = [g for g in engine.cached_graphs
                           if g not in warmed]
    out["graphs"] = len(engine.cached_graphs)
    if args.get("stream"):
        out.update(_stream_task(engine, mesh))
    if args.get("tower"):
        gp = engine.gestsync_params
        fr = np.zeros((4, 32, 270, 480, 3), np.uint8)
        cut = np.zeros((4, 32), np.int64)
        engine._fill_frames(fr, cut, clips)
        feats = G.extract_features_batch_raw_sharded(
            gp, torch.from_numpy(fr), torch.from_numpy(cut), mesh,
            conv2_impl="kernel")
        out["tower_raw"] = [feats[i, :t].numpy()
                            for i, t in enumerate(CLIP_T)]
        planar = planar_clips()
        fr = np.zeros((4, 32, 90, 27, 160), np.uint8)
        engine._fill_frames(fr, None, planar)
        feats = G.extract_features_batch_planar_sharded(
            gp, torch.from_numpy(fr), mesh, conv2_impl="kernel")
        out["tower_planar"] = [feats[i, :t].numpy()
                               for i, t in enumerate(CLIP_T)]
        out["raw_many"] = engine.gestsync_features_from_raw_many(
            planar, batch_size=4, mesh=mesh)
    if args.get("evals"):
        ev = args["evals"]
        out["retrieval"] = retrieval.evaluate_device(ev["retrieval"], "cpu",
                                                     mesh)
        out["spotting"] = spotting.evaluate_device(ev["spotting"],
                                                   device="cpu", mesh=mesh)
        out["spot_preds"] = spotting.predict_device(ev["spotting"], "cpu",
                                                    mesh)
        out["asd"] = asd.evaluate_device(ev["asd"], Rows(ev["asd_rows"]),
                                         "cpu", mesh)
    if args.get("serve"):
        out.update(_serve_task(engine, mesh, rank, samples))
    engine.close()
    return out


TASKS = {"mesh": _mesh_task, "step": _step_task, "loop": _loop_task,
         "infer": _infer_task}


def main(argv):
    task, rank, world, init, out_dir, args = argv
    rank, world, args = int(rank), int(world), json.loads(args)
    torch.set_num_threads(1)
    from jegal_torch.parallel import mesh as M

    M.initialize_distributed(device="cpu", init_method=f"file://{init}",
                             rank=rank, world_size=world)
    mesh = None
    if task != "loop":    # the loop builds its own mesh
        mesh = M.make_mesh(world, args["mp"])
    result = TASKS[task](mesh, rank, world, args)
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
