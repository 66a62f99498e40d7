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
  loop   training.loop.train for 2 steps and then to 3 with a resume.
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


TASKS = {"mesh": _mesh_task, "step": _step_task, "loop": _loop_task}


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
