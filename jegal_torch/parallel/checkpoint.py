"""Training checkpoint and resume with torch.save (the JAX package's
parallel/checkpoint.py, which uses Orbax).

A checkpoint is one file per step, `<ckpt_dir>/step_<N>.pt`, holding the
params, the optimizer state (AdamW moments and step counts, the
accumulation window and the schedule's count of applied updates) and the
step; the newest `max_to_keep` are kept. A file is written under a
temporary name and renamed, so a cut run never leaves a partial
checkpoint under a step's name.

On a (data, model) mesh (parallel/mesh.py) a checkpoint still holds the
whole trees: saving gathers the params and the optimizer's moments from
every rank's shards, rank 0 writes the file and prunes, and all ranks wait
at a barrier; restoring reads the whole file on every rank and keeps its
shards. A file written at one mesh so restores at any other, or at none,
as the JAX package's global-array checkpoints do.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

_NAME = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The steps with a checkpoint in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def save_train_state(ckpt_dir: str, state, step: int | None = None,
                     max_to_keep: int = 3, mesh=None) -> str:
    """Write `state` (trainer.TrainState) as the checkpoint of `step`
    (default: state.step) and drop all but the newest max_to_keep. With a
    mesh every rank calls this (it gathers), and rank 0 writes. -> the
    file written."""
    from jegal_torch.parallel.mesh import gather_pytree
    from jegal_torch.training.trainer import gather_opt_state, param_spec

    step = state.step if step is None else step
    path = _path(ckpt_dir, step)
    params, opt_state = state.params, state.opt_state.state_dict()
    if mesh is not None:
        opt_state = gather_opt_state(opt_state, params, mesh)
        params = gather_pytree(params, param_spec(params), mesh)
    if mesh is None or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"params": params, "opt_state": opt_state,
                    "step": state.step}, tmp)
        os.replace(tmp, path)
        for old in checkpoint_steps(ckpt_dir)[:-max_to_keep]:
            os.remove(_path(ckpt_dir, old))
    if mesh is not None:
        dist.barrier()
    return path


def restore_train_state(ckpt_dir: str, template_state,
                        step: int | None = None, mesh=None):
    """Load a checkpoint (default: the newest) INTO `template_state`, a
    state of the same tree and optimizer (trainer.init_state; on a mesh,
    trainer.shard_training's), in place on its device, and return it.
    Raises FileNotFoundError when there is none."""
    from jegal_torch.parallel.mesh import shard_pytree
    from jegal_torch.training.trainer import (
        param_leaves,
        param_spec,
        shard_opt_state,
    )

    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        step = steps[-1]
    leaves = param_leaves(template_state.params)
    payload = torch.load(_path(ckpt_dir, step), weights_only=True,
                         map_location=leaves[0].device)
    saved, opt_state = payload["params"], payload["opt_state"]
    if mesh is not None:
        opt_state = shard_opt_state(opt_state, saved, mesh)
        saved = shard_pytree(saved, param_spec(saved), mesh)
    saved = param_leaves(saved)
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint has {len(saved)} parameter leaves, "
                         f"the state {len(leaves)}")
    with torch.no_grad():
        for p, src in zip(leaves, saved):
            p.copy_(src)
    template_state.opt_state.load_state_dict(opt_state)
    template_state.step = int(payload["step"])
    return template_state
