"""Training checkpoint and resume with torch.save (the JAX package's
parallel/checkpoint.py, which uses Orbax).

A checkpoint is one file per step, `<ckpt_dir>/step_<N>.pt`, holding the
params, the optimizer state (AdamW moments and step counts, the
accumulation window and the schedule's count of applied updates) and the
step; the newest `max_to_keep` are kept. A file is written under a
temporary name and renamed, so a cut run never leaves a partial
checkpoint under a step's name.
"""

from __future__ import annotations

import os
import re

import torch

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
                     max_to_keep: int = 3) -> str:
    """Write `state` (trainer.TrainState) as the checkpoint of `step`
    (default: state.step) and drop all but the newest max_to_keep.
    -> the file written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step = state.step if step is None else step
    path = _path(ckpt_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"params": state.params,
                "opt_state": state.opt_state.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    for old in checkpoint_steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    return path


def restore_train_state(ckpt_dir: str, template_state,
                        step: int | None = None):
    """Load a checkpoint (default: the newest) INTO `template_state`, a
    state of the same tree and optimizer (trainer.init_state), in place on
    its device, and return it. Raises FileNotFoundError when there is
    none."""
    from jegal_torch.training.trainer import param_leaves

    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        step = steps[-1]
    leaves = param_leaves(template_state.params)
    payload = torch.load(_path(ckpt_dir, step), weights_only=True,
                         map_location=leaves[0].device)
    saved = param_leaves(payload["params"])
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint has {len(saved)} parameter leaves, "
                         f"the state {len(leaves)}")
    with torch.no_grad():
        for p, src in zip(leaves, saved):
            p.copy_(src)
    template_state.opt_state.load_state_dict(payload["opt_state"])
    template_state.step = int(payload["step"])
    return template_state
