"""Contrastive training for JEGAL, one card (the JAX package's
training/trainer.py:31-160).

Symmetric InfoNCE at temperature 0.07 between video-level gesture
embeddings and word-fused content embeddings, with the reference's random
content-modality dropout as 0/1 gates (reference models/jegal.py:279-292).
The XLM-R backbone is frozen: it runs under torch.no_grad(), the
counterpart of jax.lax.stop_gradient, and so keeps its fused stack kernel.
The JEGAL encoders run their layer loop (fused=False), whose attention is
the flash kernel with its autograd backward on the card
(ops/kernels/flash_attention.py).

The optimizer reproduces the JAX package's optax chain exactly: AdamW (b1
0.9, b2 0.999, eps 1e-8, decoupled weight decay on every leaf) under a
warmup / cosine schedule, inside MultiSteps accumulation. Two JAX-package
semantics are kept on purpose, not fixed:

  * the whole JEGAL tree is trainable, the audio CNN's BatchNorm `mean` and
    `var` leaves included (they get gradients and Adam updates);
  * the align heads (`proj_op_align_*`) are unused in training (align=False)
    and get zero gradients, but are still weight-decayed. torch.optim.AdamW
    skips a parameter whose .grad is None, so every leaf gets a gradient,
    zeros where unused.

Parameters stay the port's nested dicts of tensors (jegal_torch.convert
layout); the optimizer sees them as the leaves of a flattening in sorted
key-path order (`param_leaves`), stable across save and restore.

On a (data, model) mesh (parallel/mesh.py; the JAX package's
`shard_training` and `make_train_step`, trainer.py:163-219) each rank holds
its Megatron shards of the JEGAL and XLM-R trees (`jegal_param_spec`,
`roberta_param_spec`), the AdamW moments of its shards, and its rows of
the batch. The step computes the one-rank step over the global batch:
  1. the forward with the model group (core/transformer.py);
  2. `gather_from_data` on both video-level embeddings, so every rank's
     InfoNCE sees the whole B x B similarity matrix;
  3. the backward, in which the gather keeps this rank's rows;
  4. each gradient summed over the data group (no division: each rank's
     gradient is its rows' share of the global loss's);
  5. AdamW on the local leaves, which is element by element.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from jegal_torch.models import jegal as J
from jegal_torch.models import roberta as R
from jegal_torch.ops.pooling import pool_words
from jegal_torch.parallel import mesh as M
from jegal_torch.parallel.collectives import (
    gather_from_data,
    group_size,
    sum_over,
)

TEMPERATURE = 0.07


def param_leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of a nested dict/list tree, dict keys in sorted
    order and lists by index."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [] if tree is None else [tree]


def _trainable(tree):
    """A copy of the tree whose every leaf is a fresh leaf tensor that
    requires grad (the caller's tensors are never updated in place)."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable(v) for v in tree]
    if tree is None:
        return None
    return tree.detach().clone().requires_grad_(True)


def masked_mean(x, mask, eps: float = 1e-6):
    """x: (B, N, D); mask: (B, N) -> (B, D)."""
    w = mask[..., None]
    return (x * w).sum(dim=1) / torch.clamp_min(w.sum(dim=1), eps)


def video_level_embeddings(params, roberta_params, batch, roberta_cfg,
                           drop_gates=(1.0, 1.0), group=None):
    """Forward the three branches and pool to one embedding per video.

    batch keys: visual_feats (B,T,1024), visual_mask (B,T), input_ids (B,S),
    text_mask (B,S), text_pool (B,W,S), audio_mel (B,Tm,80),
    audio_pool (B,W,Tm/4), word_mask (B,W), optional audio_valid (B,).
    drop_gates: (audio_gate, text_gate), 0/1 each. group: the model group
    the encoders and XLM-R are split over, None for none."""
    g = J.forward_gestures(params, batch["visual_feats"],
                           batch["visual_mask"], fused=False, group=group)
    gesture_vid = masked_mean(g, batch["visual_mask"])

    with torch.no_grad():   # frozen backbone, on its fused stack kernel
        hidden = R.forward(roberta_params, batch["input_ids"],
                           batch["text_mask"], roberta_cfg, group=group)
    sub = J.forward_text(params, hidden, batch["text_mask"], fused=False,
                         group=group)
    text_words = pool_words(batch["text_pool"], sub) * drop_gates[1]

    tokens = J.forward_audio(params, batch["audio_mel"],
                             batch.get("audio_valid"))
    audio_words = pool_words(batch["audio_pool"], tokens) * drop_gates[0]

    content = J.fuse_content(params, audio_words, text_words, align=False)
    content_vid = masked_mean(content, batch["word_mask"])
    return gesture_vid, content_vid


def info_nce(gesture, content, temp: float = TEMPERATURE):
    """Symmetric batch contrastive loss on L2-normalized embeddings."""
    g = gesture / torch.clamp_min(gesture.norm(dim=-1, keepdim=True), 1e-8)
    c = content / torch.clamp_min(content.norm(dim=-1, keepdim=True), 1e-8)
    sim = torch.matmul(g, c.t()) / temp
    labels = torch.arange(sim.shape[0], device=sim.device)
    return 0.5 * (F.cross_entropy(sim, labels)
                  + F.cross_entropy(sim.t(), labels))


def modality_drop_gates(generator: torch.Generator):
    """Reference jegal.py:279-292: with p=0.5 keep both; else drop audio or
    text with p=0.25 each. -> (audio_gate, text_gate) as floats."""
    u = torch.rand(2, generator=generator)
    keep_both, drop_audio = bool(u[0] <= 0.5), bool(u[1] > 0.5)
    audio_gate = 1.0 if keep_both or not drop_audio else 0.0
    text_gate = 1.0 if keep_both or drop_audio else 0.0
    return audio_gate, text_gate


def loss_fn(params, roberta_params, batch, gates, roberta_cfg,
            remat: bool = False, mesh=None):
    """The InfoNCE loss under the given modality gates, over the global
    batch on a mesh. remat recomputes the branch forwards in the backward
    pass instead of keeping their activations (jax.checkpoint in the JAX
    package); on a mesh the recomputation issues the forward's collectives
    again, in the same order on every rank."""
    group = M.mesh_group(mesh, "model")
    if remat:
        g, c = checkpoint(video_level_embeddings, params, roberta_params,
                          batch, roberta_cfg, gates, group,
                          use_reentrant=False)
    else:
        g, c = video_level_embeddings(params, roberta_params, batch,
                                      roberta_cfg, gates, group)
    data = M.mesh_group(mesh, "data")
    return info_nce(gather_from_data(g, data), gather_from_data(c, data))


# ---------------------------------------------------------------------------
# Optimizer: optax.adamw(schedule) [inside optax.MultiSteps(k)]
# ---------------------------------------------------------------------------

def _linear_schedule(init: float, end: float, steps: int):
    def schedule(n):
        return (init - end) * (1 - min(max(n, 0), steps) / steps) + end
    return schedule


def _cosine_schedule(init: float, decay_steps: int):
    def schedule(n):
        return init * 0.5 * (1 + math.cos(math.pi * min(n, decay_steps)
                                          / decay_steps))
    return schedule


def _warmup_cosine_schedule(peak: float, warmup: int, decay_steps: int):
    warm = _linear_schedule(0.0, peak, warmup)
    cos = _cosine_schedule(peak, decay_steps - warmup)
    return lambda n: warm(n) if n < warmup else cos(n - warmup)


@dataclass
class OptState:
    """AdamW's moments and step counts (in `adam`), the running mean of the
    micro-batch gradients of an accumulation window, the micro-step inside
    the window, and the count of applied updates, which the schedule
    reads."""
    adam: torch.optim.AdamW
    acc: list = field(default_factory=list)
    mini_step: int = 0
    gradient_step: int = 0

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "acc": self.acc,
                "mini_step": self.mini_step,
                "gradient_step": self.gradient_step}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        with torch.no_grad():
            for a, b in zip(self.acc, sd["acc"]):
                a.copy_(b)
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])


@dataclass(frozen=True)
class Optimizer:
    """optax.adamw(schedule, weight_decay), wrapped in optax.MultiSteps
    when accum_steps > 1 (trainer.py:112-147)."""
    schedule: Callable[[int], float]
    weight_decay: float
    accum_steps: int = 1

    def init(self, leaves) -> OptState:
        adam = torch.optim.AdamW(leaves, lr=self.schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)
        acc = ([torch.zeros_like(p) for p in leaves]
               if self.accum_steps > 1 else [])
        return OptState(adam, acc)

    @torch.no_grad()
    def update(self, leaves, grads, state: OptState) -> None:
        """One micro-step: accumulate `grads` (one per leaf); on the k-th,
        apply AdamW to their mean at the schedule's learning rate for this
        applied update. The leaves are updated in place."""
        if self.accum_steps > 1:
            n = state.mini_step
            # MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(state.acc, delta)
            if n + 1 < self.accum_steps:
                state.mini_step = n + 1
                return
            grads = state.acc
        for p, g in zip(leaves, grads):
            p.grad = g
        for group in state.adam.param_groups:
            group["lr"] = self.schedule(state.gradient_step)
        state.adam.step()
        for p in leaves:
            p.grad = None
        state.gradient_step += 1
        if self.accum_steps > 1:
            torch._foreach_zero_(state.acc)
            state.mini_step = 0


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-2,
                   warmup_steps: int = 0, total_steps: int | None = None,
                   accum_steps: int = 1) -> Optimizer:
    """AdamW with linear warmup then cosine decay to 0 (total_steps given),
    cosine from the peak (no warmup), linear warmup only (no total), or a
    constant rate; gradient accumulation over accum_steps micro-batches.

    warmup_steps / total_steps count LOOP steps (micro-batches); the
    schedule advances once per applied update, so they are converted per
    accumulation window as the JAX package converts them."""
    k = max(accum_steps, 1)
    sched_warmup = -(-warmup_steps // k) if warmup_steps > 0 else 0
    if total_steps is not None:
        sched_total = max(total_steps // k, sched_warmup + 1)
        if sched_warmup > 0:
            schedule = _warmup_cosine_schedule(lr, sched_warmup, sched_total)
        else:
            schedule = _cosine_schedule(lr, sched_total)
    elif sched_warmup > 0:
        schedule = _linear_schedule(0.0, lr, sched_warmup)
    else:
        def schedule(n):
            return lr
    return Optimizer(schedule, weight_decay, k)


@dataclass
class TrainState:
    """params: the trainable JEGAL tree (every leaf requires grad);
    opt_state: the Optimizer's state over `param_leaves(params)`; step:
    the train steps taken (micro-steps under accumulation)."""
    params: dict
    opt_state: OptState
    step: int = 0


def init_state(params, optimizer: Optimizer) -> TrainState:
    """A training state over a trainable copy of `params`."""
    params = _trainable(params)
    return TrainState(params, optimizer.init(param_leaves(params)), 0)


def param_spec(params):
    """jegal_param_spec at the depths of the tree's encoders."""
    return M.jegal_param_spec(len(params["encoder_rgb"]["layers"]),
                              len(params["encoder_text"]["layers"]))


_MOMENTS = ("exp_avg", "exp_avg_sq")


def map_opt_state(sd: dict, fn) -> dict:
    """An OptState.state_dict() with the tensors that follow the leaves
    (each leaf's AdamW moments and accumulated gradient) replaced by fn([(leaf
    index, tensor), ...]), a list of as many tensors; the step counts and
    hyperparameters are kept."""
    state = sd["adam"]["state"]
    items = [(i, state[i][k]) for i in sorted(state) for k in _MOMENTS
             if k in state[i]]
    items += list(enumerate(sd["acc"]))
    new = iter(fn(items))
    adam = dict(sd["adam"], state={
        i: dict(state[i], **{k: next(new) for k in _MOMENTS
                             if k in state[i]})
        for i in sorted(state)})
    return dict(sd, adam=adam, acc=[next(new) for _ in sd["acc"]])


def shard_opt_state(sd: dict, params, mesh) -> dict:
    """A whole tree's optimizer state dict -> this rank's shards of it."""
    specs = M.spec_leaves(param_spec(params))
    return map_opt_state(sd, lambda items: [
        M.shard_leaf(t, specs[i], mesh).clone() for i, t in items])


def gather_opt_state(sd: dict, params, mesh) -> dict:
    """This rank's optimizer state dict -> the whole tree's, on every
    rank."""
    specs = M.spec_leaves(param_spec(params))
    return map_opt_state(sd, lambda items: M.gather_leaves(
        [t for _, t in items], [specs[i] for i, _ in items], mesh))


def shard_training(mesh, state: TrainState, roberta_params, batch):
    """Place training state and inputs on the mesh (the JAX package's
    trainer.py:163-202) -> (state, roberta_params, batch): the JEGAL
    params as this rank's `jegal_param_spec` shards (fresh leaves), the
    optimizer's state sliced to the same shards, XLM-R by
    `roberta_param_spec` when the model axis has more than one rank (its
    stack kernel's `fused_ops` dropped; at one, the tree as given, on the
    stack kernel), and this rank's rows of the batch."""
    spec = param_spec(state.params)
    params = _trainable(M.shard_pytree(state.params, spec, mesh))
    leaves = param_leaves(params)
    # load_state_dict brings the hyperparameters with the moments
    opt = OptState(torch.optim.AdamW(leaves),
                   [torch.zeros_like(p) for p in leaves]
                   if state.opt_state.acc else [])
    opt.load_state_dict(shard_opt_state(state.opt_state.state_dict(),
                                        state.params, mesh))
    rparams = roberta_params
    if group_size(M.mesh_group(mesh, "model")) > 1:
        rparams = M.shard_pytree(
            {k: roberta_params[k] for k in ("embeddings", "layers")},
            M.roberta_param_spec(len(roberta_params["layers"])), mesh)
    rows = M.put_batch(list(batch.values()), mesh, leaves[0].device)
    return (TrainState(params, opt, state.step), rparams,
            dict(zip(batch, rows)))


def loss_and_grads(params, roberta_params, batch, gates, roberta_cfg,
                   remat: bool = False, mesh=None):
    """-> (loss, the gradient of every leaf of `param_leaves(params)`): on
    a mesh, the gradients of this rank's shards summed over the data group,
    so that they are the shards of the one-rank gradient over the global
    batch. A leaf the loss does not reach gets zeros."""
    leaves = param_leaves(params)
    loss = loss_fn(params, roberta_params, batch, gates, roberta_cfg, remat,
                   mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    sum_over(grads, M.mesh_group(mesh, "data"))
    return loss.detach(), grads


def train_step(state: TrainState, batch, gates, *, roberta_params,
               roberta_cfg, optimizer: Optimizer, remat: bool = False,
               mesh=None):
    """One step under the given modality gates -> (state, loss). The state
    is updated in place; the loss stays on the device (no host sync). On
    a mesh, the state, XLM-R and batch are `shard_training`'s."""
    loss, grads = loss_and_grads(state.params, roberta_params, batch, gates,
                                 roberta_cfg, remat, mesh)
    optimizer.update(param_leaves(state.params), grads, state.opt_state)
    state.step += 1
    return state, loss


def make_train_step(optimizer: Optimizer, roberta_cfg, remat: bool = False,
                    mesh=None):
    """The step (state, batch, gates, roberta_params) -> (state, loss) (the
    JAX package's trainer.py:205-219); on a mesh, over
    `shard_training`'s state, XLM-R and batch."""
    def step(state, batch, gates, roberta_params):
        return train_step(state, batch, gates, roberta_params=roberta_params,
                          roberta_cfg=roberta_cfg, optimizer=optimizer,
                          remat=remat, mesh=mesh)
    return step
