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
                           drop_gates=(1.0, 1.0)):
    """Forward the three branches and pool to one embedding per video.

    batch keys: visual_feats (B,T,1024), visual_mask (B,T), input_ids (B,S),
    text_mask (B,S), text_pool (B,W,S), audio_mel (B,Tm,80),
    audio_pool (B,W,Tm/4), word_mask (B,W), optional audio_valid (B,).
    drop_gates: (audio_gate, text_gate), 0/1 each."""
    g = J.forward_gestures(params, batch["visual_feats"],
                           batch["visual_mask"], fused=False)
    gesture_vid = masked_mean(g, batch["visual_mask"])

    with torch.no_grad():   # frozen backbone, on its fused stack kernel
        hidden = R.forward(roberta_params, batch["input_ids"],
                           batch["text_mask"], roberta_cfg)
    sub = J.forward_text(params, hidden, batch["text_mask"], fused=False)
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
            remat: bool = False):
    """The InfoNCE loss under the given modality gates. remat recomputes the
    branch forwards in the backward pass instead of keeping their
    activations (jax.checkpoint in the JAX package)."""
    if remat:
        g, c = checkpoint(video_level_embeddings, params, roberta_params,
                          batch, roberta_cfg, gates, use_reentrant=False)
    else:
        g, c = video_level_embeddings(params, roberta_params, batch,
                                      roberta_cfg, gates)
    return info_nce(g, c)


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


def train_step(state: TrainState, batch, gates, *, roberta_params,
               roberta_cfg, optimizer: Optimizer, remat: bool = False):
    """One step under the given modality gates -> (state, loss). The state
    is updated in place; the loss stays on the device (no host sync)."""
    leaves = param_leaves(state.params)
    loss = loss_fn(state.params, roberta_params, batch, gates, roberta_cfg,
                   remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    optimizer.update(leaves, grads, state.opt_state)
    state.step += 1
    return state, loss.detach()
