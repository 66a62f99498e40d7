"""Training loop: CSV corpus -> batches -> steps -> checkpoints (the JAX
package's training/loop.py:21-136).

Random word-window batches (training/data.py), the contrastive step
(training/trainer.py), JSONL metrics, periodic checkpoints and resume
(parallel/checkpoint.py). The loop runs on the card unless the caller
passes device="cpu"; with no card it raises rather than falling back.

Launched as several ranks (a process group initialized, e.g. by the CLI
under `torchrun`), it trains on a (data, model) mesh of the group's ranks
(parallel/mesh.py): every rank draws the same global batch from the seed
and keeps its rows, the gates are the same on every rank, and only rank 0
writes metrics and checkpoint files. With no group `model_parallel` is
ignored, as the JAX loop ignores it on one device.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from jegal_torch.api import resolve_device
from jegal_torch.convert import tree_to_torch
from jegal_torch.models import roberta as R
from jegal_torch.parallel.checkpoint import (
    restore_train_state,
    save_train_state,
)
from jegal_torch.parallel.mesh import make_mesh, put_batch, world_size
from jegal_torch.training import trainer
from jegal_torch.training.data import (
    collate_training_batch,
    load_training_sample,
)
from jegal_torch.utils.logging import MetricWriter, get_logger


def step_gates(seed: int, step: int):
    """The modality gates of loop step `step`: a function of (seed, step)
    alone, so a resumed run draws what an unbroken run would (the JAX loop
    folds the step into its key)."""
    g = torch.Generator().manual_seed(seed * 1_000_003 + step)
    return trainer.modality_drop_gates(g)


def train(
    csv_path: str,
    feature_dir: str,
    jegal_params,
    roberta_params,
    roberta_cfg,
    tokenizer,
    steps: int = 1000,
    batch_size: int = 8,
    lr: float = 1e-4,
    warmup_steps: int = 0,
    cosine_decay: bool = False,
    accum_steps: int = 1,
    remat: bool = False,
    ckpt_dir: str | None = None,
    ckpt_every: int = 500,
    log_path: str | None = None,
    seed: int = 0,
    model_parallel: int = 1,
    device="cuda",
) -> dict:
    """Train JEGAL for `steps` loop steps (resuming from the newest
    checkpoint in ckpt_dir) -> {"steps": steps run, "final_loss": float},
    the same on every rank. The caller's parameter trees are not
    modified."""
    dev = resolve_device(device)
    world = world_size()
    mesh = make_mesh(world, model_parallel) if world > 1 else None
    lead = mesh is None or dist.get_rank() == 0
    log = get_logger("train")
    metrics = MetricWriter(log_path) if lead else None
    with open(csv_path, newline="", encoding="utf-8") as f:
        corpus = list(csv.DictReader(f))   # filename, text_path, audio_path
    rng = np.random.default_rng(seed)

    rparams = tree_to_torch(roberta_params, dev)
    if dev.type == "cuda" and "fused_ops" not in rparams and (
            mesh is None or model_parallel == 1):
        rparams = R.stack_layers(rparams)   # the stack kernel's operands
    optimizer = trainer.make_optimizer(
        lr=lr, warmup_steps=warmup_steps,
        total_steps=steps if cosine_decay else None,
        accum_steps=accum_steps)
    state = trainer.init_state(tree_to_torch(jegal_params, dev), optimizer)
    if mesh is not None:
        state, rparams, _ = trainer.shard_training(mesh, state, rparams, {})
    step_fn = trainer.make_train_step(optimizer, roberta_cfg, remat, mesh)
    start_step = 0
    if ckpt_dir and os.path.isdir(ckpt_dir):
        try:
            state = restore_train_state(ckpt_dir, state, mesh=mesh)
            start_step = state.step
            log.info("resumed from step %d", start_step)
        except FileNotFoundError:
            pass

    def make_batch(max_attempts: int = 50):
        """Exactly batch_size rows on the device: invalid samples are
        dropped by the collator, and a short batch is topped up by cyclic
        repetition. Raises after max_attempts draws with no valid
        sample."""
        for _ in range(max_attempts):
            rows = [corpus[int(i)]
                    for i in rng.integers(0, len(corpus), batch_size)]
            samples = [load_training_sample(r, feature_dir, rng)
                       for r in rows]
            batch = collate_training_batch(samples, tokenizer)
            if batch is None:
                continue
            n = batch["visual_feats"].shape[0]
            if n < batch_size:
                idx = torch.arange(batch_size) % n
                batch = {k: v[idx] for k, v in batch.items()}
            return dict(zip(batch, put_batch(batch.values(), mesh, dev)))
        raise RuntimeError(
            f"no valid training batch after {max_attempts} draws: check "
            "feature_dir and the CSV's text_path / audio_path columns")

    last_loss = float("nan")
    saved_at = None
    t0 = time.perf_counter()
    batch = make_batch() if start_step < steps else None
    for step in range(start_step, steps):
        state, loss = step_fn(state, batch, step_gates(seed, step), rparams)
        # build the NEXT batch before the loss fetch waits for the device,
        # so host data work overlaps device compute (one-step prefetch)
        if step + 1 < steps:
            batch = make_batch()
        last_loss = float(loss)
        if lead:
            metrics.write("train_step", step=step + 1,
                          loss=round(last_loss, 5),
                          sec=round(time.perf_counter() - t0, 2))
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_train_state(ckpt_dir, state, mesh=mesh)
            saved_at = state.step
            if lead:
                log.info("checkpoint at step %d", step + 1)

    if ckpt_dir and saved_at != state.step:
        save_train_state(ckpt_dir, state, mesh=mesh)
    if lead:
        metrics.close()
    return {"steps": steps - start_step, "final_loss": last_loss}
