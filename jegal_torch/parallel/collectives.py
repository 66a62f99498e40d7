"""Collectives with gradients for tensor (Megatron) and data parallelism
on torch.distributed: what GSPMD inserts for the JAX package's sharded
step (jegal_tpu/training/trainer.py:205-219), written out.

  copy_to_model      identity forward; backward sums the gradient over the
                     model group. At the input of a column-parallel product.
  reduce_from_model  forward sums over the model group; backward identity.
                     After a row-parallel product, before its bias.
  gather_from_data   forward concatenates the data ranks' rows in rank
                     order; backward keeps this rank's rows of the
                     gradient (not summed). `gather_rows` is its forward
                     alone, for inference.

Each is the identity, with no collective, when its group is None or has
one rank. (torch.distributed.nn.functional.all_reduce is not
`reduce_from_model`: its backward sums the gradient again, which is
`copy_to_model`'s backward.)

`gather_from_data` is an all-reduce (sum) of a zeroed buffer in which each
rank fills its own rows: every position has one nonzero term, so the
result is exact, and an all-reduce is the one collective every backend
takes on CUDA tensors (gloo has no all-gather of CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in `group`; 1 for None (no group)."""
    return 1 if group is None else dist.get_world_size(group)


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def _all_reduce(x, group):
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _rows_of(n: int, group):
    """This rank's rows of the gathered (n * size, ...) tensor."""
    r = dist.get_rank(group)
    return slice(r * n, (r + 1) * n)


def gather_rows(x, group):
    """`gather_from_data`'s forward with no autograd: this rank's rows ->
    the data ranks' rows in rank order (x itself for a trivial group)."""
    if _trivial(group):
        return x
    out = x.new_zeros((x.shape[0] * dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    out[_rows_of(x.shape[0], group)] = x
    return _all_reduce(out, group)


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[_rows_of(ctx.n, ctx.group)], None


def copy_to_model(x, group):
    return x if _trivial(group) else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return x if _trivial(group) else _ReduceFromModel.apply(x, group)


def gather_from_data(x, group):
    return x if _trivial(group) else _GatherFromData.apply(x, group)


def sum_over(tensors, group) -> None:
    """Sum each tensor of a list over `group`, in place, in one collective
    (the list flattened into one buffer). No-op for a trivial group."""
    if _trivial(group) or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, group)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
