"""The ('data', 'model') mesh and its sharding rules on torch.distributed
(the JAX package's parallel/mesh.py).

One process per rank, as `torchrun` starts them. `make_mesh` lays the
world's ranks out as the JAX package's `devices.reshape(n // model_parallel,
model_parallel)`: rank = d * model_parallel + m, so each model group is a
run of consecutive ranks. Batches shard over 'data'; attention heads and
FFN width over 'model' (Megatron: q/k/v and w1 split by columns, o and w2
by rows, their biases added once after the sum over 'model'). GSPMD
inserts the JAX package's collectives; here they are explicit
(parallel/collectives.py) and a sharded step computes the one-rank step
over the global batch.

A PartitionSpec becomes a plain tuple of axis names: P(None, "model") is
(None, "model"), P() is (). In the trees below a tuple is always a leaf;
dicts and lists are the containers, as in the parameter trees.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from jegal_torch.parallel import collectives as C

AXES = ("data", "model")


def initialize_distributed(backend: str | None = None, device: str = "cuda",
                           **kw):
    """Join the process group (torch.distributed.init_process_group; the
    launcher's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT unless `kw`
    gives an init_method, rank and world_size). The backend is NCCL when
    the rank computes on CUDA and gloo for device "cpu", unless `backend`
    names one. On CUDA the rank's card is LOCAL_RANK's. -> (rank, world
    size)."""
    on_cuda = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if on_cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend=backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def resolve_shard(rank: int | None = None, nshard: int | None = None):
    """(rank, nshard): each given value as given, the other from the
    process group when one is initialized, else 0 and 1."""
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank() if rank is None else rank
        nshard = dist.get_world_size() if nshard is None else nshard
    return (0 if rank is None else rank), (1 if nshard is None else nshard)


def host_shard(items, rank: int | None = None, nshard: int | None = None):
    """This rank's slice of a work list, items[rank::nshard] (the group's
    rank and world size by default)."""
    rank, nshard = resolve_shard(rank, nshard)
    return list(items)[rank::nshard]


def world_size() -> int:
    """The process group's size, 1 when none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def check_mesh_shape(num_devices: int, model_parallel: int) -> None:
    if model_parallel < 1 or num_devices % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {num_devices} ranks: the mesh is (ranks // "
                         f"model_parallel, model_parallel)")


def make_mesh(num_devices: int | None = None, model_parallel: int = 1):
    """The (data, model) DeviceMesh over the initialized process group's
    ranks, rank = d * model_parallel + m. Raises where the JAX package
    asserts (model_parallel not dividing the ranks), and when
    `num_devices` is not the group's size (a mesh spans the group)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if num_devices is None else num_devices
    if n != dist.get_world_size():
        raise ValueError(f"a mesh spans the process group's "
                         f"{dist.get_world_size()} ranks, not {n}")
    check_mesh_shape(n, model_parallel)
    # the groups' backend is the world's; a mesh over gloo stays on the
    # CPU device type, so that several gloo ranks may share one card
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=AXES)


def mesh_group(mesh, axis: str):
    """The process group of this rank's row of `axis`, None without a
    mesh."""
    return None if mesh is None else mesh.get_group(axis)


def replicated(mesh) -> tuple:
    return ()


def data_sharded(mesh, ndim: int = 1) -> tuple:
    """Shard the leading (batch) axis over 'data'."""
    return ("data",) + (None,) * (ndim - 1)


def _rows(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what}: {n} does not split into {parts} equal "
                         f"parts")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def put_batch(arrays, mesh=None, device="cuda"):
    """Host (numpy or CPU tensor) batch arrays -> tensors on `device`: with
    a mesh, this rank's rows [d n / dp, (d + 1) n / dp) of each, so each
    rank moves only its own rows; raises when dp does not divide n."""
    return [torch.as_tensor(a)[batch_rows(len(a), mesh)].to(device)
            for a in arrays]


# ---------------------------------------------------------------------------
# Data-parallel inference
#
# An inference call on a mesh is collective: every rank calls with equal
# arguments, computes the rows of its 'data' index (ranks that differ only
# in their 'model' index compute the same rows: inference replicates over
# 'model', as the JAX package's P("data") specs do) and gathers the whole
# result over 'data', so every rank returns the same. A collective that
# fails (a peer that raised, hung past the group's timeout or left) raises
# CollectiveError, which callers let end the run.
# ---------------------------------------------------------------------------

CONTROL_TIMEOUT = datetime.timedelta(seconds=600)


class CollectiveError(RuntimeError):
    """A collective of the mesh failed or its ranks disagree: the run
    cannot go on (a rank that carried on would leave its peers waiting)."""


def data_size(mesh) -> int:
    """The mesh's 'data' size dp; 1 without a mesh."""
    return 1 if mesh is None else mesh.size(AXES.index("data"))


def round_to_data(n: int, mesh) -> int:
    """n rounded up to a multiple of dp (a batch each data rank can take an
    equal share of)."""
    dp = data_size(mesh)
    return -(-n // dp) * dp


def batch_rows(n: int, mesh) -> slice:
    """This rank's rows [d n / dp, (d + 1) n / dp) of an n-row batch (all
    of them without a mesh); raises ValueError when dp does not divide n."""
    if mesh is None:
        return slice(0, n)
    return _rows(n, data_size(mesh), mesh.get_local_rank("data"),
                 "batch rows over 'data'")


def is_main(mesh) -> bool:
    """Whether this process writes a collective call's files and prints its
    results: the mesh's rank 0, or any process without a mesh."""
    return mesh is None or dist.get_rank() == 0


def _collective(fn, what: str):
    try:
        return fn()
    except RuntimeError as e:
        if isinstance(e, CollectiveError):
            raise
        raise CollectiveError(f"{what} over the mesh failed: {e}") from e


def gather_rows(x, mesh):
    """Inference's gather: this rank's rows of a batch -> the whole batch,
    the data ranks' rows in rank order, on every rank (an all-reduce of a
    zeroed buffer: exact, see parallel/collectives.py), with no autograd
    state; x itself without a mesh."""
    if mesh is None:
        return x
    with torch.inference_mode():
        return _collective(lambda: C.gather_rows(x, mesh.get_group("data")),
                           "the gather of a batch's rows")


def control_group(mesh):
    """The mesh's host control group: gloo over all its ranks, made at the
    first call on a mesh (a collective: every rank makes that call at the
    same point of the run) and kept with it, with a finite timeout."""
    group = getattr(mesh, "_jegal_control", None)
    if group is None:
        group = _collective(lambda: dist.new_group(
            backend="gloo", timeout=CONTROL_TIMEOUT), "making the control "
            "group")
        mesh._jegal_control = group
    return group


def broadcast_object(obj, mesh):
    """A picklable object from the mesh's rank 0 to every rank (the others'
    `obj` is ignored) -> rank 0's object; obj itself without a mesh or on
    one rank."""
    if mesh is None or dist.get_world_size() == 1:
        return obj
    box = [obj if dist.get_rank() == 0 else None]
    _collective(lambda: dist.broadcast_object_list(
        box, src=0, group=control_group(mesh)), "a broadcast from rank 0")
    return box[0]


def check_same(obj, mesh, what: str) -> None:
    """Raise CollectiveError on every rank unless every rank of the mesh
    holds an equal `obj` (the plan of a collective call: ranks that would
    run different chunks must not enter the collectives)."""
    if mesh is None or dist.get_world_size() == 1:
        return
    seen = [None] * dist.get_world_size()
    _collective(lambda: dist.all_gather_object(seen, obj,
                                               group=control_group(mesh)),
                f"comparing the ranks' {what}")
    if any(s != seen[0] for s in seen):
        raise CollectiveError(f"the ranks disagree on {what}: a collective "
                              f"call needs equal arguments on every rank")


# ---------------------------------------------------------------------------
# Parameter sharding rules (tensor parallelism)
# ---------------------------------------------------------------------------

def _mha_spec():
    # q/k/v: shard the head (output) dim; o: shard the input (head) dim,
    # one sum over 'model' an attention block
    return {
        "q": {"kernel": (None, "model"), "bias": ("model",)},
        "k": {"kernel": (None, "model"), "bias": ("model",)},
        "v": {"kernel": (None, "model"), "bias": ("model",)},
        "o": {"kernel": ("model", None), "bias": ()},
    }


def _ffn_spec():
    return {
        "w1": {"kernel": (None, "model"), "bias": ("model",)},
        "w2": {"kernel": ("model", None), "bias": ()},
    }


def _encoder_spec(num_layers: int, final_norm: bool):
    layer = {
        "attn": _mha_spec(),
        "ff": _ffn_spec(),
        "norm1": {"scale": (), "bias": ()},
        "norm2": {"scale": (), "bias": ()},
    }
    spec = {"layers": [layer] * num_layers}
    if final_norm:
        spec["norm"] = {"scale": (), "bias": ()}
    return spec


def jegal_param_spec(rgb_layers: int = 6, text_layers: int = 3):
    """Spec tree of the JEGAL tree (jegal_torch.convert.init_jegal_params);
    the encoders' depths default to the model's 6 and 3."""
    from jegal_torch.models.jegal import AUDIO_CNN_SPEC

    lin = {"kernel": (), "bias": ()}
    ln = {"scale": (), "bias": ()}
    conv = {"kernel": (), "bias": ()}
    bn = {"scale": (), "bias": (), "mean": (), "var": ()}
    cnn = []
    for spec in AUDIO_CNN_SPEC:
        blk = {"conv": conv}
        if spec["bn"]:
            blk["bn"] = bn
        cnn.append(blk)
    return {
        "proj_ip_rgb": [lin, lin],
        "proj_ip_ln": ln,
        "encoder_rgb": _encoder_spec(rgb_layers, True),
        "proj_op_rgb": lin,
        "encoder_text": _encoder_spec(text_layers, True),
        "proj_op_text": lin,
        "cnn": cnn,
        "proj_op_audio": lin,
        "proj_op_fusion_content": [lin, lin],
        "proj_op_align_gesture": [lin, lin],
        "proj_op_align_content": [lin, lin],
    }


def roberta_param_spec(num_layers: int):
    layer = {
        "q": {"kernel": (None, "model"), "bias": ("model",)},
        "k": {"kernel": (None, "model"), "bias": ("model",)},
        "v": {"kernel": (None, "model"), "bias": ("model",)},
        "attn_out": {"kernel": ("model", None), "bias": ()},
        "attn_ln": {"scale": (), "bias": ()},
        "inter": {"kernel": (None, "model"), "bias": ("model",)},
        "out": {"kernel": ("model", None), "bias": ()},
        "out_ln": {"scale": (), "bias": ()},
    }
    return {
        "embeddings": {
            "word": (),
            "position": (),
            "token_type": (),
            "ln": {"scale": (), "bias": ()},
        },
        "layers": [layer] * num_layers,
    }


def map_spec(fn, spec_tree, tree):
    """fn(spec, leaf) over a spec tree and a tree of the same structure
    (dict keys equal, lists of equal length) -> a tree of the results."""
    if isinstance(spec_tree, tuple):
        return fn(spec_tree, tree)
    if isinstance(spec_tree, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec_tree):
            raise ValueError(f"the tree's keys "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree)}"
                             f" are not the spec's {sorted(spec_tree)}")
        return {k: map_spec(fn, spec_tree[k], tree[k]) for k in spec_tree}
    if not isinstance(tree, (list, tuple)) or len(tree) != len(spec_tree):
        raise ValueError(f"the tree's list does not match the spec's "
                         f"{len(spec_tree)} entries")
    return [map_spec(fn, s, t) for s, t in zip(spec_tree, tree)]


def spec_leaves(spec_tree) -> list[tuple]:
    """The spec tree's leaves in the order of
    jegal_torch.training.trainer.param_leaves (dict keys sorted, lists by
    index)."""
    if isinstance(spec_tree, tuple):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree) for s in spec_leaves(spec_tree[k])]
    return [s for v in spec_tree for s in spec_leaves(v)]


def shard_leaf(x, spec: tuple, mesh):
    """This rank's contiguous block of `x` under `spec`."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            parts = mesh.size(AXES.index(axis))
            rows = _rows(x.shape[dim], parts, mesh.get_local_rank(axis),
                         f"dim {dim} of a {tuple(x.shape)} leaf over "
                         f"'{axis}'")
            x = x.narrow(dim, rows.start, rows.stop - rows.start)
    return x


def gather_leaves(xs, specs, mesh) -> list:
    """The whole leaves from this rank's blocks (`shard_leaf`'s inverse),
    on every rank: over each sharded axis, a sum over its group of zeroed
    whole tensors holding this rank's blocks, all in one collective (exact,
    as each entry has one term)."""
    xs = [x.detach() for x in xs]
    for axis in AXES:
        group = mesh.get_group(axis)
        parts = dist.get_world_size(group)
        which = [i for i, s in enumerate(specs) if axis in s]
        if parts == 1 or not which:
            continue
        fulls = []
        for i in which:
            dim = specs[i].index(axis)
            n = xs[i].shape[dim]
            shape = list(xs[i].shape)
            shape[dim] *= parts
            full = xs[i].new_zeros(shape)
            full.narrow(dim, mesh.get_local_rank(axis) * n, n).copy_(xs[i])
            fulls.append(full)
        C.sum_over(fulls, group)
        for i, full in zip(which, fulls):
            xs[i] = full
    return xs


def shard_pytree(tree, spec_tree, mesh):
    """This rank's contiguous block of every leaf: a sharded leaf's block
    copied (so that it holds no view of the whole leaf), a replicated leaf
    the caller's tensor."""
    def block(s, x):
        y = shard_leaf(x, s, mesh)
        return x if y is x else y.clone()

    return map_spec(block, spec_tree, tree)


def gather_pytree(tree, spec_tree, mesh):
    """The whole tree on every rank from each rank's blocks (the inverse of
    `shard_pytree`; replicated leaves come back detached, not copied)."""
    pairs = []
    map_spec(lambda s, x: pairs.append((s, x)), spec_tree, tree)
    whole = iter(gather_leaves([x for _, x in pairs], [s for s, _ in pairs],
                               mesh))
    return map_spec(lambda s, x: next(whole), spec_tree, tree)


def sharding_pytree(spec_tree, mesh):
    """Each spec paired with the mesh: a tree of (mesh, spec)."""
    return map_spec(lambda s, _: (mesh, s), spec_tree, spec_tree)
