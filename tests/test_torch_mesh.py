"""The port's mesh module (jegal_torch/parallel/mesh.py) and its collectives
(parallel/collectives.py) on the CPU.

- The spec trees against the JAX package's (jegal_tpu/parallel/mesh.py),
  leaf for leaf, PartitionSpecs read as tuples.
- In one process, with no group: the helpers' defaults, the collectives as
  identities, and the errors of an indivisible mesh and of a mesh without
  a group.
- On gloo ranks (tests/torch_mesh_worker.py, `mesh` task) at meshes (1, 2)
  and (2, 2): make_mesh's layout (rank = d * mp + m, JAX's reshape) and its
  error at an indivisible world, host_shard and the shard defaults,
  put_batch's rows, each collective's forward and backward against the
  same sums computed here in one process, and a shard / gather round trip
  of a JEGAL tree, bit for bit, with each rank's blocks the contiguous
  slices of the whole leaves.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec

from jegal_torch.parallel import collectives as C
from jegal_torch.parallel import mesh as M
from jegal_tpu.parallel import mesh as JM
from torch_mesh_worker import Job, collective_inputs
from torch_threads import few_torch_threads  # noqa: F401
from torch_tiny import setup_step, tiny_jegal

MESHES = [(1, 2), (2, 2)]


def _as_tuples(spec_tree):
    return jax.tree.map(tuple, spec_tree,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


def test_spec_trees_equal_jax():
    assert M.jegal_param_spec() == _as_tuples(JM.jegal_param_spec())
    for n in (1, 12):
        assert M.roberta_param_spec(n) == _as_tuples(
            JM.roberta_param_spec(n))
    assert M.replicated(None) == ()
    assert M.data_sharded(None, 3) == ("data", None, None)


def test_spec_tree_fits_the_parameter_tree():
    """One spec a leaf, in param_leaves' order, each sharded dim
    divisible by 4 ranks."""
    from jegal_torch.training.trainer import param_leaves, param_spec

    jp = tiny_jegal(1, 2)
    specs = M.spec_leaves(param_spec(jp))
    leaves = param_leaves(jp)
    assert len(specs) == len(leaves)
    shapes = M.map_spec(lambda s, x: (s, tuple(x.shape)), param_spec(jp), jp)
    for spec, leaf in zip(specs, leaves):
        assert len(spec) <= leaf.dim()
        for dim, axis in enumerate(spec):
            if axis is not None:
                assert leaf.shape[dim] % 4 == 0
    assert shapes["encoder_text"]["layers"][0]["attn"]["o"]["kernel"] == \
        (("model", None), (768, 768))
    with pytest.raises(ValueError, match="keys"):
        M.shard_pytree({"a": torch.zeros(2)}, {"b": ()}, None)


def test_no_group_defaults_and_errors():
    assert M.world_size() == 1
    assert M.resolve_shard() == (0, 1)
    assert M.resolve_shard(3, 8) == (3, 8)
    assert M.host_shard(range(5)) == [0, 1, 2, 3, 4]
    assert M.host_shard(range(10), 1, 3) == [1, 4, 7]
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh(1, 1)
    with pytest.raises(ValueError, match="does not divide"):
        M.check_mesh_shape(4, 3)
    x = torch.randn(2, 3)
    for fn in (C.copy_to_model, C.reduce_from_model, C.gather_from_data):
        assert fn(x, None) is x
    assert C.group_size(None) == 1
    got = M.put_batch([np.ones((4, 2), np.float32)], None, "cpu")[0]
    assert got.shape == (4, 2) and got.device.type == "cpu"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's `mesh` task, all started together -> {mesh: [result of
    each rank]}."""
    root = tmp_path_factory.mktemp("mesh")
    jobs = {m: Job("mesh", m[0] * m[1], root / f"{m[0]}x{m[1]}",
                   {"mp": m[1]}) for m in MESHES}
    return {m: job.results() for m, job in jobs.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_make_mesh_layout_and_shard_defaults(ranks, mesh):
    dp, mp = mesh
    world = dp * mp
    for r, out in enumerate(ranks[mesh]):
        assert out["layout"] == np.arange(world).reshape(dp, mp).tolist()
        assert out["coord"] == [r // mp, r % mp]
        assert "does not divide" in out["indivisible"]
        assert out["shard"] == list(range(10))[r::world]
        assert out["resolved"] == (r, world)
        assert out["explicit"] == (3, 8)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_put_batch_keeps_this_ranks_rows(ranks, mesh):
    dp, mp = mesh
    feats = setup_step()[3]["visual_feats"]
    n = feats.shape[0] // dp
    for r, out in enumerate(ranks[mesh]):
        d = r // mp
        torch.testing.assert_close(out["rows"], feats[d * n:(d + 1) * n],
                                   rtol=0, atol=0)


def _groups(dp, mp, r):
    """The global ranks of rank r's model group and data group."""
    d, m = divmod(r, mp)
    return [d * mp + j for j in range(mp)], [i * mp + m for i in range(dp)]


@pytest.mark.parametrize("what", ["copy", "reduce", "gather", "sum_over"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collective_forward_and_backward(ranks, mesh, what):
    """Each rank's forward and input gradient against the sums over its
    groups, computed here from every rank's inputs."""
    dp, mp = mesh
    inputs = [collective_inputs(r) for r in range(dp * mp)]
    for r, out in enumerate(ranks[mesh]):
        model, data = _groups(dp, mp, r)
        d = data.index(r)
        x, w, big_w = inputs[r]
        if what == "copy":       # identity; backward sums over 'model'
            want = (inputs[0][0], sum(inputs[j][1] for j in model))
        elif what == "reduce":   # sum over 'model'; backward identity
            want = (sum(inputs[j][0] for j in model), w)
        elif what == "gather":   # rows in data order; backward own rows
            want = (torch.cat([inputs[i][0] for i in data]),
                    big_w[2 * d:2 * d + 2])
        else:
            want = [sum(inputs[i][0] for i in data),
                    sum(inputs[i][1] for i in data)]
        for got, exp in zip(out[what], want):
            torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shard_gather_roundtrip(ranks, mesh):
    """gather_pytree(shard_pytree(tree)) is the tree bit for bit, and each
    rank's blocks are contiguous slices: q and w1 by columns (heads [m H /
    mp, (m + 1) H / mp)), o and w2 by rows, o's and w2's biases whole."""
    dp, mp = mesh
    layer = tiny_jegal(1, 2)["encoder_text"]["layers"][0]
    for r, out in enumerate(ranks[mesh]):
        assert out["roundtrip_jegal"]
        m = r % mp
        cols = slice(m * 768 // mp, (m + 1) * 768 // mp)
        ffn = slice(m * 3072 // mp, (m + 1) * 3072 // mp)
        want = {"q": (layer["attn"]["q"]["kernel"][:, cols],
                      layer["attn"]["q"]["bias"][cols]),
                "o": (layer["attn"]["o"]["kernel"][cols],
                      layer["attn"]["o"]["bias"]),
                "w1": (layer["ff"]["w1"]["kernel"][:, ffn],
                       layer["ff"]["w1"]["bias"][ffn]),
                "w2": (layer["ff"]["w2"]["kernel"][ffn],
                       layer["ff"]["w2"]["bias"])}
        for k, (kernel, bias) in want.items():
            got_k, got_b = out["text_layer0"][k]
            assert torch.equal(got_k, kernel) and torch.equal(got_b, bias), k
