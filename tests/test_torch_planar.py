"""The planar slice of the port on the CPU against the JAX package: the
host repack, the planar and band stem twins, the block-2 twin, and the
GestSync tower on planar frames under every stem_impl / conv2_impl.

The JAX oracles run as the JAX package's own tests run them: its Pallas
kernels in interpret mode at small geometry (tests/test_stem_pallas.py:
179-245, tests/test_conv2_pallas.py:52-63), the whole tower on its raw XLA
path. The JAX package's planar tower is no oracle here: off the TPU it
interprets the stem at full size. The repack is an exact permutation plus
mask, so the JAX raw path on the same frames and chin rows serves instead.

Tolerances, stated per check: the repack is bit-exact; the stems
atol = rtol = 2e-5 (the JAX planar test's own bar, test_stem_pallas.py:
154-156); block 2 atol = rtol = 1e-4 (the JAX conv2 test's bar,
test_conv2_pallas.py:63: 1600-term sums of order-1 products); the tower
atol = rtol = 2e-5 (the JAX suite's path-equality bar)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.host import media
from jegal_tpu.models import gestsync as JG
from jegal_tpu.ops.pallas import conv2 as JC2
from jegal_tpu.ops.pallas import stem as JS
from jegal_tpu.ops.video import mask_frames_device as jax_mask_frames
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    tree_to_torch,
)
from jegal_torch.models import gestsync as TG
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import conv2 as TC2
from jegal_torch.ops.kernels import stem as TS
from jegal_torch.ops.video import s2d_repack, s2d_unpack
from torch_threads import few_torch_threads  # noqa: F401

STEM_TOL = dict(rtol=2e-5, atol=2e-5)
CONV2_TOL = dict(rtol=1e-4, atol=1e-4)
TOWER_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jax_params():
    """A GestSync tree with randomized BatchNorm statistics, numpy leaves
    in the JAX layout (drawn by the port's init from a seed)."""
    tree = init_gestsync_params(torch.Generator().manual_seed(41))
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return gestsync_params_from_jax(jax_params)


def _mgrid_dense(m, w_pool):
    """The m-grid's valid even lanes (t, J, 64, SLOT) -> dense (t, J,
    w_pool, 64)."""
    return np.asarray(m)[..., 0:2 * w_pool:2].transpose(0, 1, 3, 2)


@pytest.mark.parametrize("cut", ["chin rows", "none", "zero", "past H",
                                 "negative"])
def test_s2d_repack_matches_the_cpp_repack(cut):
    rng = np.random.default_rng(5)
    t, h = 4, 270
    frames = rng.integers(0, 256, (t, h, 480, 3), dtype=np.uint8)
    cuts = {"chin rows": rng.integers(90, 200, t).astype(np.int32),
            "none": None,
            "zero": np.zeros(t, np.int32),
            "past H": np.full(t, h + 7, np.int32),
            "negative": np.array([-5, 0, 3, h], np.int32)}[cut]
    got = s2d_repack(frames, cuts)
    want = media.s2d_repack(frames, cuts)
    assert got.dtype == np.uint8 and got.shape == want.shape == (t, 90, 27,
                                                                 160)
    np.testing.assert_array_equal(got, want)
    if cuts is None:
        assert torch.equal(s2d_unpack(torch.from_numpy(got)),
                           torch.from_numpy(frames))


@pytest.mark.parametrize("impl", ["window", "band"])
@pytest.mark.parametrize("u8_direct,pair_dot", [(False, False), (True, True),
                                                (False, True)])
def test_planar_stem_twin_matches_pallas(jax_params, impl, u8_direct,
                                         pair_dot):
    """stem_pool_planar on the CPU (the twin of both kernels) against
    stem_mgrid_planar(impl, u8_direct, pair_dot) interpreted, on (12, 27,
    24, 3) frames with chin rows: the TPU flags schedule the same
    function, and the port owes them this parity only."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (12, 27, 24, 3), dtype=np.uint8)
    cut = rng.integers(0, 12, 12).astype(np.int32)
    blk = jax_params["net_vid"][0]
    lhs, scale, bias = JS.stem_kernel_params(blk)
    m = JS.stem_mgrid_planar(jnp.asarray(media.s2d_repack(frames, cut)), lhs,
                             scale, bias, dtype=jnp.float32, interpret=True,
                             impl=impl, u8_direct=u8_direct,
                             pair_dot=pair_dot)
    want = _mgrid_dense(m, 2)
    ops = TS.stem_kernel_params(tree_to_torch(blk))
    _build.reset_launches()
    got = TS.stem_pool_planar(torch.from_numpy(s2d_repack(frames, cut)), *ops,
                              impl=impl).numpy()
    assert got.shape == want.shape == (8, 3, 2, 64)
    np.testing.assert_allclose(got, want, **STEM_TOL)
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("shape", [(24, 33, 24), (13, 45, 48)])
def test_band_stem_twin_float_entry_matches_pallas(jax_params, shape):
    """stem_pool(impl="band") on the CPU against stem_mgrid_x(impl="band")
    interpreted, across T blocks and both j parities of the band rotation
    (test_stem_pallas.py:189)."""
    t4, h, w = shape
    frames = np.random.default_rng(7).random((t4, h, w, 3)) \
        .astype(np.float32)
    blk = jax_params["net_vid"][0]
    lhs, scale, bias = JS.stem_kernel_params(blk)
    m = JS.stem_mgrid_x(JS.s2d_lanes(jnp.asarray(frames)), lhs, scale, bias,
                        w_valid=w // 3, interpret=True, impl="band")
    ops = TS.stem_kernel_params(tree_to_torch(blk))
    got = TS.stem_pool(torch.from_numpy(frames), *ops, impl="band").numpy()
    want = _mgrid_dense(m, got.shape[2])
    assert got.shape == want.shape == TS.pooled_shape(t4, h, w)
    np.testing.assert_allclose(got, want, **STEM_TOL)


def test_stem_impl_is_checked(jax_params):
    ops = TS.stem_kernel_params(tree_to_torch(jax_params["net_vid"][0]))
    with pytest.raises(ValueError, match="impl"):
        TS.stem_pool(torch.zeros(5, 27, 24, 3), *ops, impl="rotate")
    with pytest.raises(ValueError, match="impl"):
        TS.stem_pool_planar(torch.zeros(5, 9, 27, 8, dtype=torch.uint8), *ops,
                            impl="rotate")


@pytest.mark.parametrize("t,n_j,w_pool", [(10, 7, 10), (18, 11, 14),
                                          (3, 5, 5)])
def test_conv2_twin_matches_pallas(jax_params, t, n_j, w_pool):
    """conv2_bn_relu on the CPU against mgrid_conv2_fused interpreted; the
    port's dense input is the m-grid's even lanes. Block 2's folded scale
    and bias match conv2_kernel_params' (both fold in float32; rtol 1e-6
    allows the last-bit difference of two rsqrt implementations)."""
    blk2 = jax_params["net_vid"][1]
    dense = np.random.default_rng(8).standard_normal(
        (t, n_j, w_pool, 64)).astype(np.float32)
    m = np.zeros((t, n_j, 64, JS.SLOT), np.float32)
    m[..., 0:2 * w_pool:2] = dense.transpose(0, 1, 3, 2)
    jops = JC2.conv2_kernel_params(blk2)
    want = np.asarray(JC2.mgrid_conv2_fused(jnp.asarray(m), *jops, w_pool,
                                            interpret=True))
    ops = TC2.conv2_kernel_params(tree_to_torch(blk2))
    np.testing.assert_allclose(ops[1].numpy(), np.asarray(jops[2])[:, 0],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(ops[2].numpy(), np.asarray(jops[3])[:, 0],
                               rtol=1e-6, atol=1e-7)
    got = TC2.conv2_bn_relu(torch.from_numpy(dense), *ops)
    assert tuple(got.shape) == want.shape == TC2.out_shape(t, n_j, w_pool)
    np.testing.assert_allclose(got.numpy(), want, **CONV2_TOL)
    assert TC2.conv2_ok(w_pool, n_j) and not TC2.conv2_ok(4, n_j)


@pytest.fixture(scope="module")
def clip7():
    rng = np.random.default_rng(9)
    return (rng.integers(0, 256, (7, 270, 480, 3), dtype=np.uint8),
            rng.integers(90, 200, 7).astype(np.int32))


@pytest.fixture(scope="module")
def jax_tower(jax_params, clip7):
    frames, cut = clip7
    return np.asarray(JG.extract_features(
        jax_params, jax_mask_frames(jnp.asarray(frames), jnp.asarray(cut)),
        use_pallas=False))


@pytest.mark.parametrize("stem_impl", ["window", "band"])
@pytest.mark.parametrize("conv2_impl", ["dense", "kernel"])
def test_planar_tower_matches_jax_raw_tower(port_params, clip7, jax_tower,
                                            stem_impl, conv2_impl):
    """extract_features_planar on s2d_repack(frames, chin rows), each
    setting on its CPU twins, against the JAX raw XLA tower on the same
    frames: 7 frames of 270x480, 31 after the edge pad."""
    frames, cut = clip7
    with torch.inference_mode():
        got = TG.extract_features_planar(
            port_params, torch.from_numpy(s2d_repack(frames, cut)),
            stem_impl=stem_impl, conv2_impl=conv2_impl).numpy()
    assert got.shape == jax_tower.shape == (7, 1024)
    np.testing.assert_allclose(got, jax_tower, **TOWER_TOL)


def test_tower_impls_are_checked(port_params, clip7):
    planar = torch.from_numpy(s2d_repack(clip7[0][:1]))
    with pytest.raises(ValueError, match="conv2_impl"):
        TG.extract_features_planar(port_params, planar, conv2_impl="mgrid")
