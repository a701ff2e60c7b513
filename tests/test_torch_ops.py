"""PyTorch port, ops: plain versions against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and its
counterpart in camliflow_torch. The four kernel modules' plain versions are
held against both the JAX XLA path and the Pallas kernel in interpret mode.
Selections are compared by the squared distances they select (rtol = atol =
1e-4, the policy of tests/test_pallas_kernels.py: rounding may swap
near-ties); FPS indices must be identical. The CUDA kernels themselves run
only on a card: tests/test_torch_kernels_cuda.py compares them with the
plain versions there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.ops import geometry as jgeo
from camliflow_tpu.ops import ids as jids
from camliflow_tpu.ops.pallas_corr3d import correlation3d_knn_pallas
from camliflow_tpu.ops.pallas_fps import furthest_point_sampling_pallas
from camliflow_tpu.ops.pallas_interp import knn_interpolation_pallas
from camliflow_tpu.ops.pallas_knn import k_nearest_neighbor_pallas
from camliflow_torch.ops import _cuda, corr3d, fps, geometry, ids, interp, knn

torch.set_num_threads(2)

SEL_TOL = dict(rtol=1e-4, atol=1e-4)
PERSP = {"sensor_h": 540, "sensor_w": 960, "f": 1050.0, "cx": 479.5, "cy": 269.5}


def clouds(seed, batch=2, n=512, ids_space=False):
    """Gaussian clouds, optionally moved into IDS (parallel) coordinates,
    where the coordinates reach ~100 and distances round more coarsely."""
    rng = np.random.RandomState(seed)
    pc = rng.randn(batch, n, 3).astype(np.float32)
    if ids_space:
        pc[..., 2] = np.abs(pc[..., 2]) * 10 + 5
        paral = jids.make_parallel_camera_info(540, 960)
        pc = np.array(jids.persp2paral(jnp.asarray(pc), PERSP, paral))
    return pc


def t(a):
    return torch.from_numpy(np.array(a))


def selected(dist, idx):
    return np.take_along_axis(np.asarray(dist), np.asarray(idx).astype(np.int64), -1)


def test_squared_distance_matches_jax():
    a, b = clouds(0)[:, :200], clouds(1)
    ref = np.asarray(jgeo.squared_distance(jnp.asarray(a), jnp.asarray(b)))
    got = geometry.squared_distance(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_knn_from_dists_lowest_index_on_ties():
    dists = np.array([[[3.0, 1.0, 1.0, 0.5, 1.0, 2.0]]], np.float32)
    ref = np.asarray(jgeo.knn_from_dists(jnp.asarray(dists), 4))
    got = geometry.knn_from_dists(t(dists), 4).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [[[3, 1, 2, 4]]])
    assert got.dtype == np.int32


@pytest.mark.parametrize("ids_space", [False, True])
@pytest.mark.parametrize("k", [3, 16, 32])
def test_knn_plain_matches_xla_and_pallas(k, ids_space):
    pts, q = clouds(2, ids_space=ids_space), clouds(3, ids_space=ids_space)[:, :256]
    d = jgeo.squared_distance(jnp.asarray(q), jnp.asarray(pts))
    xla = jgeo.k_nearest_neighbor(jnp.asarray(pts), jnp.asarray(q), k)
    pallas = k_nearest_neighbor_pallas(jnp.asarray(pts), jnp.asarray(q), k, interpret=True)
    got = knn.k_nearest_neighbor_plain(t(pts), t(q), k).numpy()
    assert got.shape == (2, 256, k) and got.dtype == np.int32
    for ref in (xla, pallas):
        np.testing.assert_allclose(selected(d, got), selected(d, ref), **SEL_TOL)
    # the geometry entry point dispatches to the wrapper, which on the CPU
    # takes the plain version and launches nothing
    before = knn.k_nearest_neighbor.launches
    np.testing.assert_array_equal(geometry.k_nearest_neighbor(t(pts), t(q), k).numpy(), got)
    assert knn.k_nearest_neighbor.launches == before


def test_gather_points_matches_jax():
    rng = np.random.RandomState(4)
    data = rng.randn(2, 50, 7).astype(np.float32)
    idx = rng.randint(0, 50, (2, 9, 4)).astype(np.int32)
    ref = np.asarray(jgeo.gather_points(jnp.asarray(data), jnp.asarray(idx)))
    np.testing.assert_array_equal(geometry.gather_points(t(data), t(idx)).numpy(), ref)
    ref2 = np.asarray(jgeo.gather_points(jnp.asarray(data[..., 0]), jnp.asarray(idx)))
    np.testing.assert_array_equal(
        geometry.gather_points(t(data[..., 0]), t(idx)).numpy(), ref2
    )


@pytest.mark.parametrize("ids_space", [False, True])
def test_fps_plain_matches_xla_and_pallas(ids_space):
    pc = clouds(5, ids_space=ids_space)
    xla = np.asarray(jgeo.furthest_point_sampling(jnp.asarray(pc), 128))
    pallas = np.asarray(furthest_point_sampling_pallas(jnp.asarray(pc), 128, interpret=True))
    got = fps.furthest_point_sampling_plain(t(pc), 128).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(geometry.furthest_point_sampling(t(pc), 128).numpy(), xla)


@pytest.mark.parametrize("channels", [3, 5])
def test_interp_plain_matches_xla_and_pallas(channels):
    rng = np.random.RandomState(6)
    src, q = clouds(7), clouds(8)[:, :300]
    feats = rng.randn(2, 512, channels).astype(np.float32)
    args = (jnp.asarray(src), jnp.asarray(feats), jnp.asarray(q))
    xla = np.asarray(jgeo.knn_interpolation(*args, k=3))
    pallas = np.asarray(knn_interpolation_pallas(*args, k=3, interpret=True))
    got = interp.knn_interpolation_plain(t(src), t(feats), t(q), 3).numpy()
    np.testing.assert_allclose(got, xla, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(
        geometry.knn_interpolation(t(src), t(feats), t(q)).numpy(), xla, atol=1e-5
    )


@pytest.mark.parametrize("ids_space", [False, True])
def test_backwarp_3d_matches_jax(ids_space):
    """Outputs agree wherever both sides pick the same 3 neighbours. In IDS
    coordinates (~100) the JAX package's expanded |q|^2 - 2q.p + |p|^2
    distances round at ~1e-3 and can mis-rank a near-tie; where the
    neighbour sets differ, the port's pick must be the truly nearer one
    (float64 distances), and such rows must stay rare."""
    xyz1, xyz2 = clouds(9, ids_space=ids_space), clouds(10, ids_space=ids_space)
    flow = 0.05 * np.random.RandomState(11).randn(*xyz1.shape).astype(np.float32)
    ref = np.asarray(jgeo.backwarp_3d(jnp.asarray(xyz1), jnp.asarray(xyz2), jnp.asarray(flow)))
    got = geometry.backwarp_3d(t(xyz1), t(xyz2), t(flow)).numpy()
    support = xyz1 + flow
    idx_ref = np.asarray(jgeo.k_nearest_neighbor(jnp.asarray(support), jnp.asarray(xyz2), 3))
    idx_got = knn.k_nearest_neighbor_plain(t(support), t(xyz2), 3).numpy()
    same = (np.sort(idx_ref, -1) == np.sort(idx_got, -1)).all(-1)
    np.testing.assert_allclose(got[same], ref[same], atol=1e-5)
    assert same.mean() > 0.99
    d64 = ((support[:, None].astype(np.float64) - xyz2[:, :, None]) ** 2).sum(-1)
    assert (selected(d64, idx_got).sum(-1) <= selected(d64, idx_ref).sum(-1))[~same].all()
    if not ids_space:
        assert same.all()


@pytest.mark.parametrize("ids_space", [False, True])
def test_corr3d_plain_matches_xla_and_pallas(ids_space):
    sizes, k = (256, 128, 64, 32), 16
    rng = np.random.RandomState(12)
    xyz1 = clouds(13, 1, 256, ids_space)
    xyz2 = clouds(14, 1, 256, ids_space)
    pyramid = rng.randn(1, 256, sum(sizes)).astype(np.float32)
    d = np.asarray(jgeo.squared_distance(jnp.asarray(xyz1), jnp.asarray(xyz2)))
    idx, cost = corr3d.correlation3d_knn_plain(t(xyz1), t(xyz2), t(pyramid), sizes, k)
    idx, cost = idx.numpy(), cost.numpy()
    assert idx.shape == cost.shape == (1, 256, len(sizes) * k) and idx.dtype == np.int32
    # XLA path: one distance matrix, a top-k per column-prefix
    xla = np.concatenate(
        [np.asarray(jgeo.knn_from_dists(jnp.asarray(d[:, :, :m]), k)) for m in sizes], -1
    )
    pallas_idx, pallas_cost = correlation3d_knn_pallas(
        jnp.asarray(xyz1), jnp.asarray(xyz2), jnp.asarray(pyramid), sizes, k=k,
        interpret=True,
    )
    for ref in (xla, np.asarray(pallas_idx)):
        np.testing.assert_allclose(selected(d, idx), selected(d, ref), **SEL_TOL)
    # every level selects within its own prefix
    for level, m in enumerate(sizes):
        assert idx[..., level * k:(level + 1) * k].max() < m
    # the cost is the pyramid entry at the level's offset + the index
    offsets = np.repeat(np.cumsum([0, *sizes[:-1]]), k)
    np.testing.assert_array_equal(cost, selected(pyramid, idx + offsets))
    if (idx == np.asarray(pallas_idx)).all():
        np.testing.assert_array_equal(cost, np.asarray(pallas_cost))
    np.testing.assert_array_equal(
        corr3d.level_offsets(sizes, k).numpy(), offsets
    )


def test_build_pc_pyramid_matches_jax():
    pc1, pc2 = clouds(15), clouds(16)
    ns = [256, 128, 64, 32, 16]
    ref = jgeo.build_pc_pyramid(jnp.asarray(pc1), jnp.asarray(pc2), ns)
    got = geometry.build_pc_pyramid(t(pc1), t(pc2), ns)
    for ref_list, got_list in zip(ref, got):
        assert len(ref_list) == len(got_list) == len(ns) + 1
        for r, g in zip(ref_list, got_list):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_ids_matches_jax():
    rng = np.random.RandomState(17)
    pc = rng.randn(2, 64, 3).astype(np.float32)
    pc[..., 2] = np.abs(pc[..., 2]) * 10 + 5
    f = np.float32([1050.0, 900.0])
    cam_j = {**PERSP, "f": jnp.asarray(f)}
    cam_t = {**PERSP, "f": t(f)}
    assert ids.make_parallel_camera_info(540, 960) == jids.make_parallel_camera_info(540, 960)
    paral = ids.make_parallel_camera_info(540, 960)
    fwd_ref = np.asarray(jids.persp2paral(jnp.asarray(pc), cam_j, paral))
    fwd = ids.persp2paral(t(pc), cam_t, paral)
    np.testing.assert_allclose(fwd.numpy(), fwd_ref, rtol=1e-6, atol=1e-5)
    back_ref = np.asarray(jids.paral2persp(jnp.asarray(fwd_ref), cam_j, paral))
    np.testing.assert_allclose(ids.paral2persp(fwd, cam_t, paral).numpy(), back_ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back_ref, pc, rtol=1e-4, atol=1e-4)


def test_wrappers_reject_mixed_devices():
    """A tensor that is not on the CPU never falls back to the plain version:
    the wrapper checks its arguments for the kernel and raises."""
    pts = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        knn.k_nearest_neighbor(pts, pts.to("meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        fps.furthest_point_sampling(pts.to("meta"), 4)
    with pytest.raises(ValueError, match="CUDA"):
        interp.knn_interpolation(pts, pts, pts.to("meta"), 3)
    with pytest.raises(ValueError, match="CUDA"):
        corr3d.correlation3d_knn(pts, pts, torch.zeros(1, 8, 12).to("meta"), (8, 4), 2)


class CudaStandIn:
    """What `_cuda.check` reads of a tensor: device, dtype, contiguity."""

    def __init__(self, index):
        self.device = torch.device("cuda", index)
        self.dtype = torch.float32

    def is_contiguous(self):
        return True


def test_check_refuses_inputs_off_the_current_device(monkeypatch):
    """Kernels launch on the current device's stream (csrc/build.py), so
    inputs on another card are refused rather than read from the wrong one."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _cuda.check("kernel", torch.float32, a=CudaStandIn(0), b=CudaStandIn(0))
    with pytest.raises(ValueError, match="current device"):
        _cuda.check("kernel", torch.float32, a=CudaStandIn(1), b=CudaStandIn(1))
    with pytest.raises(ValueError, match="one CUDA device"):
        _cuda.check("kernel", torch.float32, a=CudaStandIn(0), b=CudaStandIn(1))
