"""PyTorch port, kernel #4 (ops/corr3d.py::correlation3d_knn): the split
scan's rule, emulated in numpy on the CPU and held to the plain version bit
for bit.

The CUDA kernel (camliflow_torch/csrc/corr3d.cu) cuts each query's
candidate scan into the slices of `corr3d.scan_plan`, keeps each slice's
k nearest with a strictly-smaller insert in ascending index, and merges the
slices' sorted lists in ascending order by (distance, index), the lower
slice first on equal distances. The emulation below follows that rule step
by step on the plain version's own distances; on clouds with duplicated
points (exact ties across slices and levels) it must select exactly what
the plain version's stable sort selects. The kernel itself runs only on a
card: tests/test_torch_kernels_cuda.py compares it with the plain version
there; tests/test_torch_ops.py holds the plain version to the JAX package.
"""

import numpy as np
import pytest
import torch

from camliflow_torch.ops import corr3d
from camliflow_torch.ops.geometry import squared_distance

FLAGSHIP_LEVELS = (2048, 1024, 512, 256)


def list_length(k):
    """The kernel's compiled list length for k (CAMLI_DISPATCH_K)."""
    return next(kl for kl in (4, 8, 16, 32) if k <= kl)


def slice_top_k(d, lo, hi, kl):
    """camli::insert_sorted over candidates lo..hi-1 in ascending index, for
    every query (row of d) at once: a candidate enters when it is strictly
    nearer than the last entry, after every entry not farther."""
    queries = d.shape[0]
    dist = np.full((queries, kl), np.inf, np.float32)
    index = np.zeros((queries, kl), np.int64)
    cols = np.arange(kl)[None]
    for j in range(lo, hi):
        dj = d[:, j : j + 1]
        pos = np.where(dj[:, 0] < dist[:, -1], (dist <= dj).sum(1), kl)[:, None]
        shift_d = np.concatenate([dist[:, :1], dist[:, :-1]], 1)
        shift_i = np.concatenate([index[:, :1], index[:, :-1]], 1)
        dist = np.where(cols < pos, dist, np.where(cols == pos, dj, shift_d))
        index = np.where(cols < pos, index, np.where(cols == pos, j, shift_i))
    return dist, index


def merge(a, b, kl):
    """camli::merge_sorted: a's entry e takes place e + #{b < a_e}, b's entry e
    place e + #{a <= b_e} (the lower slice first on equal distances); the kl
    first places are kept."""
    (ad, ai), (bd, bi) = a, b
    place_a = np.arange(kl) + (bd[:, None, :] < ad[:, :, None]).sum(-1)
    place_b = np.arange(kl) + (ad[:, None, :] <= bd[:, :, None]).sum(-1)
    places = np.concatenate([place_a, place_b], 1)
    dist, index = np.concatenate([ad, bd], 1), np.concatenate([ai, bi], 1)
    out_d, out_i = np.empty_like(ad), np.empty_like(ai)
    for row in range(ad.shape[0]):
        keep = places[row] < kl
        assert sorted(places[row][keep]) == list(range(kl))  # distinct places
        out_d[row, places[row][keep]] = dist[row][keep]
        out_i[row, places[row][keep]] = index[row][keep]
    return out_d, out_i


def split_scan(xyz1, xyz2, pyramid, level_sizes, k):
    """The kernel's selection and costs, emulated (batch 1)."""
    d = squared_distance(xyz1, xyz2[:, : level_sizes[0]])[0].numpy()
    kl = list_length(k)
    starts, _ = corr3d.scan_plan(level_sizes)
    lists = [slice_top_k(d, lo, hi, kl) for lo, hi in zip(starts, starts[1:])]
    merged, levels = lists[0], {}
    for s in range(1, len(starts)):
        for level, m in enumerate(level_sizes):
            if starts[s] == m:
                levels[level] = merged[1][:, :k]
        if s < len(lists):
            merged = merge(merged, lists[s], kl)
    idx = np.concatenate([levels[level] for level in range(len(level_sizes))], -1)
    offsets = corr3d.level_offsets(level_sizes, k).numpy()
    cost = np.take_along_axis(pyramid[0].numpy(), idx + offsets, -1)
    return idx[None].astype(np.int32), cost[None]


def tied_clouds(seed, queries, points):
    """Queries and points with exact ties: every 7th point repeats an
    earlier one, a block of the second half repeats the first points, and
    some queries sit on points."""
    rng = np.random.RandomState(seed)
    xyz2 = rng.randn(1, points, 3).astype(np.float32)
    xyz2[..., 2] = np.abs(xyz2[..., 2]) * 10 + 5
    m = len(xyz2[0, 1::7])
    xyz2[0, 1::7] = xyz2[0, 0 : 7 * m : 7]
    xyz2[0, points // 2 : points // 2 + 40] = xyz2[0, 3:43]
    xyz1 = xyz2[:, rng.permutation(points)[:queries]].copy()
    xyz1[:, ::2] += 0.02 * rng.randn(1, len(xyz1[0, ::2]), 3).astype(np.float32)
    pyramid = rng.randn(1, queries, points + points).astype(np.float32)
    return torch.from_numpy(xyz1), torch.from_numpy(xyz2), torch.from_numpy(pyramid)


@pytest.mark.parametrize("level_sizes,k", [
    (FLAGSHIP_LEVELS, 16),  # the flagship's Correlation3D
    (FLAGSHIP_LEVELS, 1),
    ((300, 50), 16),  # sizes that are no multiples of the slice length
    ((300, 50), 32),
])
def test_split_scan_rule_is_the_plain_selection_bit_for_bit(level_sizes, k):
    xyz1, xyz2, pyramid = tied_clouds(90, 48, level_sizes[0] + 7)
    pyramid = pyramid[..., : sum(level_sizes)].contiguous()
    d = squared_distance(xyz1, xyz2)
    assert all(len(np.unique(row)) < len(row) for row in d[0].numpy())  # exact ties
    idx, cost = split_scan(xyz1, xyz2, pyramid, level_sizes, k)
    ref_idx, ref_cost = corr3d.correlation3d_knn_plain(xyz1, xyz2, pyramid, level_sizes, k)
    np.testing.assert_array_equal(idx, ref_idx.numpy())
    np.testing.assert_array_equal(cost, ref_cost.numpy())


@pytest.mark.parametrize("level_sizes", [FLAGSHIP_LEVELS, (300, 50), (256, 128, 64, 32),
                                         (8192, 4096, 2048), (16,), (1000, 999, 17)])
def test_scan_plan_slices_follow_the_levels(level_sizes):
    starts, queries = corr3d.scan_plan(level_sizes)
    lengths = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == level_sizes[0]
    assert (lengths >= 1).all() and (lengths <= corr3d.SLICE).all()
    assert set(level_sizes) <= set(starts)  # no slice straddles a level boundary
    bounds = [0, *reversed(level_sizes)]
    for lo, hi in zip(bounds, bounds[1:]):  # each level range split evenly
        inner = lengths[starts.index(lo) : starts.index(hi)]
        assert inner.max() - inner.min() <= 1
    n_slices = len(starts) - 1
    assert n_slices <= corr3d.MAX_SLICES and 1 <= queries * n_slices <= 1024


def test_scan_plan_fills_the_card_at_the_flagship_shape():
    """2048 queries at the flagship's levels: 16 slices of 128 candidates,
    16 queries a block, so 128 blocks (one thread per query gave 16)."""
    starts, queries = corr3d.scan_plan(FLAGSHIP_LEVELS)
    assert len(starts) - 1 == 16 and queries == 16
    assert -(-2048 // queries) >= 128
