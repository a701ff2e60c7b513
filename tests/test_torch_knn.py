"""PyTorch port, kernels #1 (ops/knn.py::k_nearest_neighbor) and #3
(ops/interp.py::knn_interpolation): the split scan's rule, emulated in
numpy on the CPU.

Both CUDA kernels select through csrc/common.cuh::split_select: the
candidates [0, M) are cut into the slices of `knn.select_plan` (whole warp
steps of 128, `slice_start`), a warp per (query, slice) keeps its
slice's k nearest as a strictly-smaller insert in ascending index would
(a slice shorter than the list pads it with (inf, 0)), and a warp per query
merges the slices' sorted lists in ascending order by (distance, index).
The emulation below follows that rule
with tests/test_torch_corr3d.py's `slice_top_k` and `merge` on the plain
version's own distances; it must select exactly what the plain version's
stable sort selects, ties included. Against the JAX package's Pallas
kernels (interpret mode), which compute distances in expanded form and so
can rank near-ties differently, the selected distances are compared, with
rtol = atol = 1e-4, and the interpolation with atol 1e-5. The interpolation
emulation forms the weights in the kernel's order in float32 and is held to
the plain version with atol 1e-6. The kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py compares them with the plain versions
there.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camliflow_tpu.ops.pallas_interp import knn_interpolation_pallas
from camliflow_tpu.ops.pallas_knn import k_nearest_neighbor_pallas
from camliflow_torch.ops import interp, knn
from camliflow_torch.ops.geometry import squared_distance
from test_torch_corr3d import list_length, merge, slice_top_k

torch.set_num_threads(2)

SEL_TOL = dict(rtol=1e-4, atol=1e-4)
H100_SMS = 132
HEADER = (Path(__file__).resolve().parents[1] / "camliflow_torch" / "csrc"
          / "common.cuh").read_text()


def header_constants():
    """csrc/common.cuh's `kSelect*` constants (the kernels' one statement of
    the selection's step, chunk and block limits), in order, each expression
    evaluated with the ones before it."""
    values = {}
    for name, expr in re.findall(r"^constexpr int (kSelect\w+) = ([^;]+);", HEADER, re.M):
        values[name] = eval(expr, {"__builtins__": {}}, dict(values))
    return values


SELECT = header_constants()
MAX_SMEM = 232448  # 227 KB, a block's most on the H100


def slice_start(m, s, slices):
    """Where slice s of a scan over m candidates in `slices` slices starts
    (csrc/common.cuh slice_start): even lengths in whole warp steps, the
    last slice ending at m."""
    step = SELECT["kSelectStep"]
    return min(m, step * (-(-m // step) * s // slices))


def select_smem(m, queries, slices, k):
    """Bytes of shared memory a block takes (csrc/common.cuh
    split_select_smem): the staged candidates' x, y, z planes, a chunk
    padded to whole steps, and both lists of every (query, slice)."""
    step = SELECT["kSelectStep"]
    plane = -(-min(m, SELECT["kSelectChunk"]) // step) * step
    return 4 * (3 * plane + 2 * queries * (slices * list_length(k) + 1))


# every (batch, queries, candidates, k) the main paths give #1 and #3
MAIN_CALLS = {
    "encoder level 0": (2, 4096, 8192, 16),
    "encoder level 1": (2, 2048, 4096, 16),
    "pooling 2048": (1, 1024, 2048, 3),
    "pooling 1024": (1, 512, 1024, 3),
    "pooling 512": (1, 256, 512, 3),
    "update neighbours": (1, 2048, 2048, 32),
    "final upsample": (1, 8192, 2048, 3),
    "CLFM pixel cache": (2, 8160, 2048, 1),
    "backwarp": (1, 2048, 2048, 3),
}


def split_select(d, k, slices):
    """The kernels' selection for every query (row of d [N, M]), emulated:
    the slices' lists, then their merge in ascending order; the k first."""
    m = d.shape[1]
    kl = list_length(k)
    starts = [slice_start(m, s, slices) for s in range(slices + 1)]
    merged = slice_top_k(d, starts[0], starts[1], kl)
    for lo, hi in zip(starts[1:], starts[2:]):
        merged = merge(merged, slice_top_k(d, lo, hi, kl), kl)
    return merged[1][:, :k]


def emulate_knn(support, query, k, slices=None):
    """[B, N, k] int32 as the kernel selects, with the wrapper's plan unless
    `slices` is given."""
    batch, m = support.shape[:2]
    if slices is None:
        slices = knn.select_plan(batch, query.shape[1], m, k, H100_SMS)[0]
    d = squared_distance(query, support).numpy()
    return np.stack([split_select(d[b], k, slices) for b in range(batch)]).astype(np.int32)


def emulate_interp(support, feats, query, k):
    """The interpolation kernel's arithmetic in float32 on the emulated
    selection: sqrt, clamp, reciprocal, the total in list order, the
    division, and each channel's sum in list order."""
    idx = emulate_knn(support, query, k)
    s, f, q = support.numpy(), feats.numpy(), query.numpy()
    out = np.zeros(q.shape[:2] + f.shape[2:], np.float32)
    for b in range(s.shape[0]):
        diff = s[b][idx[b]] - q[b][:, None, :]  # [N, k, 3]
        dist = np.sqrt((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
                       + diff[..., 2] * diff[..., 2])
        w = np.float32(1) / np.maximum(dist, np.float32(1e-8))
        total = np.zeros(w.shape[0], np.float32)
        for j in range(k):
            total = total + w[:, j]
        w = w / total[:, None]
        for j in range(k):
            out[b] = out[b] + f[b][idx[b][:, j]] * w[:, j : j + 1]
    return out


def clouds(seed, batch, points, queries, ties=True):
    """(support [B, M, 3], queries [B, N, 3]) with exact ties, like
    tests/test_torch_corr3d.py's tied clouds: every 7th point repeats an
    earlier one, a block of the second half repeats early points, and every
    other query sits on a point (without `ties`, only the last)."""
    rng = np.random.RandomState(seed)
    support = rng.randn(batch, points, 3).astype(np.float32)
    support[..., 2] = np.abs(support[..., 2]) * 10 + 5
    if ties:
        support[:, 1::7] = support[:, 0 : 7 * len(support[0, 1::7]) : 7]
        half = points // 2
        copies = min(40, points - half, half - 3)
        support[:, half : half + copies] = support[:, 3 : 3 + copies]
    query = support[:, rng.permutation(points)[:queries]].copy()
    query[:, ::2] += 0.02 * rng.randn(batch, len(query[0, ::2]), 3).astype(np.float32)
    return torch.from_numpy(support), torch.from_numpy(query)


@pytest.mark.parametrize("points,queries,k,slices", [
    (300, 40, 1, 4),
    (300, 40, 3, 5),
    (515, 40, 16, 8),  # M no multiple of the slice count
    (515, 40, 32, 7),
    (40, 24, 32, 7),  # slices of 5-6 candidates, shorter than k = 32
    (16, 12, 16, 4),  # M = k
    (32, 12, 32, 3),
    (300, 40, 16, 1),  # one slice: no merge
])
def test_split_select_is_the_plain_selection_bit_for_bit(points, queries, k, slices):
    support, query = clouds(91, 2, points, queries)
    d = squared_distance(query, support).numpy()
    assert all(len(np.unique(row)) < len(row) for row in d[0])  # exact ties
    got = emulate_knn(support, query, k, slices)
    np.testing.assert_array_equal(got, knn.k_nearest_neighbor_plain(support, query, k).numpy())


@pytest.mark.parametrize("call", ["pooling 2048", "pooling 1024", "pooling 512",
                                  "update neighbours", "backwarp"])
def test_split_select_at_main_path_plans(call):
    """The plans of the main paths' calls that split their scans, on the
    first 24 queries of each cloud."""
    batch, _, m, k = MAIN_CALLS[call]
    slices = knn.select_plan(*MAIN_CALLS[call], H100_SMS)[0]
    assert slices > 1
    support, query = clouds(92, 1, m, 24)
    got = emulate_knn(support, query, k, slices)
    np.testing.assert_array_equal(got, knn.k_nearest_neighbor_plain(support, query, k).numpy())


def test_a_merge_that_breaks_ties_by_slice_order_backwards_fails():
    """The rule is what makes the selection exact: merging the later slice
    first keeps the higher index of an exact tie (queries sitting on points
    that the second slice repeats)."""
    support, _ = clouds(93, 1, 64, 16)
    query = support[:, 3:19].contiguous()  # repeated at 32..47
    d = squared_distance(query, support).numpy()[0]
    kl, starts = 4, (0, 32, 64)
    low, high = (slice_top_k(d, lo, hi, kl) for lo, hi in zip(starts, starts[1:]))
    ref = knn.k_nearest_neighbor_plain(support, query, 3).numpy()[0]
    np.testing.assert_array_equal(merge(low, high, kl)[1][:, :3], ref)
    assert not np.array_equal(merge(high, low, kl)[1][:, :3], ref)


@pytest.mark.parametrize("k", [1, 3, 16, 32])
def test_split_select_matches_pallas_by_selected_distance(k):
    support, query = clouds(94, 2, 300, 64)
    jax_idx = np.asarray(k_nearest_neighbor_pallas(
        jnp.asarray(support.numpy()), jnp.asarray(query.numpy()), k, interpret=True))
    got = emulate_knn(support, query, k)
    d = squared_distance(query, support).numpy()
    np.testing.assert_allclose(np.take_along_axis(d, got.astype(np.int64), -1),
                               np.take_along_axis(d, jax_idx.astype(np.int64), -1), **SEL_TOL)


@pytest.mark.parametrize("points,queries,channels,k", [
    (300, 50, 3, 3),  # the main paths' k and channels
    (515, 40, 7, 3),
    (40, 30, 3, 32),
])
def test_interp_emulation_matches_plain_and_pallas(points, queries, channels, k):
    """Against the plain version on clouds with exact ties; against the
    Pallas kernel on clouds without (it may take another of two tied
    points, whose features differ)."""
    rng = np.random.RandomState(96)
    feats = torch.from_numpy(rng.randn(2, points, channels).astype(np.float32))
    support, query = clouds(95, 2, points, queries)
    got = emulate_interp(support, feats, query, k)
    ref = interp.knn_interpolation_plain(support, feats, query, k).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    support, query = clouds(97, 2, points, queries, ties=False)
    pallas = np.asarray(knn_interpolation_pallas(
        jnp.asarray(support.numpy()), jnp.asarray(feats.numpy()), jnp.asarray(query.numpy()),
        k=k, interpret=True))
    np.testing.assert_allclose(emulate_interp(support, feats, query, k), pallas, rtol=0,
                               atol=1e-5)


# calls of few queries over many candidates: the slices stop at a block's warps
FEW_QUERY_CALLS = {
    "64 queries, 8192 candidates": (1, 64, 8192, 16),
    "1 query, 8192 candidates": (1, 1, 8192, 3),
    "100 queries, 8192 candidates": (1, 100, 8192, 32),
    "2 x 40 queries, 9000 candidates": (2, 40, 9000, 16),
}


def test_the_wrappers_constants_are_the_kernels():
    assert knn.STEP == SELECT["kSelectStep"]
    assert knn.BLOCK_WARPS == SELECT["kSelectMaxWarps"]


@pytest.mark.parametrize("call", sorted(MAIN_CALLS) + sorted(FEW_QUERY_CALLS))
def test_select_plan_fits_a_block_and_fills_the_card(call):
    batch, n, m, k = {**MAIN_CALLS, **FEW_QUERY_CALLS}[call]
    slices, queries, group = knn.select_plan(batch, n, m, k, H100_SMS)
    assert group in (1, 2) and queries % group == 0
    assert 1 <= slices <= -(-m // knn.STEP)  # every slice at least one step
    assert 1 <= queries // group * slices <= knn.BLOCK_WARPS  # <= 1024 threads
    assert select_smem(m, queries, slices, k) <= MAX_SMEM
    blocks, warps = batch * -(-n // queries), queries // group * slices
    # one wave of the card: every SM a block (128 of 132 at least), and no
    # block past the first wave unless every block is a full 32 warps
    assert blocks >= 0.96 * min(H100_SMS, batch * n // group)
    assert blocks <= H100_SMS or warps == knn.BLOCK_WARPS


@pytest.mark.parametrize("call", sorted(FEW_QUERY_CALLS))
def test_split_select_at_few_query_plans(call):
    """Few queries over many candidates: a block's 32 slices, merged in
    order, still select what the plain version selects."""
    batch, n, m, k = FEW_QUERY_CALLS[call]
    assert knn.select_plan(batch, n, m, k, H100_SMS)[0] == knn.BLOCK_WARPS
    support, query = clouds(98, batch, m, min(n, 12))
    np.testing.assert_array_equal(emulate_knn(support, query, k),
                                  knn.k_nearest_neighbor_plain(support, query, k).numpy())
