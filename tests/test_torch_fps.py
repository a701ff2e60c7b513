"""PyTorch port, furthest-point sampling: the tie rule of csrc/fps.cu's split
argmax, emulated in numpy on the CPU.

The kernel cuts each cloud into 4 slices, one a block of a thread-block
cluster, and pads each block's threads to 16 points (distance 0, index
INT_MAX); a thread keeps the first index of its maximum, a warp reduces its
threads by (max distance, min index), and the blocks' warps' winners are
merged the same way. The emulation below walks those levels and must give
the plain version's indices (and the Pallas kernel's, in interpret mode) bit
for bit on clouds with duplicated, equidistant and identical points and on
slices of uneven length; a merge that keeps the last index of the maximum
must not. The CUDA kernel itself runs only on a card:
tests/test_torch_kernels_cuda.py compares it with the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.ops.pallas_fps import furthest_point_sampling_pallas
from camliflow_torch.ops import fps

torch.set_num_threads(2)

N_SAMPLES = 96


def duplicated_cloud(seed=0, n=512):
    """Gaussian points, every fifth a copy of the point half a cloud away
    (in another slice)."""
    rng = np.random.RandomState(seed)
    pc = rng.randn(n, 3).astype(np.float32)
    pc[1::5] = pc[(np.arange(1, n, 5) + n // 2) % n]
    return pc


def lattice_cloud(n=512):
    """Integer lattice points: distances are exact, and many are equal."""
    g = np.arange(8, dtype=np.float32)
    pc = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return np.ascontiguousarray(pc[np.random.RandomState(1).permutation(len(pc))][:n])


def tiled_cloud(n=512):
    """A quarter of the lattice four times over: every point has a copy in
    each of the four slices."""
    return np.ascontiguousarray(np.tile(lattice_cloud(n // 4), (4, 1)))


def identical_cloud(n=700):
    """One point n times: every distance after the first step is 0, so only
    the index rule (and the padding's) decides."""
    return np.full((n, 3), 0.25, np.float32)


CLOUDS = {
    "duplicated": duplicated_cloud,
    "lattice": lattice_cloud,
    "tiled": tiled_cloud,
    "identical": identical_cloud,
    "duplicated_1001": lambda: duplicated_cloud(2, 1001),  # slices of 251 and 248
    "lattice_343": lambda: lattice_cloud(343),
    "duplicated_8192": lambda: duplicated_cloud(3, 8192),  # the main path's size
    "small_10": lambda: duplicated_cloud(4, 10),  # most threads are padding
}
# where a merge that keeps the last index of the maximum gives other indices
LAST_MERGE_FAILS = ("duplicated", "lattice", "tiled", "identical")
THREADS, PER_THREAD = 128, 16  # csrc/fps.cu kThreads, kPer
PAD = 0x7FFFFFFF


def winners(group: np.ndarray, dist: np.ndarray, idx: np.ndarray, last: bool = False):
    """Per group, the (distance, index) that wins: the largest distance, then
    the lowest index (`last`: the highest). Returns the winners' positions."""
    tie = idx if last else -idx
    order = np.lexsort((tie, dist, group))  # ascending: a group's winner comes last
    ends = np.flatnonzero(np.diff(group[order], append=group[order][-1] + 1))
    return order[ends]


def split_fps(pc: np.ndarray, n_samples: int, last_merge: bool = False):
    """csrc/fps.cu's steps on one cloud [N, 3]: block r holds points
    [r * chunk, min(N, (r + 1) * chunk)), its thread t the points
    begin + t + j * THREADS, j < PER_THREAD, the rest padding; each step
    reduces threads, then warps, then the blocks' warp winners (`last_merge`:
    that merge keeps the last index of the maximum)."""
    n = len(pc)
    assert n <= fps.MAX_POINTS == fps.CLUSTER * THREADS * PER_THREAD
    chunk = -(-n // fps.CLUSTER)
    block, t, j = np.meshgrid(np.arange(fps.CLUSTER), np.arange(THREADS), np.arange(PER_THREAD),
                              indexing="ij")
    block, t, j = block.ravel(), t.ravel(), j.ravel()
    i = block * chunk + t + j * THREADS
    real = i < np.minimum(n, (block + 1) * chunk)
    idx = np.where(real, i, PAD)
    thread = block * THREADS + t
    warp = thread // 32
    dist = np.where(real, np.float32(1e10), np.float32(0))
    out, farthest = [], 0
    for _ in range(n_samples):
        out.append(farthest)
        d = pc[np.where(real, i, 0)] - pc[farthest]  # one rounding per operation, as the kernel
        sq = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        dist = np.where(real, np.minimum(dist, sq), dist)
        at = winners(thread, dist, idx)  # a thread: the first index of its maximum
        at = at[winners(warp[at], dist[at], idx[at])]  # a warp's redux pair
        at = at[winners(np.zeros_like(at), dist[at], idx[at], last=last_merge)]
        farthest = int(idx[at[0]])
    return np.asarray(out, np.int32)


def n_samples_of(pc: np.ndarray) -> int:
    return min(N_SAMPLES, len(pc))


@pytest.fixture(scope="module")
def references():
    """The plain version's and the Pallas kernel's indices for each cloud."""
    refs = {}
    for name, make in CLOUDS.items():
        pc = make()
        plain = fps.furthest_point_sampling_plain(torch.from_numpy(pc)[None], n_samples_of(pc))[0]
        pallas = furthest_point_sampling_pallas(jnp.asarray(pc)[None], n_samples_of(pc),
                                                interpret=True)[0]
        refs[name] = (pc, plain.numpy(), np.asarray(pallas))
    return refs


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_split_argmax_matches_plain_and_pallas(references, cloud):
    pc, plain, pallas = references[cloud]
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(split_fps(pc, n_samples_of(pc)), plain)


@pytest.mark.parametrize("cloud", LAST_MERGE_FAILS)
def test_a_merge_that_keeps_the_last_index_fails(references, cloud):
    """The tie rule matters on these clouds: keeping the last index of the
    maximum across warps and blocks gives other indices."""
    pc, plain, _ = references[cloud]
    assert not np.array_equal(split_fps(pc, n_samples_of(pc), last_merge=True), plain)


def test_capacity_holds_the_main_path():
    """The kernel's 4 blocks x 128 threads x 16 points take the main path's
    8192 points."""
    assert fps.MAX_POINTS == fps.CLUSTER * THREADS * PER_THREAD >= 8192
