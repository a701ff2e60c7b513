"""k-nearest-neighbour selection: CUDA kernel, plain version, wrapper.

Replaces camliflow_tpu/ops/pallas_knn.py::k_nearest_neighbor_pallas with
`csrc/knn.cu`: a split scan. Each query's candidates are cut into
contiguous slices; a warp per (slice, 1 or 2 queries) keeps each query's
k nearest of its slice in a sorted list spread over its lanes, inserting
in ascending index after every entry not farther, and a warp per query
merges the slices' lists by (distance, index), so equal distances keep the
lowest index first, as the plain version's stable sort does. `select_plan`
sizes the slices, blocks and pairs; `csrc/interp.cu` (#3) selects the same
way. See the source for the design note.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .geometry import knn_from_dists, squared_distance

MAX_K = 32
SLICE_WARPS = 4096  # warps a call splits its scans up to (31 an SM)
# shared with csrc/common.cuh (tests/test_torch_knn.py holds them to it)
BLOCK_WARPS = 32  # a block's warps, at most (kSelectMaxWarps)
STEP = 128  # candidates a warp takes a step, 4 a lane (kSelectStep)


def select_plan(batch: int, n: int, m: int, k: int, sms: int) -> tuple[int, int, int]:
    """How the kernels split a selection of k of m candidates for batch * n
    queries on a card of `sms` SMs: (slices a query, queries a block,
    queries a warp).

    A warp scans one slice for 1 query, or for 2 where the queries alone
    give 48 warps an SM (the step's loads then serve both; measured faster
    at 8192 queries, slower at 4096). Slices only where the queries give
    fewer than SLICE_WARPS warps, each of at least one step and at most a
    block's warps: a slice costs its query a merge and a list's first
    inserts. Queries a block: a power of two, up to 32 warps (a block
    stages the candidates once), and as many as leave about `sms` blocks:
    one wave of the card. (Blocks this large fit one an SM, so on the H100's
    132 SMs a plan of 133 to 137 blocks, a 62nd or 31st query less a
    block, ran a second wave.)"""
    rows = max(1, batch * n)
    group = 2 if rows >= 48 * sms else 1
    slices = max(1, min(-(-m // STEP), SLICE_WARPS // rows, BLOCK_WARPS))
    wave = 1 << (-(-rows // sms) - 1).bit_length()  # queries a block for `sms` blocks, rounded up
    return slices, max(group, min(BLOCK_WARPS // slices * group, wave)), group


def k_nearest_neighbor_plain(
    input_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int
) -> torch.Tensor:
    """Dense distances + stable sort: [B, N, k] int32, ascending distance."""
    return knn_from_dists(squared_distance(query_xyz, input_xyz), k)


def k_nearest_neighbor(
    input_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int
) -> torch.Tensor:
    """[B, M, D] points, [B, N, D] queries, D = 3 or 2 -> [B, N, k] int32
    indices.

    CPU tensors take the plain version; CUDA tensors the kernel. 2-D points
    (CLFM's projected uv) reach the kernel with a zero third coordinate,
    which adds an exact 0*0 to every distance and changes no rounding."""
    if _cuda.on_cpu(input_xyz, query_xyz):
        return k_nearest_neighbor_plain(input_xyz, query_xyz, k)
    name = "k_nearest_neighbor"
    _cuda.check(name, torch.float32, input_xyz=input_xyz, query_xyz=query_xyz)
    batch, m, dim = input_xyz.shape
    if dim == 2:
        input_xyz = F.pad(input_xyz, (0, 1))
        query_xyz = F.pad(query_xyz, (0, 1))
    _cuda.check_shape(name, "input_xyz", input_xyz, (batch, m, 3))
    _cuda.check_shape(name, "query_xyz", query_xyz, (batch, None, 3))
    if not 1 <= k <= min(MAX_K, m):
        raise ValueError(f"{name}: need 1 <= k <= min({MAX_K}, M={m}), got {k}")
    n = query_xyz.shape[1]
    out = torch.empty(batch, n, k, dtype=torch.int32, device=input_xyz.device)
    from ..csrc.build import launch

    launch("camli_knn", input_xyz.data_ptr(), query_xyz.data_ptr(),
           out.data_ptr(), batch, m, n, k,
           *select_plan(batch, n, m, k, _cuda.sm_count(input_xyz.device)))
    k_nearest_neighbor.launches += 1
    return out


k_nearest_neighbor.launches = 0
