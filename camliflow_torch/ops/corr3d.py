"""Correlation3D: the prefix-level selection with cost extraction, and the
tail after it. CUDA kernels, plain versions, wrappers.

`correlation3d_knn` replaces camliflow_tpu/ops/pallas_corr3d.py::
correlation3d_knn_pallas (exact mode, with cost, and the training path's
index-only form, `with_cost=False`) with `csrc/corr3d.cu`. The
frame-2 levels are row-prefixes of one FPS order, so one scan per query in
ascending index serves every level. The kernel splits that scan into slices
that follow the levels (`scan_plan`), keeps each slice's k nearest with a
strictly-smaller insert, and merges the slices' sorted lists in ascending
order by (distance, index): after the slices below a level's prefix length,
the merge holds that level's k nearest, ties broken as one scan would. See
the source for the design note.

`corr3d_tail` replaces ::corr3d_tail_pallas with `csrc/corr3d_tail.cu`: the
rel-xyz gather, the 2-layer cost MLP on [rel_xyz, cost], the sum over each
level's k neighbours and the merge layer, on weights packed once per request
by `prepare_corr3d_tail_params`.

On the fast path (`fast_inference=on`) the concatenated pyramid is stored
int8 with a scale per query row (`geometry.quantize_rows_int8`): #4 selects
exactly as on f32 (the selection reads only coordinates) and returns the
selected int8 costs as f32, which is exact; #5 multiplies each selected
cost by its row's scale before the cost MLP, as the TPU kernel's `scale`
argument does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _cuda
from .geometry import gather_points, knn_from_dists, squared_distance
from .knn import MAX_K

MAX_LEVELS = 8  # csrc/corr3d.cu kMaxLevels
MAX_SLICES = 256  # csrc/corr3d.cu kMaxSlices
SLICE = 128  # candidates one thread of the kernel scans, at most
BLOCK_QUERIES = 16  # queries a block takes, at most: 2048 queries fill 128 blocks
BLOCK_SLOTS = 256  # (query, slice) threads a block aims at
TAIL_MAX_HIDDEN = 32  # csrc/corr3d_tail.cu: a tap's cost-MLP channels in registers
TAIL_MAX_OUT = 128  # and the merge's two output slots of 64 a thread


def level_offsets(level_sizes, k: int, device=None) -> torch.Tensor:
    """[L*k] column offset of each selected entry's level in the pyramid."""
    starts = [sum(level_sizes[:l]) for l in range(len(level_sizes))]
    return torch.tensor(starts, device=device).repeat_interleave(k)


def scan_plan(level_sizes: tuple[int, ...]) -> tuple[tuple[int, ...], int]:
    """How the kernel splits each query's candidate scan: (the slices'
    starts, ending with m_0; queries per block). Each level range
    [m_{l+1}, m_l), and [0, m_{L-1}), is split evenly into slices of at most
    SLICE candidates, so no slice straddles a level boundary."""
    bounds = [0, *reversed(level_sizes)]
    starts = []
    for lo, hi in zip(bounds, bounds[1:]):
        n = -(-(hi - lo) // SLICE)
        starts += [lo + (hi - lo) * i // n for i in range(n)]
    starts.append(level_sizes[0])
    return tuple(starts), max(1, min(BLOCK_QUERIES, BLOCK_SLOTS // (len(starts) - 1)))


@functools.lru_cache(maxsize=16)
def _plan_arrays(level_sizes: tuple[int, ...]):
    """The kernel's C arrays for `level_sizes`: the sizes and the slice
    starts, with the slice count and queries per block (built once, as the
    refinement loop calls the kernel with the same levels every time)."""
    starts, queries = scan_plan(level_sizes)
    if len(starts) - 1 > MAX_SLICES:
        raise ValueError(f"correlation3d_knn: {level_sizes[0]} candidates need more than "
                         f"{MAX_SLICES} slices of {SLICE}")
    sizes = (ctypes.c_int * len(level_sizes))(*level_sizes)
    return sizes, (ctypes.c_int * len(starts))(*starts), len(starts) - 1, queries


def correlation3d_knn_plain(
    xyz1: torch.Tensor,
    xyz2_warp: torch.Tensor,
    pyramid_cat: torch.Tensor | None,
    level_sizes: tuple[int, ...],
    k: int = 16,
    with_cost: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One distance matrix over the widest prefix; each level selects from
    its column-prefix; the cost is read at offset_l + idx, as f32 (not with
    `with_cost=False`, which returns (indices, None))."""
    dists = squared_distance(xyz1, xyz2_warp[:, : level_sizes[0]])
    idx = torch.cat(
        [knn_from_dists(dists[:, :, :m], k) for m in level_sizes], dim=-1
    )
    if not with_cost:
        return idx, None
    columns = idx.long() + level_offsets(level_sizes, k, idx.device)
    return idx, torch.gather(pyramid_cat, 2, columns).float()


def correlation3d_knn(
    xyz1: torch.Tensor,
    xyz2_warp: torch.Tensor,
    pyramid_cat: torch.Tensor | None,
    level_sizes: tuple[int, ...],
    k: int = 16,
    with_cost: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-level prefix KNN plus cost extraction.

    xyz1 [B, N, 3] queries; xyz2_warp [B, M, 3] warped frame 2 (levels are
    row-prefixes); pyramid_cat [B, N, sum(level_sizes)], f32 or (the fast
    path) int8; level_sizes descending. Returns (indices [B, N, L*k] int32
    grouped by level, costs [B, N, L*k] f32: an int8 pyramid's values,
    exact). With `with_cost=False` (training: indices only; the
    caller gathers the costs differentiably) the pyramid is not read and
    may be None, and the costs are None. CPU tensors take the plain
    version; CUDA tensors the kernel. The index-only launches count on
    `correlation3d_knn.index_launches`, the int8 form's on
    `.fast_launches`, the others on `.launches`."""
    level_sizes = tuple(int(m) for m in level_sizes)
    if not with_cost:
        pyramid_cat = None
    if _cuda.on_cpu(*(t for t in (xyz1, xyz2_warp, pyramid_cat) if t is not None)):
        return correlation3d_knn_plain(xyz1, xyz2_warp, pyramid_cat, level_sizes, k,
                                       with_cost)
    name = "correlation3d_knn"
    _cuda.check(name, torch.float32, xyz1=xyz1, xyz2_warp=xyz2_warp)
    int8 = with_cost and pyramid_cat.dtype == torch.int8
    if with_cost:
        _cuda.check(name, torch.int8 if int8 else torch.float32, pyramid_cat=pyramid_cat)
        if pyramid_cat.device != xyz1.device:
            raise ValueError(f"{name}: all inputs must lie on one CUDA device, got "
                             f"{xyz1.device} and {pyramid_cat.device}")
    batch, n = xyz1.shape[:2]
    m_rows = xyz2_warp.shape[1]
    m_total = sum(level_sizes)
    _cuda.check_shape(name, "xyz1", xyz1, (batch, n, 3))
    _cuda.check_shape(name, "xyz2_warp", xyz2_warp, (batch, m_rows, 3))
    if with_cost:
        _cuda.check_shape(name, "pyramid_cat", pyramid_cat, (batch, n, m_total))
    n_levels = len(level_sizes)
    descending = all(a > b for a, b in zip(level_sizes, level_sizes[1:]))
    if not (1 <= n_levels <= MAX_LEVELS and descending
            and level_sizes[0] <= m_rows and 1 <= k <= min(MAX_K, level_sizes[-1])):
        raise ValueError(f"{name}: need 1..{MAX_LEVELS} strictly descending "
                         f"levels within M={m_rows} and 1 <= k <= "
                         f"min({MAX_K}, smallest level); got {level_sizes}, k={k}")
    sizes, starts, n_slices, queries = _plan_arrays(level_sizes)
    idx = torch.empty(batch, n, n_levels * k, dtype=torch.int32, device=xyz1.device)
    cost = None
    if with_cost:
        cost = torch.empty(batch, n, n_levels * k, dtype=torch.float32, device=xyz1.device)
    from ..csrc.build import launch

    launch("camli_corr3d", xyz1.data_ptr(), xyz2_warp.data_ptr(),
           None if cost is None else pyramid_cat.data_ptr(), idx.data_ptr(),
           None if cost is None else cost.data_ptr(), int(int8), batch, n, m_rows, m_total,
           n_levels, ctypes.addressof(sizes), n_slices, ctypes.addressof(starts), queries, k)
    if with_cost:
        _cuda.count(correlation3d_knn, int8)
    else:
        correlation3d_knn.index_launches += 1
    return idx, cost


correlation3d_knn.launches = 0
correlation3d_knn.index_launches = 0
correlation3d_knn.fast_launches = 0  # the fast path's int8-pyramid form


# --- the tail (kernel #5) --------------------------------------------------


class TailParams(NamedTuple):
    """The tail's dense layers, each weight [in, out] f32."""

    w1: torch.Tensor  # [4, C1]: [rel_xyz, cost] -> hidden
    b1: torch.Tensor
    w2: torch.Tensor  # [C1, C1]
    b2: torch.Tensor
    wm: torch.Tensor  # [L * C1, Cout]: the merge over the level sums
    bm: torch.Tensor


def prepare_corr3d_tail_params(correlation: nn.Module) -> TailParams:
    """The six dense operands of a `models.camliraft_l.Correlation3D`, packed
    once per request: its cost MLP and merge carry no norm, so weights and
    biases describe the tail."""
    _cuda.forward_only_modules("prepare_corr3d_tail_params", correlation)
    first, second = (conv.conv_fn for conv in correlation.cost_mlp.convs)
    merge = correlation.merge.conv_fn

    def pair(linear):
        return (linear.weight.detach().float().t().contiguous(),
                linear.bias.detach().float().contiguous())

    return TailParams(*pair(first), *pair(second), *pair(merge))


def corr3d_tail_plain(xyz1, xyz2_warp, idx, cost, params: TailParams, n_levels: int, k: int,
                      scale=None):
    """The tail as torch ops: gather, (dequantisation,) cost MLP, per-level
    sum, merge."""
    if scale is not None:
        cost = cost * scale
    rel = gather_points(xyz2_warp, idx) - xyz1[:, :, None, :]  # [B, N, L*k, 3]
    payload = torch.cat([rel, cost[..., None]], dim=-1)
    hidden = F.relu(F.linear(payload, params.w1.t(), params.b1))
    hidden = F.relu(F.linear(hidden, params.w2.t(), params.b2))
    batch, n = xyz1.shape[:2]
    levels = hidden.reshape(batch, n, n_levels, k, -1).sum(dim=3)
    out = F.linear(levels.reshape(batch, n, -1), params.wm.t(), params.bm)
    return F.leaky_relu(out, negative_slope=0.1)


def corr3d_tail(xyz1: torch.Tensor, xyz2_warp: torch.Tensor, idx: torch.Tensor,
                cost: torch.Tensor, params: TailParams, n_levels: int, k: int,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """xyz1 [B, N, 3], xyz2_warp [B, M, 3], idx [B, N, L*k] int32 and cost
    [B, N, L*k] (from `correlation3d_knn`) -> [B, N, Cout]. On the fast
    path `scale` [B, N, 1], the int8 pyramid's row scales, multiplies each
    selected cost first; without it the kernel is the exact path's, bit for
    bit. CPU tensors take the plain version; CUDA tensors the kernel. The
    scaled form's launches count on `.fast_launches`."""
    _cuda.forward_only("corr3d_tail", xyz1, xyz2_warp, cost)
    if _cuda.on_cpu(xyz1, xyz2_warp, idx, cost):
        return corr3d_tail_plain(xyz1, xyz2_warp, idx, cost, params, n_levels, k, scale)
    name = "corr3d_tail"
    _cuda.check(name, torch.float32, xyz1=xyz1, xyz2_warp=xyz2_warp, cost=cost,
                **params._asdict(), **({} if scale is None else {"scale": scale}))
    _cuda.check(name, torch.int32, idx=idx)
    batch, n = xyz1.shape[:2]
    taps = n_levels * k
    _cuda.check_shape(name, "xyz1", xyz1, (batch, n, 3))
    _cuda.check_shape(name, "xyz2_warp", xyz2_warp, (batch, None, 3))
    _cuda.check_shape(name, "idx", idx, (batch, n, taps))
    _cuda.check_shape(name, "cost", cost, (batch, n, taps))
    if scale is not None:
        _cuda.check_shape(name, "scale", scale, (batch, n, 1))
    if idx.device != xyz1.device:
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, got "
                         f"{xyz1.device} and {idx.device}")
    c1, c_out = params.w2.shape[0], params.wm.shape[1]
    shapes = [tuple(t.shape) for t in params]
    if shapes != [(4, c1), (c1,), (c1, c1), (c1,), (n_levels * c1, c_out), (c_out,)]:
        raise ValueError(f"{name}: the packed layers {shapes} do not fit {n_levels} levels")
    if not (1 <= c1 <= TAIL_MAX_HIDDEN and 1 <= c_out <= TAIL_MAX_OUT and 1 <= n_levels <= MAX_LEVELS):
        raise ValueError(f"{name}: need hidden width <= {TAIL_MAX_HIDDEN}, output width <= "
                         f"{TAIL_MAX_OUT} and 1..{MAX_LEVELS} levels; got {c1}, {c_out}, "
                         f"{n_levels}")
    if params.wm.data_ptr() % 16:
        raise ValueError(f"{name}: the merge weights must start at a 16-byte aligned address "
                         "(the kernel copies them 16 bytes at a time)")
    out = xyz1.new_empty(batch, n, c_out)
    from ..csrc.build import launch

    launch("camli_corr3d_tail", xyz1.data_ptr(), xyz2_warp.data_ptr(), idx.data_ptr(),
           cost.data_ptr(), None if scale is None else scale.data_ptr(),
           *(t.data_ptr() for t in params), out.data_ptr(), batch, n,
           xyz2_warp.shape[1], n_levels, k, c1, c_out)
    _cuda.count(corr3d_tail, scale is not None)
    return out


corr3d_tail.launches = 0
corr3d_tail.fast_launches = 0  # the fast path's form, with the row scales
