"""Batched k-major row gather: CUDA kernel, plain version, wrapper.

Replaces camliflow_tpu/ops/pallas_gather.py::gather_points_kmajor with
`csrc/gather.cu`: data [B, N, C] and indices [B, M, k] -> [B, k, M, C], each
tap a contiguous [M, C] slab, which the kernel writes a tile of T query
points at a time from a shared staging buffer (`gather_plan` picks T and,
for rows wider than the buffer, the piece of a row; rows narrower than 16
bytes go a word a thread). The copy is exact in any element type of 4, 2
or 1 bytes (f32, int32, bf16, int8); see the source's note for the design.
Consumers contract over k anyway (PointConv's einsum, the upsample's
weighted sum), so the k-major layout needs no transpose back.

    gather_points_kmajor(data, idx)              -> [B, k, M, C]
    gather_points_fast(data, idx)                -> [B, M, k, C] (a view)
    knn_weighted_sum(data, idx, weights)         -> [B, M, C]

The last two keep the JAX signatures (pallas_gather.py:101-141) without the
`fast` switch: the port has one path, the kernel on a card and the plain
version on the CPU.
"""

from __future__ import annotations

import torch

from . import _cuda
from .geometry import gather_points

WORD_LIMIT = 2**31  # gather_kmajor_words indexes the output with 32-bit words
NARROW_BYTES = 16  # narrower rows go a word a thread (csrc/gather.cu: gather_kmajor_words)
SLAB_BYTES = 24576  # the staging buffer: one slab of T rows
ROWS_MAX = 1024  # T at most


def gather_plan(batch: int, m: int, k: int, row_bytes: int, sms: int) -> tuple[int, int]:
    """(T, piece) for csrc/gather.cu: T query points a block, each row copied
    in pieces of `piece` bytes; (0, 0) for rows narrower than NARROW_BYTES,
    which take the word-a-thread kernel. T is the largest multiple of 16 (at
    most ROWS_MAX) whose slab fits SLAB_BYTES, so a slab is a whole number of
    16-byte chunks (rows too wide for 16 take fewer, and rows wider than the
    buffer one, in pieces), lowered by 16 while the grid of (tile, tap,
    sample) blocks has fewer than two blocks an SM."""
    if row_bytes < NARROW_BYTES:
        return 0, 0
    if row_bytes > SLAB_BYTES:
        return 1, SLAB_BYTES
    fit = SLAB_BYTES // row_bytes
    rows = min(ROWS_MAX, fit // 16 * 16) if fit >= 16 else fit
    while rows > 16 and batch * k * -(-m // rows) < 2 * sms:
        rows -= 16
    return rows, row_bytes


def gather_points_kmajor_plain(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return gather_points(data, idx).permute(0, 2, 1, 3)


def gather_points_kmajor(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] data of a 4-, 2- or 1-byte type, [B, M, k] indices ->
    [B, k, M, C], bit-identical to `gather_points(data, idx)` transposed.
    CPU tensors take the plain version; CUDA tensors the kernel, which takes
    int32 indices in [0, N)."""
    if _cuda.on_cpu(data, idx):
        return gather_points_kmajor_plain(data, idx)
    name = "gather_points_kmajor"
    _cuda.check(name, data.dtype, data=data)
    _cuda.check(name, torch.int32, idx=idx)
    if idx.device != data.device:
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, got "
                         f"{data.device} and {idx.device}")
    if data.element_size() not in (1, 2, 4):
        raise TypeError(f"{name}: data must have 4-, 2- or 1-byte elements, got {data.dtype}")
    _cuda.check_shape(name, "data", data, (None, None, None))
    batch, n, channels = data.shape
    _cuda.check_shape(name, "idx", idx, (batch, None, None))
    m, k = idx.shape[1:]
    out = data.new_empty(batch, k, m, channels)
    row_bytes = channels * data.element_size()
    if out.numel() * data.element_size() >= WORD_LIMIT:
        raise ValueError(f"{name}: the output {tuple(out.shape)} is 2 GiB or more")
    from ..csrc.build import launch

    plan = gather_plan(batch, m, k, row_bytes, _cuda.sm_count(data.device))
    launch("camli_gather_kmajor", data.data_ptr(), idx.data_ptr(), out.data_ptr(), batch, n,
           m, k, row_bytes, *plan)
    gather_points_kmajor.launches += 1
    return out


gather_points_kmajor.launches = 0


def gather_points_fast(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`gather_points` for [B, N, C] data and [B, M, k] indices, through the
    k-major gather: [B, M, k, C], a transposed view of its output."""
    return gather_points_kmajor(data, idx).permute(0, 2, 1, 3)


def knn_weighted_sum(data: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor):
    """sum_j data[idx[:, :, j]] * weights[:, :, j]: [B, N, C], [B, M, k],
    [B, M, k] -> [B, M, C], contracted k-major off the gather."""
    gathered = gather_points_kmajor(data, idx)  # [B, k, M, C]
    return torch.sum(gathered * weights.transpose(1, 2)[..., None], dim=1)


# --- tools/probe_gather_matrix.py's cases, as k-major row gathers ----------

# (name, rows, width, dtype, form); the probe's own list (its lines 109-122).
# "dim0" gathers rows; "cast" gathers bf16 rows, then widens them to f32;
# "lane" gathers columns (the rows of the transposed table); "packed" gathers
# the rows of a bf16 table's int32 view (pairs of bf16 in one word).
PROBE_CASES = (
    ("f32 [1024,128] dim0", 1024, 128, torch.float32, "dim0"),
    ("f32 [8192,128] dim0", 8192, 128, torch.float32, "dim0"),
    ("i32 [1024,128] dim0", 1024, 128, torch.int32, "dim0"),
    ("bf16 [1024,128] dim0", 1024, 128, torch.bfloat16, "dim0"),
    ("bf16->f32-cast [1024,128] dim0", 1024, 128, torch.bfloat16, "cast"),
    ("int8 [1024,128] dim0", 1024, 128, torch.int8, "dim0"),
    ("f32 [1024,8] dim0 (narrow)", 1024, 8, torch.float32, "dim0"),
    ("f32 [1024,3] dim0 (xyz)", 1024, 3, torch.float32, "dim0"),
    ("f32 [4096,3] dim0 (xyz big)", 4096, 3, torch.float32, "dim0"),
    ("f32 [8,1024] dim1 (lane)", 8, 1024, torch.float32, "lane"),
    ("f32 [128,128] dim1 (lane)", 128, 128, torch.float32, "lane"),
    ("bf16-as-i32-packed [1024,128] dim0", 1024, 128, torch.bfloat16, "packed"),
)


def probe_case(case, generator: torch.Generator, device):
    """One probe case as a B=1, k=1 gather on `device`, its table and indices
    made as the probe makes them. Returns (data [1, R, C], idx [1, R', 1]
    int32, finish, want): `finish(gather_points_kmajor(data, idx))` must
    equal `want`, torch indexing's result, bit for bit."""
    _, rows, width, dtype, form = case
    table = torch.randn(rows, width, generator=generator, device=device)
    if dtype == torch.int8:
        table = torch.clamp(table * 64, -127, 127).to(torch.int8)
    elif dtype == torch.int32:
        table = (table * 64).to(torch.int32)
    else:
        table = table.to(dtype)
    n_idx = width if form == "lane" else rows
    idx = torch.randint(0, n_idx, (n_idx,), generator=generator, device=device)
    gather_idx = idx.int()[None, :, None]
    if form == "lane":
        return (table.t().contiguous()[None], gather_idx, lambda g: g[0, 0].t(),
                table[:, idx])
    if form == "cast":
        return table[None], gather_idx, lambda g: g[0, 0].float(), table[idx].float()
    if form == "packed":
        return (table.view(torch.int32)[None], gather_idx,
                lambda g: g[0, 0].view(torch.bfloat16), table[idx])
    return table[None], gather_idx, lambda g: g[0, 0], table[idx]
