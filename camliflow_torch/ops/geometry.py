"""Point-cloud geometry: pairwise distance, KNN, gather, interpolation, FPS.

PyTorch counterpart of camliflow_tpu/ops/geometry.py. Layout is channel-last:
points `[B, N, 3]`, features `[B, N, C]`, indices int32.

Every distance used for a selection is written per coordinate,
`dx*dx + dy*dy + dz*dz`, one rounding per operation. The CUDA kernels compute
the same expression without multiply-add contraction, so on the card a kernel
and its plain version select the same neighbours, ties included. The JAX
package expands `|q|^2 - 2 q.p + |p|^2` on its matrix unit instead; the two
differ only by rounding, and the direct form is the more exact of the two.

The selection functions (`k_nearest_neighbor`, `knn_interpolation`,
`furthest_point_sampling`) dispatch to the kernel modules `knn`, `interp` and
`fps`: a CPU tensor takes the plain version there, a CUDA tensor the kernel.
The interpolation's kernel (#3) has no backward, so the train paths use
`knn_interpolation_train` (and `backwarp_3d(..., train=True)`) on either
device: the selection by KNN (#1 on a card), without a gradient, then the
weights and the weighted sum as differentiable torch ops.
"""

from __future__ import annotations

import logging

import torch


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantisation along the last axis, as the JAX
    package's fast path stores its loop-constant cost volumes: (q int8,
    scale f32 with a trailing 1-axis), x ~ q * scale, scale = max|row| / 127
    (at least 1e-12 / 127), q rounded half to even and clipped to +-127.
    The int8 values are exact in any float type, so a selection from them
    stays exact; only the dequantised magnitude rounds (at most
    max|row| / 254). A tensor of more than two dimensions is taken one slice
    of its first axis at a time, so its f32 temporaries are one slice's."""
    if x.dim() > 2:
        parts = [quantize_rows_int8(item) for item in x]
        return torch.stack([q for q, _ in parts]), torch.stack([s for _, s in parts])
    x = x.float()
    # max |row| without a full-size temporary; the quotient rounded and
    # clipped in place: one f32 temporary the size of x
    amax = torch.maximum(x.amax(dim=-1, keepdim=True), -x.amin(dim=-1, keepdim=True))
    scale = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    q = torch.div(x, scale).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


_FAST_LOGGED = False


def resolve_fast_inference(mode: str, final_only: bool) -> bool:
    """The `model.fast_inference` config key: whether a forward takes the
    fast path (bf16 operands, int8 and bf16 cost-volume storage).

    "on" takes it whenever the model evaluates (final-only); "off" never;
    "auto" means fast only on a TPU, so on a CUDA card or the CPU it is the
    exact path. Training (final_only False) is always exact: the fast path
    is forward-only. Logs once when the fast path first engages."""
    global _FAST_LOGGED
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fast_inference must be auto|on|off, got {mode!r}")
    fast = mode == "on" and final_only
    if fast and not _FAST_LOGGED:
        logging.getLogger("camliflow_torch").info(
            "fast_inference engaged (mode=%s): int8 cost volumes, bf16 point-conv "
            "gathers and bf16 operands of the 2D update chain; set "
            "model.fast_inference=off for the exact eval path", mode)
        _FAST_LOGGED = True
    return fast


def squared_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """[B, N, D] x [B, M, D] -> [B, N, M] squared distances (f32)."""
    a = xyz1.float()[:, :, None, :]
    b = xyz2.float()[:, None, :, :]
    dist = None
    for c in range(a.shape[-1]):
        d = a[..., c] - b[..., c]
        dist = d * d if dist is None else dist + d * d
    return dist


def knn_from_dists(dists: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last axis, ascending,
    lowest index first on ties (`lax.top_k` on negated distances).
    `torch.topk` leaves the order of ties undefined, so this sorts stably."""
    return torch.sort(dists, dim=-1, stable=True).indices[..., :k].int()


def k_nearest_neighbor(
    input_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int
) -> torch.Tensor:
    """[B, M, 3] points, [B, N, 3] queries -> [B, N, k] int32 indices."""
    from .knn import k_nearest_neighbor as knn

    return knn(input_xyz, query_xyz, k)


def gather_points(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Batched gather along the points axis.

    data [B, N, C] (or [B, N]); indices [B, I1, ..., Im] -> [B, I1, ..., Im, C]
    (or without C). Indices may be int32; they widen here for torch.gather.
    """
    squeeze = data.dim() == 2
    if squeeze:
        data = data[..., None]
    batch, _, channels = data.shape
    flat = indices.reshape(batch, -1).long()
    out = torch.gather(data, 1, flat[..., None].expand(-1, -1, channels))
    out = out.reshape(*indices.shape, channels)
    return out[..., 0] if squeeze else out


def knn_interpolation(
    input_xyz: torch.Tensor,
    input_features: torch.Tensor,
    query_xyz: torch.Tensor,
    k: int = 3,
) -> torch.Tensor:
    """Inverse-distance weighted interpolation from the k nearest supports."""
    from .interp import knn_interpolation as interp

    return interp(input_xyz, input_features, query_xyz, k)


def interpolation_weights(
    input_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int = 3
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest supports of each query, [B, N, k] int32, selected
    without a gradient, and their inverse-distance weights [B, N, k] (f32),
    differentiable in both point sets: 1 / max(|support - query|, 1e-8),
    normalised (camliflow_tpu/ops/geometry.py::knn_interpolation)."""
    with torch.no_grad():
        idx = k_nearest_neighbor(input_xyz.detach(), query_xyz.detach(), k)
    diff = (gather_points(input_xyz, idx) - query_xyz[:, :, None, :]).float()
    weights = 1.0 / torch.clamp(torch.linalg.vector_norm(diff, dim=-1), min=1e-8)
    return idx, weights / weights.sum(dim=-1, keepdim=True)


def weighted_sum(features: torch.Tensor, idx: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """sum_j features[idx[..., j]] * weights[..., j] in the features' dtype:
    [B, M, C], [B, N, k], [B, N, k] -> [B, N, C]."""
    feats = gather_points(features, idx)
    return torch.sum(feats * weights[..., None].to(feats.dtype), dim=2)


def knn_interpolation_train(
    input_xyz: torch.Tensor,
    input_features: torch.Tensor,
    query_xyz: torch.Tensor,
    k: int = 3,
) -> torch.Tensor:
    """`knn_interpolation` as the train paths take it: differentiable in all
    three inputs, with no kernel of its own (the selection is KNN's)."""
    return weighted_sum(input_features, *interpolation_weights(input_xyz, query_xyz, k))


def backwarp_3d(
    xyz1: torch.Tensor, xyz2: torch.Tensor, flow12: torch.Tensor, k: int = 3,
    train: bool = False,
) -> torch.Tensor:
    """Warp `xyz2` towards frame 1 by interpolating the negated flow; with
    `train`, through the differentiable interpolation."""
    xyz1_warp = xyz1 + flow12
    interp = knn_interpolation_train if train else knn_interpolation
    flow21 = interp(xyz1_warp, -flow12, xyz2, k=k)
    return xyz2 + flow21


def furthest_point_sampling(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """[B, N, 3] -> [B, n_samples] int32; start at 0, first max on ties."""
    from .fps import furthest_point_sampling as fps

    return fps(xyz, n_samples)


def build_pc_pyramid(pc1: torch.Tensor, pc2: torch.Tensor, n_samples_list):
    """Nested FPS pyramids for two clouds from ONE FPS at max(n_samples_list);
    coarser levels are prefixes of the same order. Returns (xyzs1, xyzs2,
    sample_indices1, sample_indices2), each with the full cloud first."""
    batch, n_points, _ = pc1.shape
    both = furthest_point_sampling(
        torch.cat([pc1, pc2], dim=0), max(n_samples_list)
    )
    index1, index2 = both[:batch], both[batch:]
    lv0 = torch.arange(n_points, dtype=torch.int32, device=pc1.device)
    lv0 = lv0[None].expand(batch, n_points)
    xyzs1, xyzs2 = [pc1], [pc2]
    indices1, indices2 = [lv0], [lv0]
    for n_samples in n_samples_list:
        idx1, idx2 = index1[:, :n_samples], index2[:, :n_samples]
        indices1.append(idx1)
        indices2.append(idx2)
        xyzs1.append(gather_points(pc1, idx1))
        xyzs2.append(gather_points(pc2, idx2))
    return xyzs1, xyzs2, indices1, indices2
