"""Flow losses as functions of tensors: the port's copy of
camliflow_tpu/models/losses.py. Sequence losses take the stacked [T, ...]
per-iteration predictions; pyramid losses keep the per-level list (the
levels differ in shape). Everything is computed in f32.

Layout: 2D flow [B, H, W, 2(+1 validity)], 3D flow [B, N, 3(+1 validity)].

Under `global_means` (the train step with a group of more than one rank)
each masked mean divides by the mask's count over the global batch, as the
JAX package's does over its mesh: the count is all-reduced (no gradient)
and the rank's sum is scaled by the world size, so each rank's loss is its
share of the global loss times the world size. DDP averages the ranks'
gradients, which makes them the global loss's, and the mean of the ranks'
losses is the global loss.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed

from ..parallel import dist

from ..ops.geometry import gather_points
from ..ops.image import resize_flow2d


_global = [False]  # inside global_means


@contextlib.contextmanager
def global_means(enabled: bool = True):
    """Masked means over every rank's batch while inside (see above)."""
    saved = _global[0]
    _global[0] = enabled
    try:
        yield
    finally:
        _global[0] = saved


def _count(mask_sum: torch.Tensor) -> torch.Tensor:
    """A masked mean's denominator: the mask's count, at least 1; under
    `global_means` the global count over the world size."""
    if not _global[0]:
        return torch.clamp(mask_sum, min=1.0)
    total = mask_sum.detach().clone()
    torch.distributed.all_reduce(total)
    return torch.clamp(total, min=1.0) / dist.world_size()


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the elements where mask is true."""
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / _count(torch.sum(mask))


def _flow_error(diff: torch.Tensor, order: str) -> torch.Tensor:
    """Per-element error over the channel (last) axis."""
    if order == "l2-norm":
        return torch.linalg.vector_norm(diff, dim=-1)
    if order == "l1":
        return torch.sum(torch.abs(diff), dim=-1)
    if order == "robust":
        return torch.pow(torch.sum(torch.abs(diff), dim=-1) + 0.01, 0.4)
    raise ValueError(f"unknown loss order: {order}")


def _split_target(target: torch.Tensor, flow_dim: int):
    if target.shape[-1] == flow_dim + 1:
        return target[..., :flow_dim], target[..., flow_dim] > 0
    return target, torch.ones(target.shape[:-1], dtype=torch.bool, device=target.device)


def calc_sequence_loss(flow_preds: torch.Tensor, target: torch.Tensor, gamma: float,
                       order: str) -> torch.Tensor:
    """RAFT sequence loss: sum_i gamma^(T-1-i) * masked_mean(error_i).

    flow_preds [T, B, ..., C] stacked per-iteration predictions; target
    [B, ..., C(+1)] (an optional validity channel)."""
    n_preds, flow_dim = flow_preds.shape[0], flow_preds.shape[-1]
    target_flow, mask = _split_target(target.float(), flow_dim)
    per_iter = _flow_error(flow_preds.float() - target_flow[None], order)
    mask = mask.to(per_iter.dtype)
    dims = tuple(range(1, per_iter.dim()))
    per_iter = torch.sum(per_iter * mask, dim=dims) / _count(torch.sum(mask))
    weights = gamma ** torch.arange(n_preds - 1, -1, -1, dtype=torch.float32,
                                    device=per_iter.device)
    return torch.sum(weights * per_iter)


def _level_error(diff: torch.Tensor, order: str) -> torch.Tensor:
    if order == "robust":
        return torch.pow(torch.sum(torch.abs(diff), dim=-1) + 0.01, 0.4)
    if order == "l2-norm":
        return torch.linalg.vector_norm(diff, dim=-1)
    raise NotImplementedError(order)


def calc_pyramid_loss_2d(flows: list[torch.Tensor], target: torch.Tensor,
                         level_weights: list[float], order: str) -> torch.Tensor:
    """PWC pyramid loss: each level's flow [B, h_i, w_i, 2] resized to the
    target's size (its magnitudes rescaled), weighted."""
    target_flow, mask = _split_target(target.float(), 2)
    h, w = target.shape[1:3]
    total = target_flow.new_zeros(())
    for pred, weight in zip(flows, level_weights):
        diff = torch.abs(resize_flow2d(pred.float(), h, w) - target_flow)
        total = total + weight * _masked_mean(_level_error(diff, order), mask)
    return total


def calc_pyramid_loss_3d(flows: list[torch.Tensor], target: torch.Tensor,
                         level_weights: list[float], order: str,
                         indices: list[torch.Tensor]) -> torch.Tensor:
    """PointPWC pyramid loss: level i's flow [B, n_i, 3] against the target
    at that level's FPS indices [B, n_i]."""
    target = target.float()
    total = target.new_zeros(())
    for idx, flow, weight in zip(indices, flows, level_weights):
        target_flow, mask = _split_target(gather_points(target, idx), 3)
        diff = flow.float() - target_flow
        total = total + weight * _masked_mean(_level_error(diff, order), mask)
    return total
