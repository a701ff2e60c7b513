"""Flow metrics as (sum, count) pairs: the port's copy of
camliflow_tpu/models/metrics.py. A trainer sums the pairs over steps on the
host and `finalize_metrics` takes the ratios in float64, as the JAX one
does (a ratio of float32 sums rounds in the 8th digit)."""

from __future__ import annotations

import torch

MetricDict = dict[str, tuple[torch.Tensor, torch.Tensor]]


def _masked_sum_count(values: torch.Tensor, mask: torch.Tensor):
    mask = mask.float()
    return torch.sum(values.float() * mask), torch.sum(mask)


def scalar_metric(value: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    value = torch.as_tensor(value, dtype=torch.float32)
    return value, torch.ones((), dtype=torch.float32, device=value.device)


def compute_2d_metrics(pred: torch.Tensor, target: torch.Tensor) -> MetricDict:
    """EPE2D, 1px accuracy and the KITTI outlier rate. pred [B, H, W, 2];
    target [B, H, W, 2 or 3] (channel 2: validity)."""
    target = target.float()
    if target.shape[-1] == 3:
        mask = target[..., 2] > 0
        target = target[..., :2]
    else:
        mask = torch.ones(target.shape[:-1], dtype=torch.bool, device=target.device)
    epe = torch.linalg.vector_norm(pred.float() - target, dim=-1)
    mag = torch.linalg.vector_norm(target, dim=-1) + 1e-5
    outlier = (epe > 3.0) & (epe / mag > 0.05)
    return {
        "epe2d": _masked_sum_count(epe, mask),
        "acc2d_1px": _masked_sum_count(epe < 1.0, mask),
        "outlier2d": _masked_sum_count(outlier, mask),
    }


def compute_3d_metrics(pred: torch.Tensor, target: torch.Tensor,
                       occ_mask: torch.Tensor | None = None) -> MetricDict:
    """EPE3D and 5cm accuracy, or their non-occluded split with `occ_mask`
    [B, N] (1: occluded). pred [B, N, 3]; target [B, N, 3 or 4]."""
    target = target.float()
    if target.shape[-1] == 4:
        mask = target[..., 3] > 0
        target = target[..., :3]
    else:
        mask = torch.ones(target.shape[:-1], dtype=torch.bool, device=target.device)
    epe = torch.linalg.vector_norm(pred.float() - target, dim=-1)
    acc = epe < 0.05
    if occ_mask is not None:
        mask = (occ_mask == 0) & mask
        return {"epe3d_noc": _masked_sum_count(epe, mask),
                "acc3d_5cm_noc": _masked_sum_count(acc, mask)}
    return {"epe3d": _masked_sum_count(epe, mask), "acc3d_5cm": _masked_sum_count(acc, mask)}


def merge_metrics(*dicts: MetricDict) -> MetricDict:
    out: MetricDict = {}
    for d in dicts:
        for key, (s, c) in d.items():
            out[key] = (out[key][0] + s, out[key][1] + c) if key in out else (s, c)
    return out


def finalize_metrics(metrics: MetricDict) -> dict[str, float]:
    """Each metric's sum over its count, in float64."""
    return {k: float(s) / max(float(c), 1e-12) for k, (s, c) in metrics.items()}
