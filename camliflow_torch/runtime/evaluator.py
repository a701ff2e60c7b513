"""Evaluation: the `things` protocol.

PyTorch counterpart of camliflow_tpu/runtime/evaluator.py::run_things:
per-pixel EPE2d, 1px and Fl over the validity mask for models that output
`flow_2d`; per-point EPE3d, 5cm and 10cm accuracy (and the non-occluded
split when the batches carry `occ_mask_3d`) for models that output
`flow_3d`; NaN-masked, summed on the host in numpy. Batches come from any
iterable of dicts in the FlyingThings3D sample format (`images`
[B, H, W, 6], `flow_2d` [B, H, W, 2|3], `pcs` [B, N, 6], `intrinsics`
[B, 3], `flow_3d` [B, N, 3|4], `index`), such as `data.datasets.batches`.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict

import numpy as np
import torch
from torch import nn

from ..utils.torch_setup import setup_torch

logger = logging.getLogger("camliflow_torch")

_HOST_KEYS = ("index", "input_h", "input_w")


def _epe_map(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((pred - target[..., : pred.shape[-1]]) ** 2, axis=-1))


class Evaluator:
    """Run a model over batches and reduce the protocol's metrics.

    `request_ms` records each forward's wall time, from the host arrays in to
    the host arrays out (the copy back waits for the device). Building one
    turns TF32 off (`setup_torch`), so the model's cuDNN convolutions and
    matrix products run in full f32, as the reference computes them."""

    def __init__(self, model: nn.Module, device: torch.device | str):
        setup_torch()
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.request_ms: list[float] = []

    def forward(self, batch: dict) -> dict[str, np.ndarray]:
        start = time.perf_counter()
        inputs = {
            k: torch.as_tensor(v, device=self.device)
            for k, v in batch.items()
            if isinstance(v, np.ndarray) and k not in _HOST_KEYS
        }
        with torch.inference_mode():
            outputs = self.model(inputs)
        outputs = {k: v.cpu().numpy() for k, v in outputs.items()}
        self.request_ms.append(1e3 * (time.perf_counter() - start))
        return outputs

    def run_things(self, batches) -> dict[str, float]:
        """eval_things.py protocol."""
        m2d = defaultdict(float)
        m3d = defaultdict(float)
        m3d_noc = defaultdict(float)
        for batch in batches:
            outputs = self.forward(batch)
            for b in range(len(batch["index"])):
                if "flow_2d" in outputs:
                    pred = outputs["flow_2d"][b]
                    target = batch["flow_2d"][b]
                    if target.shape[-1] > 2:
                        mask = target[..., 2] > 0
                        target = target[..., :2]
                    else:
                        mask = np.ones(target.shape[:2], bool)
                    epe = _epe_map(pred, target)
                    mask = np.logical_and(mask, ~np.isnan(epe))
                    with np.errstate(divide="ignore", invalid="ignore"):
                        fl = np.logical_and(epe > 3.0, epe / np.linalg.norm(target, axis=-1) > 0.05)
                    m2d["counts"] += epe[mask].size
                    m2d["EPE2d"] += epe[mask].sum()
                    m2d["1px"] += np.count_nonzero(epe[mask] < 1.0)
                    m2d["Fl"] += fl[mask].sum()
                if "flow_3d" not in outputs:
                    continue
                pred = outputs["flow_3d"][b]
                target = batch["flow_3d"][b]
                if target.shape[-1] > 3:
                    mask = target[..., 3] > 0
                    target = target[..., :3]
                else:
                    mask = np.ones(target.shape[0], bool)
                epe = _epe_map(pred, target)
                mask = np.logical_and(mask, ~np.isnan(epe))
                m3d["counts"] += epe[mask].size
                m3d["EPE3d"] += epe[mask].sum()
                m3d["5cm"] += np.count_nonzero(epe[mask] < 0.05)
                m3d["10cm"] += np.count_nonzero(epe[mask] < 0.1)
                if "occ_mask_3d" in batch:
                    occ = batch["occ_mask_3d"][b]
                    noc = epe[np.logical_and(occ == 0, mask)]
                    m3d_noc["counts"] += noc.size
                    m3d_noc["EPE3d"] += noc.sum()
                    m3d_noc["5cm"] += np.count_nonzero(noc < 0.05)
                    m3d_noc["10cm"] += np.count_nonzero(noc < 0.1)

        results = {}
        if m2d["counts"] > 0:
            for key in ("EPE2d", "1px", "Fl"):
                results[key] = m2d[key] / m2d["counts"]
            logger.info("#### 2D Metrics ####")
            logger.info("EPE: %.3f", results["EPE2d"])
            logger.info("1px: %.2f%%", results["1px"] * 100)
            logger.info("Fl:  %.2f%%", results["Fl"] * 100)
        if m3d["counts"] > 0:
            results["EPE3d"] = m3d["EPE3d"] / m3d["counts"]
            results["5cm"] = m3d["5cm"] / m3d["counts"]
            results["10cm"] = m3d["10cm"] / m3d["counts"]
            logger.info("#### 3D Metrics ####")
            logger.info("EPE: %.3f", results["EPE3d"])
            logger.info("5cm: %.2f%%", results["5cm"] * 100)
            logger.info("10cm: %.2f%%", results["10cm"] * 100)
        if m3d_noc["counts"] > 0:
            results["EPE3d_noc"] = m3d_noc["EPE3d"] / m3d_noc["counts"]
            results["5cm_noc"] = m3d_noc["5cm"] / m3d_noc["counts"]
            results["10cm_noc"] = m3d_noc["10cm"] / m3d_noc["counts"]
            logger.info("#### 3D Metrics (Non-occluded) ####")
            logger.info("EPE: %.3f", results["EPE3d_noc"])
        return results
