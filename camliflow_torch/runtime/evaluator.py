"""Evaluation protocols: PyTorch counterpart of
camliflow_tpu/runtime/evaluator.py, with the same sums, masks, keys and log
lines, summed on the host in numpy.

- `run_things` (eval_things.py): per-pixel EPE2d, 1px and Fl over the
  validity mask for models that output `flow_2d`; per-point EPE3d, 5cm and
  10cm accuracy (and the non-occluded split when the batches carry
  `occ_mask_3d`) for models that output `flow_3d`; NaN-masked.
- `run_sintel` (eval_sintel.py): 2D AEPE per scene, then over all.
- `run_sf_protocol` (eval_*_sf.py): EPE3d, AccS, AccR and Outlier, summed
  per point (things_noc_sf) or averaged per sample (things_occ_sf, and the
  two KITTI protocols), over `noc_mask_3d` for things_occ_sf.

Batches come from any iterable of dicts in the readers' sample format
(`images` [B, H, W, 6], `flow_2d` [B, H, W, 2|3], `pcs` [B, N, 6],
`intrinsics` [B, 3], `flow_3d` [B, N, 3|4], `index`, ...), such as
`data.datasets.batches`. The protocols iterate `Evaluator.batches`, which
runs one batch ahead: batch i + 1's forward is on the card's stream before
batch i's outputs are handed out, so the host's metric sums, and the file
writing of `run_things(save_results=True)`, overlap the card's work.

Across ranks (`parallel/dist.py`), each rank evaluates its contiguous
slice of every batch (`data.datasets.batches` or `data.loader.DataLoader`
with `shard_index`/`num_shards`), the port's form of both the JAX
Evaluator's split over a host's devices and its split over processes. Each
protocol sums its accumulators over the ranks, over a fixed tuple of keys,
before it takes the ratios, so every rank returns the global totals (a
rank whose last slice is empty still joins the sum); only rank 0 logs
them. Sintel's per-scene lines are each rank's own. `save_results` writes
each rank's own samples.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..parallel import dist
from ..utils.torch_setup import setup_torch

logger = logging.getLogger("camliflow_torch")

_HOST_KEYS = ("index", "input_h", "input_w")


def _epe_map(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((pred - target[..., : pred.shape[-1]]) ** 2, axis=-1))


# each protocol's accumulators, summed over the ranks in float64 before the
# ratios are taken, as the JAX Evaluator sums them (a ratio of float32 sums
# rounds in the 8th digit)
_THINGS_KEYS = ("counts", "EPE2d", "1px", "Fl")
_THINGS_3D_KEYS = ("counts", "EPE3d", "5cm", "10cm")
_SF_KEYS = ("counts", "EPE3d", "AccS", "AccR", "Outlier")


def _log(*args) -> None:
    if dist.is_main():
        logger.info(*args)


@dataclass
class Pending:
    """A forward on its way: the outputs, or the host buffers they are being
    copied into, and the event recorded after the copies were enqueued
    (None where the forward ran on the CPU)."""

    outputs: dict[str, torch.Tensor]
    done: torch.cuda.Event | None


class Evaluator:
    """Run a model over batches and reduce the protocol's metrics.

    `request_ms` records each `forward`'s wall time, from the host arrays in
    to the host arrays out. Building one turns TF32 off (`setup_torch`), so
    the model's cuDNN convolutions and matrix products run in full f32, as
    the reference computes them."""

    def __init__(self, model: nn.Module, device: torch.device | str):
        setup_torch()
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.request_ms: list[float] = []

    def enqueue(self, batch: dict) -> Pending:
        """Start the forward of `batch` without waiting for the card. On a
        CUDA device the inputs go up from pinned host memory and the outputs
        come back into pinned host buffers, both without blocking the host
        (a copy to or from pageable memory would wait for the stream)."""
        arrays = {k: v for k, v in batch.items()
                  if isinstance(v, np.ndarray) and k not in _HOST_KEYS}
        cuda = self.device.type == "cuda"
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        if cuda:
            inputs = {k: v.pin_memory().to(self.device, non_blocking=True)
                      for k, v in inputs.items()}
        with torch.inference_mode():
            outputs = self.model(inputs)
        if not cuda:
            return Pending(outputs, None)

        def to_host(value):
            host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            return host.copy_(value, non_blocking=True)

        host = {key: [to_host(v) for v in value] if isinstance(value, list) else to_host(value)
                for key, value in outputs.items()}
        done = torch.cuda.Event()
        done.record()
        return Pending(host, done)

    @staticmethod
    def fetch(pending: Pending) -> dict[str, np.ndarray]:
        """Wait for an enqueued forward and return its outputs as numpy (a
        list output, a pyramid's levels, as a list of arrays)."""
        if pending.done is not None:
            pending.done.synchronize()
        return {k: [x.numpy() for x in v] if isinstance(v, list) else v.numpy()
                for k, v in pending.outputs.items()}

    def forward(self, batch: dict) -> dict[str, np.ndarray]:
        """One request, start to finish: the model's outputs as numpy."""
        start = time.perf_counter()
        outputs = self.fetch(self.enqueue(batch))
        self.request_ms.append(1e3 * (time.perf_counter() - start))
        return outputs

    def batches(self, batches):
        """(batch, the model's outputs as numpy) for each batch, one batch
        ahead: the next batch's forward is enqueued before this batch's
        outputs are fetched."""
        pending = None
        for batch in batches:
            launched = (batch, self.enqueue(batch))
            if pending is not None:
                yield pending[0], self.fetch(pending[1])
            pending = launched
        if pending is not None:
            yield pending[0], self.fetch(pending[1])

    def run_things(self, batches, save_results: bool = False,
                   save_dir: str = "prediction/things") -> dict[str, float]:
        """eval_things.py protocol. With `save_results`, each sample's
        predictions also go to `save_dir`: flow_2d/%07d.png (KITTI 16-bit
        flow, clipped to +-500 px) and flow_3d/%07d.npy, by its index."""
        m2d = defaultdict(float)
        m3d = defaultdict(float)
        m3d_noc = defaultdict(float)
        for batch, outputs in self.batches(batches):
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
                    if save_results:
                        save_flow2d(save_dir, batch["index"][b], pred)
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
                if save_results:
                    save_flow3d(save_dir, batch["index"][b], pred)

        m2d = dist.all_reduce_sums(m2d, _THINGS_KEYS)
        m3d, m3d_noc = (dist.all_reduce_sums(m, _THINGS_3D_KEYS) for m in (m3d, m3d_noc))
        results = {}
        if m2d["counts"] > 0:
            for key in ("EPE2d", "1px", "Fl"):
                results[key] = m2d[key] / m2d["counts"]
            _log("#### 2D Metrics ####")
            _log("EPE: %.3f", results["EPE2d"])
            _log("1px: %.2f%%", results["1px"] * 100)
            _log("Fl:  %.2f%%", results["Fl"] * 100)
        if m3d["counts"] > 0:
            results["EPE3d"] = m3d["EPE3d"] / m3d["counts"]
            results["5cm"] = m3d["5cm"] / m3d["counts"]
            results["10cm"] = m3d["10cm"] / m3d["counts"]
            _log("#### 3D Metrics ####")
            _log("EPE: %.3f", results["EPE3d"])
            _log("5cm: %.2f%%", results["5cm"] * 100)
            _log("10cm: %.2f%%", results["10cm"] * 100)
        if m3d_noc["counts"] > 0:
            results["EPE3d_noc"] = m3d_noc["EPE3d"] / m3d_noc["counts"]
            results["5cm_noc"] = m3d_noc["5cm"] / m3d_noc["counts"]
            results["10cm_noc"] = m3d_noc["10cm"] / m3d_noc["counts"]
            _log("#### 3D Metrics (Non-occluded) ####")
            _log("EPE: %.3f", results["EPE3d_noc"])
        return results

    def run_sintel(self, batches) -> dict[str, float]:
        """eval_sintel.py protocol: per-scene 2D AEPE, then the total."""
        per_scene = defaultdict(lambda: defaultdict(float))
        for batch, outputs in self.batches(batches):
            for b in range(len(batch["index"])):
                scene = batch["scene_name"][b]
                epe = _epe_map(outputs["flow_2d"][b], batch["flow_2d"][b][..., :2])
                mask = ~np.isnan(epe)
                per_scene[scene]["counts"] += epe[mask].size
                per_scene[scene]["EPE2d"] += epe[mask].sum()

        total_epe, total_count = 0.0, 0
        for scene, m in sorted(per_scene.items()):
            if m["counts"] == 0:
                continue
            total_epe += m["EPE2d"]
            total_count += m["counts"]
            logger.info("%s:\t%.3f", scene, m["EPE2d"] / m["counts"])
        totals = dist.all_reduce_sums({"EPE2d": total_epe, "counts": total_count},
                                      ("EPE2d", "counts"))
        result = float(totals["EPE2d"] / max(totals["counts"], 1))
        _log("Total:\t%.3f", result)
        return {"AEPE": result}

    def run_sf_protocol(self, batches, per_sample_average: bool,
                        use_noc_mask: bool) -> dict[str, float]:
        """The AccS / AccR / Outlier protocols:
        per_sample_average=False, use_noc_mask=False: things_noc_sf (HPLFlowNet);
        per_sample_average=True,  use_noc_mask=True:  things_occ_sf (FlowNet3D);
        per_sample_average=True,  use_noc_mask=False: kitti_occ_sf, kitti_noc_sf."""
        m = defaultdict(float)
        for batch, outputs in self.batches(batches):
            for b in range(len(batch["index"])):
                epe = _epe_map(outputs["flow_3d"][b], batch["flow_3d"][b][..., :3])
                rel = epe / (np.linalg.norm(batch["flow_3d"][b][..., :3], axis=-1) + 1e-4)
                if use_noc_mask:
                    mask = batch["noc_mask_3d"][b].astype(np.float32)
                    acc_s = np.logical_or((epe < 0.05) * mask, (rel < 0.05) * mask)
                    acc_r = np.logical_or((epe < 0.1) * mask, (rel < 0.1) * mask)
                    outlier = np.logical_or((epe > 0.3) * mask, (rel > 0.1) * mask)
                    denom = mask.sum()
                    if denom == 0:
                        continue
                    m["counts"] += 1
                    m["EPE3d"] += (epe * mask).sum() / denom
                    m["AccS"] += np.count_nonzero(acc_s) / denom
                    m["AccR"] += np.count_nonzero(acc_r) / denom
                    m["Outlier"] += np.count_nonzero(outlier) / denom
                    continue
                acc_s = np.logical_or(epe < 0.05, rel < 0.05)
                acc_r = np.logical_or(epe < 0.1, rel < 0.1)
                outlier = np.logical_or(epe > 0.3, rel > 0.1)
                n = epe.size if per_sample_average else 1
                m["counts"] += 1 if per_sample_average else epe.size
                m["EPE3d"] += epe.sum() / n
                m["AccS"] += np.count_nonzero(acc_s) / n
                m["AccR"] += np.count_nonzero(acc_r) / n
                m["Outlier"] += np.count_nonzero(outlier) / n

        m = dist.all_reduce_sums(m, _SF_KEYS)
        results = {key: float(m[key] / m["counts"]) for key in ("EPE3d", "AccS", "AccR", "Outlier")}
        _log("#### 3D Metrics ####")
        _log("EPE: %.3f", results["EPE3d"])
        _log("AccS: %.2f%%", results["AccS"] * 100)
        _log("AccR: %.2f%%", results["AccR"] * 100)
        _log("Outlier: %.2f%%", results["Outlier"] * 100)
        return results


def save_flow2d(save_dir: str, index, pred: np.ndarray) -> None:
    """flow_2d/%07d.png under save_dir: the flow clipped to +-500 px."""
    from ..data.io import save_flow_png

    os.makedirs(f"{save_dir}/flow_2d", exist_ok=True)
    save_flow_png(f"{save_dir}/flow_2d/%07d.png" % int(index), np.clip(pred, -500, 500))


def save_flow3d(save_dir: str, index, pred: np.ndarray) -> None:
    """flow_3d/%07d.npy under save_dir."""
    os.makedirs(f"{save_dir}/flow_3d", exist_ok=True)
    np.save(f"{save_dir}/flow_3d/%07d.npy" % int(index), pred)
