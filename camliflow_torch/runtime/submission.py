"""KITTI scene-flow submission writer: the port's copy of
camliflow_tpu/runtime/submission.py (the reference's kitti_submission.py).

For each test frame it writes, under <out_root>/testing:
  disp_0/%06d_10.png          the input disparity, copied
  flow_initial/%06d_10.png    the predicted optical flow, clipped to +-500 px
                              and cropped to the input image
  disp_1_initial/%06d_10.png  frame 2's disparity: the sparse 3D flow
                              interpolated (k = 3, inverse distance) onto
                              every pixel's lifted point, invalid ones
                              included, then 0.54 f / z of the moved point,
                              -1 where the input disparity is invalid
  occ/%06d_10.png             8-bit 0/255: pixels the flow moves out of frame

Batches go through `Evaluator.batches`, one batch ahead, so the host's file
work on batch i overlaps the card's forward of batch i + 1. The
densification runs `ops.interp.knn_interpolation` (kernel #3 on a CUDA
device) on a stream of its own, so it does not queue behind that forward.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
from torch import nn

from ..data import io
from ..data.datasets import KITTITest, batches
from ..ops.interp import knn_interpolation
from .evaluator import Evaluator

logger = logging.getLogger("camliflow_torch")


CPU_QUERY_CHUNK = 4096  # 4096 x 8192 dense distances and their sort: about 1 GiB


def over_query_chunks(fn, query: torch.Tensor, chunk: int) -> torch.Tensor:
    """fn over [B, <= chunk, 3] slices of [B, N, 3] queries, concatenated
    along N. Queries are independent, so this bounds the plain versions'
    dense [B, chunk, M] distances and changes no result."""
    return torch.cat([fn(query[:, i:i + chunk]) for i in range(0, query.shape[1], chunk)],
                     dim=1)


def densify(pc1: np.ndarray, flow_3d: np.ndarray, queries: np.ndarray,
            device: torch.device) -> np.ndarray:
    """[N, 3] points and their [N, 3] flow, [M, 3] query points -> [M, 3]
    flow at the queries (k = 3 inverse-distance interpolation) on
    `device`: one launch of kernel #3 on a card, the plain version over
    chunks of CPU_QUERY_CHUNK queries on the CPU."""
    def upload(array):
        return torch.from_numpy(np.ascontiguousarray(array, np.float32))[None].to(device)

    support, feats, query = upload(pc1), upload(flow_3d), upload(queries)
    with torch.inference_mode():
        if device.type == "cpu":
            out = over_query_chunks(lambda q: knn_interpolation(support, feats, q, 3),
                                    query, CPU_QUERY_CHUNK)
        else:
            out = knn_interpolation(support, feats, query, 3)
    return out[0].cpu().numpy()


class SubmissionWriter:
    """Write a KITTI submission for `cfgs.testset` (KITTITest) with `model`
    on `device`, in batches of `cfgs.model.batch_size` (default 8).

    `frame_ms` holds each frame's host time for the densification (its
    uploads, the kernel and the copy back) and for the file work (reading
    the input disparity, lifting it, writing the four PNGs)."""

    def __init__(self, cfgs, model: nn.Module, device: torch.device | str):
        self.cfgs = cfgs
        self.dataset = KITTITest(cfgs.testset)
        self.batch_size = int(cfgs.model.get("batch_size", 8))
        self.evaluator = Evaluator(model, device)
        self.device = self.evaluator.device
        self.frame_ms: dict[str, list[float]] = {"densify": [], "files": []}

    def run(self, out_root: str = "submission") -> None:
        split = self.cfgs.testset.split
        out_dir = os.path.join(out_root, "training" if "training" in split else "testing")
        for sub in ("disp_0", "flow_initial", "disp_1_initial", "occ"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        provider = self.cfgs.testset.disp_provider
        disp_sub = "disp_occ_0" if provider == "kitti" else f"disp_{provider}"
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def path(sub, test_id):
            return os.path.join(out_dir, sub, "%06d_10.png" % test_id)

        loader = batches(self.dataset, self.batch_size)
        for batch, outputs in self.evaluator.batches(loader):
            for b in range(len(batch["index"])):
                start = time.perf_counter()
                test_id = int(batch["index"][b])
                input_h = int(batch["input_h"][b])
                input_w = int(batch["input_w"][b])
                f, cx, cy = (float(v) for v in batch["intrinsics"][b])

                disp1 = io.load_disp_png(os.path.join(
                    self.dataset.root_dir, disp_sub, "%06d_10.png" % test_id))[0]
                io.save_disp_png(path("disp_0", test_id), disp1)
                flow_2d = np.clip(outputs["flow_2d"][b], -500, 500)[:input_h, :input_w]
                io.save_flow_png(path("flow_initial", test_id), flow_2d)
                pc1_dense = io.disp2pc(disp1, baseline=0.54, f=f, cx=cx, cy=cy)
                pc1_dense_flat = pc1_dense.reshape(-1, 3).astype(np.float32)

                lifted = time.perf_counter()
                with torch.cuda.stream(side):  # no-op on the CPU (side is None)
                    flow_3d_dense = densify(batch["pcs"][b][:, :3], outputs["flow_3d"][b],
                                            pc1_dense_flat, self.device)
                densified = time.perf_counter()

                warp_z = (pc1_dense_flat + flow_3d_dense)[:, 2].reshape(input_h, input_w)
                disp_c = 0.54 * f / warp_z
                disp_c[disp1 < 0] = -1.0
                io.save_disp_png(path("disp_1_initial", test_id), disp_c)

                # the coarse occlusion mask: pixels moved out of frame
                xs = np.tile(np.arange(input_w, dtype=np.float32), (input_h, 1))
                ys = np.tile(np.arange(input_h, dtype=np.float32)[:, None], (1, input_w))
                warp_x = xs + flow_2d[..., 0]
                warp_y = ys + flow_2d[..., 1]
                occ = np.logical_or(
                    np.logical_or(warp_x < 0, warp_x > input_w),
                    np.logical_or(warp_y < 0, warp_y > input_h),
                ).astype(np.uint8) * 255
                io.save_grey_png(path("occ", test_id), occ)
                done = time.perf_counter()
                self.frame_ms["densify"].append(1e3 * (densified - lifted))
                self.frame_ms["files"].append(1e3 * (done - densified + lifted - start))
            logger.info("wrote frames up to %d", test_id)
