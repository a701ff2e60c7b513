"""Rigid-background refinement of a KITTI submission: the port's counterpart
of the repo's refine_background.py.

    python -m camliflow_torch.refine_background [--dataset_dir DIR] \\
        [--dataset_split testing] [--semantic_dir semantic_ddr] [--n_frames 200] \\
        [--workers N]

Reads what `camliflow_torch.kitti_submission` wrote under
submission/<split>/ (disp_0, disp_1_initial, flow_initial, occ) with the
KITTI calibration and semantic class maps (class ids <= 22 are static
background), replaces the background's flow and disparity by the rigid
reprojection under the estimated camera motion (`postprocess.mod_flow`),
and writes submission/<split>/{flow,disp_1}. Classical geometry on the host,
with OpenCV's solvers, as in the JAX package: no work here runs on a
device, so unlike the port's other entry points it takes no device option.

Frames are independent and each one reseeds np.random(0) before its RANSAC
loops, so `--workers N` processes (0: up to 8 cores; 1: one after another,
in order) give the same files.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os


def refine_frame(i: int, args) -> int:
    """Refine frame i; returns i."""
    import numpy as np

    from .data.io import (
        load_calib,
        load_disp_png,
        load_flow_png,
        load_grey_png,
        save_disp_png,
        save_flow_png,
    )
    from .postprocess import mod_flow

    np.random.seed(0)
    submission = f"submission/{args.dataset_split}"
    bg_mask = load_grey_png(os.path.join(args.dataset_dir, args.dataset_split,
                                         args.semantic_dir, "%06d_10.png" % i)) <= 22
    K0 = load_calib(os.path.join(args.dataset_dir, args.dataset_split,
                                 "calib_cam_to_cam", "%06d.txt" % i))[0:3, 0:3]
    disp = load_disp_png(f"{submission}/disp_0/%06d_10.png" % i)[0]
    disp_c = load_disp_png(f"{submission}/disp_1_initial/%06d_10.png" % i)[0]
    flow = load_flow_png(f"{submission}/flow_initial/%06d_10.png" % i)[0]
    occ_mask = load_grey_png(f"{submission}/occ/%06d_10.png" % i) == 0

    flow_refine, disp_c_refine = mod_flow(
        bg_mask, disp, disp_c.copy(), flow, K0, K1=K0, bl=0.54, occ_mask=occ_mask
    )
    flow_refine = np.clip(flow_refine, -500, 500)
    save_flow_png(f"{submission}/flow/%06d_10.png" % i, flow_refine)
    save_disp_png(f"{submission}/disp_1/%06d_10.png" % i, disp_c_refine)
    return i


def main(args) -> None:
    os.makedirs(f"submission/{args.dataset_split}/flow", exist_ok=True)
    os.makedirs(f"submission/{args.dataset_split}/disp_1", exist_ok=True)
    workers = args.workers or min(8, os.cpu_count() or 1)
    if workers <= 1:
        for i in range(args.n_frames):
            refine_frame(i, args)
            print(f"refined frame {i}")
        return

    from concurrent.futures import ProcessPoolExecutor, as_completed

    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=context) as pool:
        futures = [pool.submit(refine_frame, i, args) for i in range(args.n_frames)]
        for fut in as_completed(futures):
            print(f"refined frame {fut.result()}")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset_dir", default="datasets/kitti_scene_flow")
    parser.add_argument("--dataset_split", default="testing")
    parser.add_argument("--semantic_dir", default="semantic_ddr")
    parser.add_argument("--n_frames", type=int, default=200)
    parser.add_argument("--workers", type=int, default=0,
                        help="process pool size (0 = auto, up to 8; 1 = serial)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
