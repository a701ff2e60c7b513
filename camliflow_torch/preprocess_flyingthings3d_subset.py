"""Preprocess the raw FlyingThings3D subset into the `-prep` layout the
training and eval readers take (the port's counterpart of the JAX package's
preprocess_flyingthings3d_subset.py, same arguments, same output):

    python -m camliflow_torch.preprocess_flyingthings3d_subset --input_dir <raw> \\
        [--output_dir datasets/flyingthings3d_subset_prep] [--n_points 32768 8192] \\
        [--max_depth 35] [--remove_occluded_points] [--n_workers 8]

For each frame pair of each split (train, val) it lifts the disparity, the
disparity change and the .flo optical flow into point clouds (f 1050,
cx 479.5, cy 269.5, baseline 1), in one of two modes:
- default: keep occluded points (the FlowNet3D protocol); pc2 is frame 2's
  own disparity lifted, the 3D flow is frame 1's points moved by the flow
  and the disparity change;
- `--remove_occluded_points`: drop the pixels the occlusion map marks (the
  HPLFlowNet protocol); pc2 is frame 1's points moved.
Points at max_depth or deeper and NaN points are dropped, then each cloud
is sampled down to n_points (train, val). Written: pc/<i>.npz (pc1, pc2),
flow_3d/<i>.npy, occ_mask_3d/<i>.npy (packed bits), flow_2d/<i>.png (16-bit
KITTI flow, |flow| >= 500 px invalid), and copies of the left images and
occlusion maps.

Raw layout: <input_dir>/{train,val}/{disparity/left, disparity_change/left/
into_future, flow/left/into_future, flow_occlusions/left/into_future,
image_clean/left}.

Each frame draws its samples from its own `np.random.RandomState(0)`, so
the output does not depend on `--n_workers`; it equals the JAX script's
run with `--n_workers 1` (that script seeds the process-wide generator in
each frame and samples from it in a thread pool). PNGs go through the
port's codec: an occlusion map is read as OpenCV's default colour read
gives its first channel (grey, the blue of a colour image, a 16-bit
sample's high byte).
"""

from __future__ import annotations

import argparse
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .data.io import disp2pc, load_flow, load_image_rgb, load_pfm, save_flow_png

BASELINE, F, CX, CY = 1.0, 1050.0, 479.5, 269.5


def occlusion_mask(path: str) -> np.ndarray:
    """[H, W] bool: the map's value (OpenCV's BGR read, channel 0) above 1."""
    return load_image_rgb(path)[..., 2] > 1


def lift(disp1, disp2, disp1_change, flow_2d, occ_mask_2d, max_depth: float,
         remove_occluded_points: bool):
    """(pc1, pc2, flow_3d, occ_mask_3d) before sampling, as the mode says."""
    if remove_occluded_points:
        pc1 = disp2pc(disp1, BASELINE, F, CX, CY)
        pc2 = disp2pc(disp1 + disp1_change, BASELINE, F, CX, CY, flow_2d)
        noc = np.logical_not(occ_mask_2d)
        pc1, pc2 = pc1[noc], pc2[noc]
        mask = np.logical_and(pc1[..., -1] < max_depth, pc2[..., -1] < max_depth)
        pc1, pc2 = pc1[mask], pc2[mask]
        mask = ~np.isnan(np.sum(pc1, -1) + np.sum(pc2, -1))
        pc1, pc2 = pc1[mask], pc2[mask]
        return pc1, pc2, pc2 - pc1, np.zeros(len(pc1), dtype=bool)
    pc1 = disp2pc(disp1, BASELINE, F, CX, CY)
    pc2 = disp2pc(disp2, BASELINE, F, CX, CY)
    flow_3d = disp2pc(disp1 + disp1_change, BASELINE, F, CX, CY, flow_2d) - pc1
    mask1 = pc1[..., -1] < max_depth
    mask2 = pc2[..., -1] < max_depth
    pc1, pc2 = pc1[mask1], pc2[mask2]
    flow_3d, occ_mask_3d = flow_3d[mask1], occ_mask_2d[mask1]
    mask1 = ~np.isnan(np.sum(pc1, -1) + np.sum(flow_3d, -1))
    mask2 = ~np.isnan(np.sum(pc2, -1))
    return pc1[mask1], pc2[mask2], flow_3d[mask1], occ_mask_3d[mask1]


def process_one(input_dir: str, output_dir: str, split: str, index1: int, n_points: int,
                max_depth: float, remove_occluded_points: bool) -> None:
    """Frame pair (index1, index1 + 1) of `split` into the `-prep` files."""
    rng = np.random.RandomState(0)
    raw = lambda *parts: os.path.join(input_dir, split, *parts)  # noqa: E731
    out = lambda sub, name: os.path.join(output_dir, split, sub, name)  # noqa: E731
    name = "%07d" % index1
    disp1 = -load_pfm(raw("disparity", "left", name + ".pfm"))
    disp2 = -load_pfm(raw("disparity", "left", "%07d.pfm" % (index1 + 1)))
    disp1_change = -load_pfm(raw("disparity_change", "left", "into_future", name + ".pfm"))
    flow_2d = load_flow(raw("flow", "left", "into_future", name + ".flo"))
    occ_mask_2d = occlusion_mask(raw("flow_occlusions", "left", "into_future", name + ".png"))

    pc1, pc2, flow_3d, occ_mask_3d = lift(disp1, disp2, disp1_change, flow_2d, occ_mask_2d,
                                          max_depth, remove_occluded_points)
    idx1 = rng.choice(pc1.shape[0], size=min(n_points, pc1.shape[0]), replace=False)
    idx2 = rng.choice(pc2.shape[0], size=min(n_points, pc2.shape[0]), replace=False)
    pc1, pc2 = pc1[idx1], pc2[idx2]
    flow_3d, occ_mask_3d = flow_3d[idx1], occ_mask_3d[idx1]

    np.savez(out("pc", name + ".npz"), pc1=pc1, pc2=pc2)
    np.save(out("occ_mask_3d", name + ".npy"), np.packbits(occ_mask_3d))
    flow_mask = np.logical_and(np.abs(flow_2d[..., 0]) < 500, np.abs(flow_2d[..., 1]) < 500)
    flow_2d = flow_2d.copy()
    flow_2d[np.logical_not(flow_mask)] = 0.0
    save_flow_png(out("flow_2d", name + ".png"), flow_2d, flow_mask)
    np.save(out("flow_3d", name + ".npy"), flow_3d)


def main(args) -> None:
    for split, n_points in zip(("train", "val"), args.n_points):
        if not os.path.exists(os.path.join(args.input_dir, split)):
            continue
        print(f'Processing "{split}" split...')
        for sub in ("pc", "flow_2d", "flow_3d", "occ_mask_3d"):
            os.makedirs(os.path.join(args.output_dir, split, sub), exist_ok=True)
        for src, dst in ((("image_clean", "left"), "image_clean"),
                         (("flow_occlusions", "left", "into_future"), "occ_mask_2d")):
            if not os.path.exists(os.path.join(args.output_dir, split, dst)):
                print(f"Copying {dst}...")
                shutil.copytree(src=os.path.join(args.input_dir, split, *src),
                                dst=os.path.join(args.output_dir, split, dst))
        indices = sorted(int(fn.split(".")[0]) for fn in os.listdir(
            os.path.join(args.input_dir, split, "flow", "left", "into_future")))
        print(f"Generating point clouds for {len(indices)} frames...")
        with ThreadPoolExecutor(args.n_workers) as pool:
            list(pool.map(lambda idx: process_one(
                args.input_dir, args.output_dir, split, idx, n_points, args.max_depth,
                args.remove_occluded_points), indices))
    print("All done.")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--output_dir", default="datasets/flyingthings3d_subset_prep")
    parser.add_argument("--n_points", nargs=2, type=int, default=[32768, 8192])
    parser.add_argument("--max_depth", type=float, default=35.0)
    parser.add_argument("--remove_occluded_points", action="store_true")
    parser.add_argument("--n_workers", type=int, default=8)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
