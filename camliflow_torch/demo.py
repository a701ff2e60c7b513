"""Demo of the port: run a model on one image pair and its stereo
disparities (counterpart of the repo's demo.py).

    python -m camliflow_torch.demo --model camliraft --weights <JAX variables .npz> \\
        --image1 a.png --image2 b.png --disp1 a.pfm --disp2 b.pfm [--device cpu]

Lifts each frame's disparity (a PFM, negated) to a cloud, keeps the points
nearer than --max_depth with no NaN, draws --n_points of each with
np.random.seed(0), runs the model named by conf/model/<model>.yaml under
the working directory, and writes <out_dir>/flow_2d.png (image 1 over
image 2 over the flow's colour wheel) and <out_dir>/flow_3d.npz (pc1, pc2,
flow_3d). Without --weights the weights are random, from a seeded
torch.Generator. It runs on the CUDA card unless --device cpu is given, and
raises without a card otherwise. --fast_inference and --lookup_storage
override the model config's keys (`--fast_inference on`: the fast path).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(args) -> dict[str, np.ndarray]:
    """Run the demo; returns the model's outputs as numpy."""
    from .data.io import disp2pc, load_image_rgb, load_pfm
    from .data.png import write_png
    from .eval import resolve_device
    from .models.factory import model_factory
    from .runtime.checkpoint import load_jax_variables, load_npz, random_weights
    from .runtime.evaluator import Evaluator
    from .utils.config import load_yaml
    from .utils.visualization import viz_optical_flow

    device = resolve_device(args.device)
    image1 = load_image_rgb(args.image1)
    image2 = load_image_rgb(args.image2)
    disp1 = -load_pfm(args.disp1)
    disp2 = -load_pfm(args.disp2)

    pc1 = disp2pc(disp1, args.baseline, args.f, args.cx, args.cy)
    pc2 = disp2pc(disp2, args.baseline, args.f, args.cx, args.cy)
    pc1, pc2 = pc1[pc1[..., -1] < args.max_depth], pc2[pc2[..., -1] < args.max_depth]
    pc1 = pc1[~np.isnan(np.sum(pc1, axis=-1))]
    pc2 = pc2[~np.isnan(np.sum(pc2, axis=-1))]

    np.random.seed(0)
    idx1 = np.random.choice(pc1.shape[0], size=min(args.n_points, pc1.shape[0]), replace=False)
    idx2 = np.random.choice(pc2.shape[0], size=min(args.n_points, pc2.shape[0]), replace=False)
    pc1, pc2 = pc1[idx1], pc2[idx2]

    cfgs = load_yaml(os.path.join("conf", "model", f"{args.model}.yaml"))["model"]
    for key in ("fast_inference", "lookup_storage"):
        if getattr(args, key) is not None:
            cfgs[key] = getattr(args, key)
    model = model_factory(cfgs)(cfgs.to_dict())
    if args.weights:
        load_jax_variables(model, load_npz(args.weights), cfgs["name"])
    else:
        print("WARNING: no --weights given, using random init")
        random_weights(model, seed=0)

    inputs = {
        "images": np.concatenate([image1, image2], axis=-1).astype(np.float32)[None],
        "pcs": np.concatenate([pc1, pc2], axis=1).astype(np.float32)[None],
        "intrinsics": np.float32([args.f, args.cx, args.cy])[None],
    }
    outputs = Evaluator(model, device).forward(inputs)
    os.makedirs(args.out_dir, exist_ok=True)

    if "flow_2d" in outputs:
        flow_2d = outputs["flow_2d"][0]
        stack = np.concatenate([image1, image2, viz_optical_flow(flow_2d)], axis=0)
        write_png(os.path.join(args.out_dir, "flow_2d.png"), stack)
        print(f"wrote {args.out_dir}/flow_2d.png  "
              f"(|flow| max {np.abs(flow_2d).max():.1f} px)")
    if "flow_3d" in outputs:
        flow_3d = outputs["flow_3d"][0]
        np.savez(os.path.join(args.out_dir, "flow_3d.npz"), pc1=pc1, pc2=pc2, flow_3d=flow_3d)
        print(f"wrote {args.out_dir}/flow_3d.npz  "
              f"(|flow| max {np.abs(flow_3d).max():.2f} m)")
        if args.show:
            show_clouds(pc1, pc2, flow_3d)
    return outputs


def show_clouds(pc1, pc2, flow_3d) -> None:
    """Interactive scene-flow view: pc1 red, pc2 green, pc1 + flow blue.
    Needs open3d; without it, says so (flow_3d.npz holds the same data)."""
    try:
        import open3d
    except ImportError:
        print("open3d not installed: skipping interactive view "
              "(flow_3d.npz holds pc1/pc2/flow_3d for offline viewing)")
        return
    clouds = []
    for pts, color in ((pc1, [1, 0, 0]), (pc2, [0, 1, 0]), (pc1 + flow_3d, [0, 0, 1])):
        cloud = open3d.geometry.PointCloud()
        cloud.points = open3d.utility.Vector3dVector(pts.astype(np.float64))
        cloud.colors = open3d.utility.Vector3dVector(np.zeros_like(pts, np.float64) + color)
        clouds.append(cloud)
    open3d.visualization.draw_geometries(clouds)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="camliraft")
    parser.add_argument("--weights", default=None, help="JAX variables .npz")
    parser.add_argument("--image1", default="asserts/demo_image1.png")
    parser.add_argument("--image2", default="asserts/demo_image2.png")
    parser.add_argument("--disp1", default="asserts/demo_disp1.pfm")
    parser.add_argument("--disp2", default="asserts/demo_disp2.pfm")
    parser.add_argument("--out_dir", default="outputs/demo")
    parser.add_argument("--n_points", type=int, default=8192)
    parser.add_argument("--max_depth", type=float, default=35.0)
    parser.add_argument("--baseline", type=float, default=1.0)
    parser.add_argument("--f", type=float, default=1050.0)
    parser.add_argument("--cx", type=float, default=479.5)
    parser.add_argument("--cy", type=float, default=269.5)
    parser.add_argument("--show", action="store_true", help="interactive open3d view")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--fast_inference", default=None, help="auto|on|off (default: the "
                        "model config's)")
    parser.add_argument("--lookup_storage", default=None, help="auto|split|bf16|int8 (default: "
                        "the model config's)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
