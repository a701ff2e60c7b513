#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py

Drives the port's three main paths at full width, CamLiRAFT-L eval (8192
points per cloud, n_samples_list 4096..256, 20 iterations, bs=1, IDS on),
the flagship CamLiRAFT eval (conf/model/camliraft.yaml: ResNet-50 cut at
stage 2, CLFM at fnet/cnet/corr/motion, 960x540 images padded to 960x544
and 8192 points, 20 iterations, bs=1, IDS on) and RAFT eval
(conf/model/raft.yaml: ResNet-50, the same images, 20 iterations as bench.py
times it, bs=1), in phases:

1. device: requires a CUDA card; prints its name and power limit;
2. build: compiles the CUDA kernels from camliflow_torch/csrc with nvcc;
3. kernels: each of the nine kernels against its plain PyTorch version on
   the card, at the shapes the main paths give it, with times for both and
   the least time the card could take (bound);
4. end to end, for each model: random weights from a seeded
   torch.Generator, synthetic inputs made with numpy from a seed (bench.py's
   recipe plus a target), through the port's Evaluator: 1 warm-up and 3
   requests, with every kernel's launch count over the 3 requests (counters
   zeroed just before them) held to what the path must launch, then a
   torch.profiler view: the top kernels, and device time and launches per
   refinement iteration and once per frame pair (requests at 20 and 10
   iterations);
5. CUDA vs CPU, for each model: the same weights and input on the CPU, where
   the plain versions run.

Prints the kernels' JSON line, then the card's name and power limit, then, as
the last line, the device JSON with "ok": true. Exits non-zero, without that
line, if any phase fails or there is no CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

N_POINTS = 8192
N_SAMPLES = (4096, 2048, 1024, 512, 256)  # the FPS pyramid levels
N_ITERS = 20
IMAGE_H, IMAGE_W = 540, 960
SEED = 0
KNN_TOL = 1e-4  # rtol = atol on selected squared distances
INTERP_TOL = 1e-5  # atol
CONV_TOL = 1e-4  # max|kernel - plain| <= CONV_TOL * (1 + max|plain|), f32 both
FLOW_3D_TOL = 5e-3  # m, max |CUDA - CPU| on flow_3d
FLOW_2D_TOL = 1e-2  # px, max |CUDA - CPU| on flow_2d
PEAK_F32 = 67e12  # H100 SXM f32 outside the tensor cores, op/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, B/s
L_CFGS = {  # conf/model/camliraft_l.yaml
    "name": "camliraft_l",
    "n_iters_eval": N_ITERS,
    "fast_inference": "auto",
    "ids": {"enabled": True},
    "n_samples_list": list(N_SAMPLES),
}
FLAGSHIP_CFGS = {  # conf/model/camliraft.yaml
    "name": "camliraft",
    "backbone": {"depth": 50},
    "n_iters_eval": N_ITERS,
    "fast_inference": "auto",
    "fuse_fnet": True,
    "fuse_cnet": True,
    "fuse_corr": True,
    "fuse_motion": True,
    "fuse_hidden": False,
    "n_samples_list": list(N_SAMPLES),
}
RAFT_CFGS = {  # conf/model/raft.yaml, at bench.py's 20 iterations
    "name": "raft",
    "backbone": {"depth": 50},
    "n_iters_eval": N_ITERS,
    "fast_inference": "auto",
}
INTRINSICS = (1050.0, 479.5, 269.5)


def clouds(rng):
    pc1 = rng.randn(1, N_POINTS, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 15.0 + 5.0
    pc2 = pc1 + 0.05 * rng.randn(1, N_POINTS, 3).astype(np.float32)
    return pc1, pc2


def frame_pair(seed: int, index: int, images: bool = False) -> dict:
    """bench.py's input recipe at bs=1 (images first when the model takes
    them), plus the synthetic targets pc2 - pc1 and a random 2D flow."""
    rng = np.random.RandomState(seed)
    batch = {"index": np.array([index]),
             "intrinsics": np.tile(np.float32(INTRINSICS), (1, 1))}
    if images:
        batch["images"] = rng.randint(0, 255, size=(1, IMAGE_H, IMAGE_W, 6)).astype(np.float32)
    pc1, pc2 = clouds(rng)
    batch["pcs"] = np.concatenate([pc1, pc2], axis=-1)
    batch["flow_3d"] = pc2 - pc1
    if images:
        flow = 3.0 * rng.randn(1, IMAGE_H, IMAGE_W, 2).astype(np.float32)
        batch["flow_2d"] = np.concatenate([flow, np.ones_like(flow[..., :1])], axis=-1)
    return batch


def random_weights(model, seed: int) -> None:
    """Fill every parameter and buffer from one seeded generator: Linear and
    Conv2d U(+-1/sqrt(fan_in)), fan_in = I*kh*kw, as torch initialises
    them; every BatchNorm (the backbone's too) perturbed from (1, 0, 0, 1)
    so that the normalisation does real work."""
    import torch
    from torch import nn

    from camliflow_torch.nn.layers import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    filled = set()
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, BatchNorm):
                module.weight.copy_(1.0 + 0.1 * torch.randn(module.weight.shape, generator=gen))
                module.bias.copy_(0.1 * torch.randn(module.bias.shape, generator=gen))
                module.running_mean.copy_(0.1 * torch.randn(module.running_mean.shape,
                                                            generator=gen))
                module.running_var.copy_(1.0 + 0.5 * torch.rand(module.running_var.shape,
                                                                generator=gen))
            elif isinstance(module, (nn.Linear, nn.Conv2d)):
                bound = module.weight[0].numel() ** -0.5
                for t in (module.weight, module.bias):
                    if t is not None:
                        t.copy_((2 * torch.rand(t.shape, generator=gen) - 1) * bound)
            else:
                continue
            filled.update(f"{name}.{key}" for key in module.state_dict())
    missing = set(model.state_dict()) - filled
    if missing:
        raise AssertionError(f"random_weights left these unfilled: {sorted(missing)[:5]}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps, with CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def profile_request(evaluator, batch, top: int = 15):
    """One request under torch.profiler: the device's busy share of the
    request's wall time and the kernels that take the most device time.
    Returns (wall ms, device busy ms, kernel launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        evaluator.forward(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - start)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    if not busy_us:
        print("  profile: the profiler saw no device time")
        return wall_us / 1e3, 0.0, launches
    print(f"  profile: request {wall_us / 1e3:.3f} ms wall, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"{launches} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x "
              f"{100 * e.self_device_time_total / busy_us:5.1f}%  {e.key[:70]}")
    return wall_us / 1e3, busy_us / 1e3, launches


def profile_split(evaluator, batch) -> None:
    """Where a request's time goes: profiled requests at N and N/2
    refinement iterations; their difference over N/2 is one iteration's
    share, the rest is the once-per-frame work."""
    core = evaluator.model.core
    full = profile_request(evaluator, batch)
    core.n_iters = N_ITERS // 2
    try:
        half = profile_request(evaluator, batch, top=0)
    finally:
        core.n_iters = N_ITERS
    # device time and launches only: the profiler's own host cost makes the
    # wall times of two profiled requests no fit for a difference
    per_iter = [(f - h) / (N_ITERS - N_ITERS // 2) for f, h in zip(full[1:], half[1:])]
    once = [f - N_ITERS * i for f, i in zip(full[1:], per_iter)]
    for label, (busy, launches) in (("per refinement iteration", per_iter),
                                    ("once per frame pair", once)):
        print(f"  {label}: {busy:.3f} ms device, {launches:.1f} launches")


def kernel_parity(device) -> list[dict]:
    """Phase 3: each kernel vs its plain version at the main-path shapes."""
    import torch
    from torch import nn

    from camliflow_torch.models.camliraft_l import FlowHead3D, GRU3D, MotionEncoder3D
    from camliflow_torch.models.raft import FlowHead2D, GRU2D, MotionEncoder2D
    from camliflow_torch.ops import corr3d, fps, interp, knn, update2d, update3d
    from camliflow_torch.ops.geometry import gather_points, squared_distance
    from camliflow_torch.ops.ids import make_parallel_camera_info, persp2paral

    # the main path's clouds: bench inputs in IDS (parallel) coordinates
    pcs = torch.as_tensor(frame_pair(SEED + 100, 0)["pcs"][0], device=device)
    persp = {"sensor_h": 540, "sensor_w": 960, "f": INTRINSICS[0],
             "cx": INTRINSICS[1], "cy": INTRINSICS[2]}
    paral = make_parallel_camera_info(540, 960)
    both = persp2paral(torch.stack([pcs[:, :3], pcs[:, 3:]]), persp, paral)
    both = both.contiguous()  # [2, 8192, 3]
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = []

    def record(name, source, replaces, err, ms, plain_ms, ops, nbytes):
        bound_ms, bound_by = bound(ops, nbytes)
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
        print(f"  {name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})", flush=True)

    # FPS [2, 8192] -> 4096: indices identical. Each step updates every
    # point's distance (8 flops), its running min and the argmax compare.
    n_fps = N_SAMPLES[0]
    got = fps.furthest_point_sampling(both, n_fps)
    ref = fps.furthest_point_sampling_plain(both, n_fps)
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    if mismatches:
        raise AssertionError(f"FPS: {mismatches} indices differ from the plain version")
    record("furthest_point_sampling", "camliflow_torch/csrc/fps.cu",
           "camliflow_tpu/ops/pallas_fps.py:109", 0.0,
           time_ms(lambda: fps.furthest_point_sampling(both, n_fps), 5),
           time_ms(lambda: fps.furthest_point_sampling_plain(both, n_fps), 2),
           2 * n_fps * N_POINTS * 10, 4 * (2 * N_POINTS * 3 + 2 * n_fps))

    # KNN: each call the main paths make; selected distances must agree
    lv = [gather_points(both, got[:, :m]) for m in N_SAMPLES]
    calls = [
        (both, lv[0], 16), (lv[0], lv[1], 16),  # encoder, both frames
        (lv[1][1:], lv[2][1:], 3), (lv[2][1:], lv[3][1:], 3),  # pooling
        (lv[3][1:], lv[4][1:], 3),
        (lv[1][:1], lv[1][:1], 32),  # update neighbours
        (lv[1][:1], both[:1], 3),  # 2048 -> 8192 upsample
    ]
    knn_err = 0.0
    for support, query, k in calls:
        d = squared_distance(query, support)
        a = knn.k_nearest_neighbor(support, query, k).long()
        b = knn.k_nearest_neighbor_plain(support, query, k).long()
        da, db = torch.gather(d, 2, a), torch.gather(d, 2, b)
        if not torch.allclose(da, db, rtol=KNN_TOL, atol=KNN_TOL):
            raise AssertionError(f"KNN k={k} {tuple(query.shape)}<-"
                                 f"{tuple(support.shape)}: selected distances differ")
        knn_err = max(knn_err, float((da - db).abs().max()))
    # the CLFM cache: the 1/8 pixel grid (68 x 120) against both frames'
    # projected points in 2-D, k=1
    feat_h, feat_w = -(-IMAGE_H // 8), -(-IMAGE_W // 8)
    uv = torch.rand(2, N_SAMPLES[1], 2, generator=gen, device=device)
    uv = (uv * torch.tensor([feat_w - 1.0, feat_h - 1.0], device=device)).contiguous()
    ys, xs = torch.meshgrid(torch.arange(float(feat_h), device=device),
                            torch.arange(float(feat_w), device=device), indexing="ij")
    pixels = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(2, -1, -1).contiguous()
    d = squared_distance(pixels, uv)
    a = knn.k_nearest_neighbor(uv, pixels, 1).long()
    b = knn.k_nearest_neighbor_plain(uv, pixels, 1).long()
    if not torch.equal(torch.gather(d, 2, a), torch.gather(d, 2, b)):
        raise AssertionError("KNN 2-D k=1: selected distances differ")
    record("k_nearest_neighbor", "camliflow_torch/csrc/knn.cu",
           "camliflow_tpu/ops/pallas_knn.py:67", knn_err,
           time_ms(lambda: knn.k_nearest_neighbor(both, lv[0], 16), 20),
           time_ms(lambda: knn.k_nearest_neighbor_plain(both, lv[0], 16), 3),
           2 * N_SAMPLES[0] * N_POINTS * 9,  # 8 flops + 1 compare per pair
           4 * (2 * N_POINTS * 3 + 2 * N_SAMPLES[0] * 3 + 2 * N_SAMPLES[0] * 16))

    # interpolation: backwarp [1,2048] <- [1,2048] and upsample [1,8192]
    xyz1, xyz2 = lv[1][:1], lv[1][1:]
    flow = 0.05 * torch.randn(xyz1.shape, generator=gen, device=device)
    warped = (xyz1 + flow).contiguous()
    neg = (-flow).contiguous()
    pc1 = both[:1]
    interp_err = 0.0
    for support, feats, query in ((warped, neg, xyz2), (xyz1, flow, pc1)):
        a = interp.knn_interpolation(support, feats, query, 3)
        b = interp.knn_interpolation_plain(support, feats, query, 3)
        err = float((a - b).abs().max())
        if err > INTERP_TOL:
            raise AssertionError(f"interp {tuple(query.shape)}: max |d| {err}")
        interp_err = max(interp_err, err)
    m = N_SAMPLES[1]
    record("knn_interpolation", "camliflow_torch/csrc/interp.cu",
           "camliflow_tpu/ops/pallas_interp.py:81", interp_err,
           time_ms(lambda: interp.knn_interpolation(warped, neg, xyz2, 3), 50),
           time_ms(lambda: interp.knn_interpolation_plain(warped, neg, xyz2, 3), 20),
           m * m * 9 + m * 3 * (12 + 2 * 3), 4 * (m * 3 * 2 + m * 3 * 2))

    # Correlation3D selection + cost: levels 2048..256, k=16
    sizes = N_SAMPLES[1:]
    xyz2_warp = (lv[1][1:] + 0.05 * torch.randn(
        xyz1.shape, generator=gen, device=device)).contiguous()
    pyramid = torch.randn(1, sizes[0], sum(sizes), generator=gen, device=device)
    idx, cost = corr3d.correlation3d_knn(xyz1, xyz2_warp, pyramid, sizes, 16)
    idx_p, _ = corr3d.correlation3d_knn_plain(xyz1, xyz2_warp, pyramid, sizes, 16)
    d = squared_distance(xyz1, xyz2_warp)
    da, db = torch.gather(d, 2, idx.long()), torch.gather(d, 2, idx_p.long())
    if not torch.allclose(da, db, rtol=KNN_TOL, atol=KNN_TOL):
        raise AssertionError("corr3d: selected distances differ")
    columns = idx.long() + corr3d.level_offsets(sizes, 16, device)
    if not torch.equal(cost, torch.gather(pyramid, 2, columns)):
        raise AssertionError("corr3d: cost is not the pyramid at its own indices")
    n_sel = m * len(sizes) * 16
    record("correlation3d_knn", "camliflow_torch/csrc/corr3d.cu",
           "camliflow_tpu/ops/pallas_corr3d.py:440", float((da - db).abs().max()),
           time_ms(lambda: corr3d.correlation3d_knn(xyz1, xyz2_warp, pyramid, sizes, 16), 50),
           time_ms(lambda: corr3d.correlation3d_knn_plain(
               xyz1, xyz2_warp, pyramid, sizes, 16), 20),
           m * m * 9,  # one scan of the level-0 candidates serves every level
           # the points, the selected pyramid entries, indices and costs out
           4 * (2 * m * 3 + 3 * n_sel))

    # the 2D update chain at the flagship's 1/8 map
    blocks = nn.ModuleList([MotionEncoder2D(), GRU2D(), FlowHead2D()])
    random_weights(blocks, SEED + 7)
    encoder, gru, head = blocks.to(device)
    shape = (1, feat_h, feat_w)
    pixels = feat_h * feat_w

    def rand(channels, scale=1.0):
        return scale * torch.randn(*shape, channels, generator=gen, device=device)

    def size(conv):  # weights and bias as the function reads them, unpadded
        return conv.kh * conv.kw * conv.cin * conv.cout + conv.cout

    def check(name, got, ref):
        err = float((got - ref).abs().max())
        limit = CONV_TOL * (1.0 + float(ref.abs().max()))
        if not err <= limit:
            raise AssertionError(f"{name}: max |d| {err} > {limit}")
        return err

    with torch.inference_mode():
        flow2d, corr = rand(2, 2.0), rand(324)
        me = update2d.prepare_motion_encoder_params(encoder)
        err = check("motion_encoder_2d", update2d.motion_encoder_2d(flow2d, corr, me),
                    update2d.motion_encoder_2d_plain(flow2d, corr, me))
        weights = sum(size(p) for k, p in me.items() if k != "conv_f1")
        macs = 324 * 256 + 9 * 256 * 192 + 9 * 128 * 64 + 9 * 256 * 126
        record("motion_encoder_2d", "camliflow_torch/csrc/update2d.cu",
               "camliflow_tpu/ops/pallas_update2d.py:461", err,
               time_ms(lambda: update2d.motion_encoder_2d(flow2d, corr, me), 20),
               time_ms(lambda: update2d.motion_encoder_2d_plain(flow2d, corr, me), 20),
               2 * pixels * macs, 4 * (pixels * (2 + 128 + 324 + 128) + weights))

        h, x2d, motion = torch.tanh(rand(128)), torch.relu(rand(128)), rand(128)
        gf = update2d.prepare_gru_flowhead_params(gru, head)
        h_k, d_k = update2d.gru_flowhead_2d(h, x2d, motion, gf)
        h_p, d_p = update2d.gru_flowhead_2d_plain(h, x2d, motion, gf)
        err = max(check("gru_flowhead_2d h'", h_k, h_p), check("gru_flowhead_2d delta", d_k, d_p))
        weights = sum(size(p) for p in gf.values())
        macs = 2 * 5 * 384 * (256 + 128) + 9 * 128 * 256 + 9 * 256 * 2
        record("gru_flowhead_2d", "camliflow_torch/csrc/update2d.cu",
               "camliflow_tpu/ops/pallas_update2d.py:235", err,
               time_ms(lambda: update2d.gru_flowhead_2d(h, x2d, motion, gf), 20),
               time_ms(lambda: update2d.gru_flowhead_2d_plain(h, x2d, motion, gf), 20),
               2 * pixels * macs, 4 * (pixels * (3 * 128 + 128 + 2) + weights))

        # the whole RAFT iteration, one cooperative launch: #9 then #8
        h_k, d_k = update2d.update_2d(h, x2d, flow2d, corr, me, gf)
        h_p, d_p = update2d.update_2d_plain(h, x2d, flow2d, corr, me, gf)
        err = max(check("update_2d h'", h_k, h_p), check("update_2d delta", d_k, d_p))
        weights = sum(size(p) for k, p in me.items() if k != "conv_f1")
        weights += sum(size(p) for p in gf.values())
        macs = (324 * 256 + 9 * 256 * 192 + 9 * 128 * 64 + 9 * 256 * 126
                + 2 * 5 * 384 * (256 + 128) + 9 * 128 * 256 + 9 * 256 * 2)
        record("update_2d", "camliflow_torch/csrc/update2d.cu",
               "camliflow_tpu/ops/pallas_update2d.py:514", err,
               time_ms(lambda: update2d.update_2d(h, x2d, flow2d, corr, me, gf), 20),
               time_ms(lambda: update2d.update_2d_plain(h, x2d, flow2d, corr, me, gf), 20),
               2 * pixels * macs, 4 * (pixels * (2 * 128 + 2 + 324 + 128 + 2) + weights))

    # the 3D update chain at the loop's 2048 points, k=32 neighbours
    blocks = nn.ModuleList([MotionEncoder3D(), GRU3D(), FlowHead3D()])
    random_weights(blocks, SEED + 8)
    encoder, gru, head = blocks.to(device)
    n = N_SAMPLES[1]
    with torch.inference_mode():
        idx = knn.k_nearest_neighbor(xyz1, xyz1, 32)
        dw_me = encoder.precompute_weights(xyz1, idx)
        dw_gf = {**gru.precompute_weights(xyz1, idx), **head.precompute_weights(xyz1, idx)}

        def rand3(channels, scale=1.0):
            return scale * torch.randn(1, n, channels, generator=gen, device=device)

        def linear_macs(params):
            return sum(p.cin * p.cout for p in params.values())

        def dw_floats(dw):
            return sum(w[0, 0].numel() for w in dw.values())

        flow3d, corr3 = rand3(3, 0.05), rand3(128)
        me3 = update3d.prepare_motion_encoder_3d_params(encoder)
        motion3 = update3d.motion_encoder_3d(flow3d, corr3, idx, dw_me, me3)
        err = check("motion_encoder_3d", motion3,
                    update3d.motion_encoder_3d_plain(flow3d, corr3, idx, dw_me, me3))
        weights = sum(size(p) for p in me3.values())
        record("motion_encoder_3d", "camliflow_torch/csrc/update3d.cu",
               "camliflow_tpu/ops/pallas_update3d.py:248", err,
               time_ms(lambda: update3d.motion_encoder_3d(flow3d, corr3, idx, dw_me, me3), 50),
               time_ms(lambda: update3d.motion_encoder_3d_plain(flow3d, corr3, idx, dw_me, me3),
                       20),
               # the MLPs' multiply-adds, a multiply and a max per gathered value
               2 * n * (linear_macs(me3) + dw_floats(dw_me)),
               # points, neighbours (int32), the hoisted weights, output
               4 * (n * (3 + 128 + 32 + 128) + n * dw_floats(dw_me) + weights))

        h3, x3 = torch.tanh(rand3(128)), torch.relu(rand3(128))
        gf3 = update3d.prepare_gru_flowhead_3d_params(gru, head)
        h_k, d_k = update3d.gru_flowhead_3d(h3, x3, motion3, idx, dw_gf, gf3)
        h_p, d_p = update3d.gru_flowhead_3d_plain(h3, x3, motion3, idx, dw_gf, gf3)
        err = max(check("gru_flowhead_3d h'", h_k, h_p), check("gru_flowhead_3d delta", d_k, d_p))
        weights = sum(size(p) for p in gf3.values())
        record("gru_flowhead_3d", "camliflow_torch/csrc/update3d.cu",
               "camliflow_tpu/ops/pallas_update3d.py:372", err,
               time_ms(lambda: update3d.gru_flowhead_3d(h3, x3, motion3, idx, dw_gf, gf3), 50),
               time_ms(lambda: update3d.gru_flowhead_3d_plain(h3, x3, motion3, idx, dw_gf, gf3),
                       20),
               2 * n * (linear_macs(gf3) + dw_floats(dw_gf)),
               4 * (n * (3 * 128 + 32 + 128 + 3) + n * dw_floats(dw_gf) + weights))
    return results


def drive(name, evaluator, batches, wrappers, card) -> dict:
    """1 warm-up and 3 requests through the Evaluator; the launch counts of
    the 3 requests (counters zeroed just before them)."""
    import torch

    evaluator.run_things(batches[:1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evaluator.request_ms.clear()
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    metrics = evaluator.run_things(batches[1:])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {key: fn.launches for key, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = 1e3 * seconds / 3
    requests = ", ".join(f"{t:.3f}" for t in evaluator.request_ms)
    shown = " | ".join(f"{k} {v:.6f}" for k, v in metrics.items() if k.startswith("EPE"))
    print(f"  {name}: {shown} | {ms:.3f} ms per frame pair | {1e3 / ms:.3f} "
          f"frame-pairs/s | requests [{requests}] ms, median "
          f"{np.median(evaluator.request_ms):.3f} | peak {peak:.1f} MiB | {card}")
    print(f"  {name} launches over the 3 requests:", launches, flush=True)
    return launches


def check_output(out: dict, key: str, shape: tuple) -> np.ndarray:
    value = out[key]
    if value.shape != shape or not np.isfinite(value).all():
        raise AssertionError(f"bad {key}: shape {value.shape}, finite {np.isfinite(value).all()}")
    return value


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    try:
        from camliflow_torch.csrc import build as kbuild
        from camliflow_torch.models.camliraft import CamLiRAFT
        from camliflow_torch.models.camliraft_l import CamLiRAFTL
        from camliflow_torch.models.raft import RAFT
        from camliflow_torch.ops import corr3d, fps, interp, knn, update2d, update3d
        from camliflow_torch.runtime.evaluator import Evaluator
        from camliflow_torch.utils.torch_setup import setup_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    failures = []
    device = torch.device("cuda", 0)
    setup_torch()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60,
    ).stdout.strip().splitlines()
    print("[1/5] device:", torch.cuda.get_device_name(0), "| torch",
          torch.__version__, "| CUDA", torch.version.cuda, flush=True)
    card = smi[0] if smi else "nvidia-smi gave no output"
    print(card, flush=True)

    # 2. build
    print("[2/5] build", flush=True)
    try:
        path, seconds, log = kbuild.build()
        kbuild.library()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
        print(f"  built {path.name} in {seconds:.1f} s", flush=True)
    except Exception:  # report and stop: nothing below can run unbuilt
        traceback.print_exc()
        return 1

    # 3. per-kernel parity
    print("[3/5] kernels vs plain versions at main-path shapes (a plain version "
          "repeats its kernel's arithmetic in PyTorch ops, cuDNN convolutions for "
          "the 2D chain, and is no yardstick of speed)", flush=True)
    kernels = []
    try:
        kernels = kernel_parity(device)
    except Exception:
        traceback.print_exc()
        failures.append("kernels")

    wrappers = {"k_nearest_neighbor": knn.k_nearest_neighbor,
                "furthest_point_sampling": fps.furthest_point_sampling,
                "knn_interpolation": interp.knn_interpolation,
                "correlation3d_knn": corr3d.correlation3d_knn,
                "motion_encoder_2d": update2d.motion_encoder_2d,
                "gru_flowhead_2d": update2d.gru_flowhead_2d,
                "update_2d": update2d.update_2d,
                "motion_encoder_3d": update3d.motion_encoder_3d,
                "gru_flowhead_3d": update3d.gru_flowhead_3d}
    point_kernels = list(wrappers)[:4]
    update_3d = {"motion_encoder_3d": N_ITERS, "gru_flowhead_3d": N_ITERS}
    # per path: kernels that must launch, and those whose launches per request
    # are fixed (0: never on this path)
    paths = (
        ("CamLiRAFT-L", CamLiRAFTL, L_CFGS, False, point_kernels,
         {**update_3d, "motion_encoder_2d": 0, "gru_flowhead_2d": 0, "update_2d": 0}),
        ("CamLiRAFT", CamLiRAFT, FLAGSHIP_CFGS, True, point_kernels,
         {**update_3d, "motion_encoder_2d": N_ITERS, "gru_flowhead_2d": N_ITERS,
          "update_2d": 0}),
        ("RAFT", RAFT, RAFT_CFGS, True, [],
         {"update_2d": N_ITERS, "motion_encoder_2d": 0, "gru_flowhead_2d": 0,
          "motion_encoder_3d": 0, "gru_flowhead_3d": 0}),
    )
    total = dict.fromkeys(wrappers, 0)
    for label, cls, cfgs, images, required, per_request in paths:
        # 4. end to end
        points = "" if cls is RAFT else f"{N_POINTS} pts, "
        print(f"[4/5] {label} eval: {points}"
              f"{f'{IMAGE_W}x{IMAGE_H} images, ' if images else ''}{N_ITERS} iters, bs=1"
              f"{'' if cls is RAFT else ', IDS on'}", flush=True)
        model = cls(cfgs)
        random_weights(model, SEED)
        cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
        evaluator = Evaluator(model, device)
        batches = [frame_pair(SEED + 1 + i, i, images) for i in range(4)]
        out = None
        try:
            launches = drive(label, evaluator, batches, wrappers, card)
            for key, count in launches.items():
                total[key] += count
            missing = [k for k in required if launches[k] == 0]
            if missing:
                raise AssertionError(f"kernels never launched on the main path: {missing}")
            got = {k: launches[k] / 3 for k in per_request}
            if got != per_request:
                raise AssertionError(f"launches per request {got}, expected {per_request}")
            out = evaluator.forward(batches[0])
            if cls is not RAFT:
                check_output(out, "flow_3d", (1, N_POINTS, 3))
            if images:
                check_output(out, "flow_2d", (1, IMAGE_H, IMAGE_W, 2))
            profile_split(evaluator, batches[1])
        except Exception:
            traceback.print_exc()
            failures.append(f"{label} end to end")

        # 5. CUDA vs CPU
        print(f"[5/5] {label}: same weights and input on the CPU (plain versions)",
              flush=True)
        try:
            if out is None:
                raise RuntimeError("no CUDA output to compare")
            cpu_model = cls(cfgs)
            cpu_model.load_state_dict(cpu_state)
            start = time.perf_counter()
            ref = Evaluator(cpu_model, "cpu").forward(batches[0])
            seconds = time.perf_counter() - start
            for key, tol, unit in (("flow_3d", FLOW_3D_TOL, "m"), ("flow_2d", FLOW_2D_TOL, "px")):
                if key not in ref:
                    continue
                delta = float(np.abs(out[key] - ref[key]).max())
                print(f"  max|d{key}| {delta:.3e} {unit} (bound {tol}), |{key}| up to "
                      f"{np.abs(ref[key]).max():.3f} {unit}")
                if not delta <= tol:
                    raise AssertionError(f"CUDA vs CPU max |d{key}| {delta} > {tol}")
            print(f"  CPU forward {seconds:.1f} s", flush=True)
        except Exception:
            traceback.print_exc()
            failures.append(f"{label} cuda vs cpu")

    # each kernel's launches over the three paths' measured requests
    for entry in kernels:
        entry["launches"] = total[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
