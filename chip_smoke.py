#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one CUDA card.

    python3 chip_smoke.py [--other TREE]

Drives the port's main paths at full width, CamLiRAFT-L eval (8192
points per cloud, n_samples_list 4096..256, 20 iterations, bs=1, IDS on),
the flagship CamLiRAFT eval (conf/model/camliraft.yaml: ResNet-50 cut at
stage 2, CLFM at fnet/cnet/corr/motion, 960x540 images padded to 960x544
and 8192 points, 20 iterations, bs=1, IDS on), the same with
`fuse_hidden=true` (CLFM at the hidden state too, between the GRUs and the
flow heads), RAFT eval (conf/model/raft.yaml: ResNet-50, the same
images, 20 iterations as bench.py times it, bs=1) and the PWC family's
eval (bs=1, no refinement loop): PWC (conf/model/pwc.yaml: the same
images, resized to 960x576 inside), CamLiPWC-L (conf/model/camlipwc_l.yaml,
8192 points, IDS on) and CamLiPWC (conf/model/camlipwc.yaml: the images
and points, all three fusions), in phases:

1. device: requires a CUDA card; prints its name and power limit;
2. build: compiles the CUDA kernels from camliflow_torch/csrc with nvcc,
   and prints each kernel's registers, static shared memory and spills
   (ptxas);
3. kernels: each of the thirteen kernels against its plain PyTorch version
   on the card, at the shapes the main paths give it (and #8's two halves,
   which the fuse_hidden path launches, and the k-major gather on
   tools/probe_gather_matrix.py's cases, timed by CUDA events and by the
   profiler's device time), with times for both and the least time the
   card could take (bound; for the tensor-core kernels, the 2D chain's and
   CLFM's, beside the f32 bound outside the tensor cores); KNN bit for bit,
   ties included, at each of its 8 main-path calls and the PWC family's 15
   call shapes (the pyramid's 8192 -> 4096 .. 512 -> 256, the decoder's
   4096 .. 256, CamLiPWC's 2-D CLFM caches from 144x240 pixels against 4096
   points down to 9x15 against 256), the train paths' 10 k=3 call shapes
   at batch 2 (CamLiRAFT-L's upsample, the PWC family's level upsamples
   and backwarps: the interpolation's train form) and KITTI fine-tuning's
   six 2-D calls at batch 2 (the flagship's CLFM cache at 47x156,
   CamLiPWC's at 96x320 .. 6x20 of 384x1280), each with its
   plan, device time (profiler) and bound, and their sums a request of the
   flagship,
   CamLiRAFT-L, CamLiPWC-L and CamLiPWC; the interpolation at its three
   shapes (CamLiPWC's level upsample with 67 channels the third) by events
   and device time, its selection the plain KNN's (with --other, another
   tree's KNN, interpolation, 3D motion encoder, 3D GRU + flow head,
   PointConvDW tail and k-major gather are held to the plain versions too
   and timed beside this tree's, by device time in turns, the GRU + flow
   head held to this tree's bit for bit); the k-major gather bit for bit at
   its six main-path calls and CamLiPWC's widest (FlowEstimator3D at level
   1, [1, 4096, 198] x [1, 4096, 16]), by device, event and host time,
   beside one advanced indexing; Correlation3D's selection bit for bit, ties
   included, and its index-only form (training's) at the train shapes, a
   batch of 2, bit for bit the full form's indices and the plain
   version's, with its device time beside the full form's; CLFM's device
   time split by stage (profiler); FPS bit for bit,
   also on duplicated points, and its time a step; the 3D motion encoder
   (its flow columns bit for bit) by events, device time, by launch and
   host time a call; the 3D GRU + flow head also at the eval CLI's batch of
   8, each timed, its steps by profiler device time; the PointConvDW tail
   bit for bit at its four fuse_hidden shapes, by events, device and host
   time; the RAFT iteration (#10) bit for bit the motion encoder then the
   GRU + flow head, by events, device time by launch and host time, beside
   those two wrappers in sequence; the Correlation3D tail by events, device
   and host time, rerun bit for bit;
4. end to end, for each path: random weights from a seeded
   torch.Generator, synthetic inputs made with numpy from a seed (bench.py's
   recipe plus a target), through the port's Evaluator: 1 warm-up and 3
   requests through run_things (one batch ahead), with every kernel's
   launch count over the 3 requests (counters zeroed just before them) held
   to what the path must launch, each request again alone through forward
   for its own time, then a
   torch.profiler view: the top kernels, and device time and launches per
   refinement iteration and once per frame pair (requests at 20 and 10
   iterations; the PWC family, which has no loop, one profiled request);
   then the eval CLI's batch of 8: 8 frame pairs, each run
   alone, then together in one request, each sample's output held to the
   same sample alone within phase 5's envelope, the request's launches to a
   bs=1 request's, with its time, device busy share and peak memory;
5. CUDA vs CPU, for each path: the same weights and input on the CPU, where
   the plain versions run;
6. the Evaluator's one-batch lookahead: the flagship over 4 batches of 8
   frame pairs through run_things, one batch ahead and through a
   synchronous loop over forward, in turns; outputs and metrics bit for
   bit; wall time a batch, device busy share, the host's time to issue a
   forward and to sum a batch's metrics, and where a forward makes the
   host wait (set_sync_debug_mode);
7. the KITTI submission: 8 synthetic frames at 375x1242 (written with the
   port's PNG encoder, KITTI's P_rect_02, 3-70 m of disparity), the
   flagship at bs=8 as `python -m camliflow_torch.kitti_submission`
   configures it; the files decoded to their shapes, launches held to one
   flagship request plus a densification a frame, ms a frame split into
   forward, reading, densification and files, one frame against the CPU,
   #3 at the densify shape ([1, 465,750] <- [1, 8192]) against its plain
   version run over chunks of queries (and #1 there, bit for bit), and #9,
   #8 and #11 at KITTI's 47x156 map beside the bench's 68x120;
8. the demo: `camliflow_torch.demo` on a synthetic 960x540 pair with PFM
   disparities, on the card (launches held to one flagship request) and on
   the CPU;
9. training: the port's Trainer (`python -m camliflow_torch.train
   trainset=flyingthings3d_subset valset=flyingthings3d_subset
   model=camliraft`'s) at the flagship's full width, amp and augmentation
   on, batches of 2 on 8 synthetic 960x540 pairs written with the port's
   writers: a warm-up epoch, a timed epoch (ms a step, frame pairs/s,
   launches a step held to #1-#4's counts, #4 index-only, #5-#13 never,
   peak memory), a profiled step (device busy share), every step's loss
   and both branch gradient norms finite and > 0, a validation pass, a
   checkpoint saved and resumed; a resumed run's first loss against the
   uninterrupted run's (augmentation off); one f32 step at batch 1 and 2
   iterations on the card against the CPU (loss, every gradient, the
   parameters after the step). Then each other family (CamLiRAFT-L, RAFT,
   PWC, CamLiPWC-L, CamLiPWC) with its own training config at full width,
   batches of 2 on 4 synthetic pairs: a warm-up epoch, a timed epoch of 2
   steps (launches a step held to the counts derived from the code: #3
   only on detached flows, #5-#13 and #12 never), every loss and branch
   gradient norm finite and > 0, a profiled step, a validation pass, and
   one f32 step at 448x256, 2048 points and 2 iterations against the CPU.
   Then the KITTI fine-tunes of CamLiRAFT and CamLiPWC (`python -m
   camliflow_torch.train trainset=kitti valset=kitti model=<family>`, each
   on conf/training/kitti/<family>.yaml at full width: `freeze_bn`, no
   warm-up, amp, colour jitter, flip and scale on 376x1242 frames, 8192
   points) on 6 synthetic KITTI training frames at 375x1242 written with
   the port's writers (KITTI's P_rect_02, 3-70 m of disparity, a forward
   motion's flow), KITTI's splits cut in the process to 4 training and 2
   validation frames, batches of 2: a warm-up and a timed epoch of 2 steps
   (ms a step, frame pairs/s, the loader's share against a profiled step,
   busy share, peak memory, launches a step held to the counts derived
   from the code), every BatchNorm's running statistics bit for bit
   unchanged over both epochs, a validation pass at 376x1242 with the
   image summary on (tb/ parsed back against metrics.jsonl, the val/flow2d
   event and images/flow2d_epoch001.png at 376x1242x3), and one f32 step of
   the KITTI config at 448x256 against the CPU;
10. data-parallel: the flagship's Trainer at full width in f32 (its
   training config, amp off), global batch 2, on phase 9's 4-pair split:
   one process's first step (run twice, to see whether the card repeats it
   bit for bit; where not, the operations of PyTorch's nondeterministic
   list that the step runs are named, and two first steps under
   `use_deterministic_algorithms` are held to each other) and 10 timed
   steps after 2 more, in a process of its own as each rank is, and again
   after the ranks (the spread of its time); (a) one rank
   over NCCL, the Trainer's model in DistributedDataParallel, against it:
   loss, parameters and BatchNorm statistics bit for bit where one process
   repeats itself, else within (b)'s bounds; (b) two ranks over gloo, both
   on the one card, batch 1 each: the loss within 1e-5 relative, the
   parameters within 1e-5 where the two gradients agree in sign (2 lr where
   not), BatchNorm statistics within 1e-6 (1 + |b|), both ranks bit for bit
   alike; each rank's launches a step held (#1 8, #2 1, #3 10, #4
   index-only 10) and ms a step for (a), (b) and one process; (c) the two
   ranks' `run_things` over 5 frames in global batches of 2 (rank 1's last
   slice empty) against one process's totals. The ranks are processes of
   their own (`camliflow_torch.parallel.dist.spawn`), waited for with a
   timeout.

Each path's launches (4, 7, 8, 9 and 10) are counted with every counter
zeroed just before it and read just after. Prints the kernels' JSON line, then the card's name and power limit, then, as
the last line, the device JSON with "ok": true. Exits non-zero, without that
line, if any phase fails or there is no CUDA card.
"""

from __future__ import annotations

import contextlib
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
INTERP_TOL = 1e-5  # atol
CONV_TOL = 1e-4  # max|kernel - plain| <= CONV_TOL * (1 + max|plain|), f32 both
FLOW_3D_TOL = 5e-3  # m, max |CUDA - CPU| on flow_3d
FLOW_2D_TOL = 1e-2  # px, max |CUDA - CPU| on flow_2d
PEAK_F32 = 67e12  # H100 SXM f32 outside the tensor cores, op/s
PEAK_TF32 = 495e12  # H100 SXM TF32 on the tensor cores, dense, op/s
TC_MMA = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, 3xTF32"  # conv_tile_tc.cuh
TC_STAGES = 3  # conv_tile_tc.cuh's kStages
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
HIDDEN_CFGS = {**FLAGSHIP_CFGS, "fuse_hidden": True}  # CLFM at the hidden state too
RAFT_CFGS = {  # conf/model/raft.yaml, at bench.py's 20 iterations
    "name": "raft",
    "backbone": {"depth": 50},
    "n_iters_eval": N_ITERS,
    "fast_inference": "auto",
}
PWC_CFGS = {  # conf/model/pwc.yaml
    "name": "pwc",
    "max_displacement": 4,
    "lite_estimator": False,
    "norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
             "context_network": None},
}
CAMLIPWC_L_CFGS = {  # conf/model/camlipwc_l.yaml (n_samples_list: the model's default)
    "name": "camlipwc_l",
    "ids": {"enabled": True},
    "norm": {"feature_pyramid": "batch_norm", "correlation": None, "flow_estimator": None},
}
CAMLIPWC_CFGS = {  # conf/model/camlipwc.yaml: all three fusions
    "name": "camlipwc",
    "freeze_bn": False,
    "pwc2d": {"norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                       "context_network": None},
              "max_displacement": 4, "lite_estimator": False, "fixed": False},
    "pwc3d": {"norm": {"feature_pyramid": "batch_norm", "correlation": None,
                       "flow_estimator": None},
              "fixed": False, "k": 16},
    "fusion": {"fuse_pyramid": True, "fuse_correlation": True, "fuse_estimator": True},
}
PWC_H = -(-IMAGE_H // 64) * 64  # the PWC family resizes 540 up to 576
INTRINSICS = (1050.0, 479.5, 269.5)
BATCH = 8  # the eval CLI's batch (camliflow_torch/eval.py)


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


def host_ms(fn, reps: int) -> float:
    """Mean host time to issue fn() (its checks and launches), over reps
    calls without a synchronisation between them, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e3 * seconds / reps


def bound(ops: float, nbytes: float, peak: float = PEAK_F32) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over the peak rate for their type and the bytes over the memory rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


PROFILE_TRIES = 6  # the profiler on the H100 drops all or part of a run's events, now and then


def profile_kernels(fn, only: str = "", partial: bool = False) -> tuple[float, list]:
    """fn() under torch.profiler: (wall ms, the device kernels it launched
    whose name holds `only`). A profile is taken as whole when it holds as
    many launches as the profile before it, within 1%: over thousands of
    launches the profiles of one run differ by a few, while one that lost
    part of its events lost far more. With `partial`, any profile that kept
    a launch will do (the caller averages over the launches it kept).
    Another profile is taken until one does, up to PROFILE_TRIES; then it
    raises, so no device time is ever reported that was not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    named = f" named {only}" if only else ""
    previous = None
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - start)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and only in e.key]
        seen = sum(e.count for e in kernels)
        if seen and (partial or previous and abs(seen - previous) <= previous // 100):
            return wall, kernels
        if previous is not None or not seen:
            against = f", the one before {previous}" if previous is not None else ""
            print(f"  (profile {attempt + 1} of {PROFILE_TRIES} recorded {seen} kernel launches"
                  f"{named}{against})", flush=True)
        previous = seen
    raise AssertionError(f"{PROFILE_TRIES} profiles lost kernel launches{named}: device time "
                         "not measured")


def device_ms(fn, reps: int, only: str = "", per_call: int | None = None) -> float:
    """fn()'s device time per call from torch.profiler: the self device
    time of every kernel it launched (whose name holds `only`), summed,
    over reps calls (profile_kernels). per_call: where one kernel is all
    that matches and a call launches it per_call times, its mean time over
    the launches a profile kept, times per_call, which a profile that lost
    some of them gives as well."""
    import torch

    fn()
    torch.cuda.synchronize()
    _, kernels = profile_kernels(lambda: [fn() for _ in range(reps)], only,
                                 partial=per_call is not None)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if per_call is None:
        return total / reps
    if len(kernels) != 1:
        raise AssertionError(f"device_ms: {len(kernels)} kernels named {only}, expected one")
    return total / kernels[0].count * per_call


def in_turns(calls: dict, reps: int, only) -> dict[str, list[float]]:
    """device_ms of each of `calls`' functions, by key; of two, in turns
    (first, second, second, first). `only`: the kernels' name part, or one
    by key."""
    keys = list(calls)
    times = {key: [] for key in keys}
    for key in keys + keys[::-1] if len(keys) > 1 else keys:
        times[key].append(device_ms(calls[key], reps,
                                    only=only[key] if isinstance(only, dict) else only))
    return times


def other_tree(root: str):
    """Another checkout's wrappers of #1, #3, the 3D chain (#6, #7, #13)
    and #12: its ops.knn, ops.interp, ops.update3d, models.camliraft_l
    (whose modules hoist the weights as its wrappers take them) and
    ops.gather, to time
    beside this tree's: its camliflow_torch imported as
    `other_camliflow_torch`, its kernels built from its own sources into its
    own build/."""
    import importlib
    import importlib.util
    from pathlib import Path

    name = "other_camliflow_torch"
    package = Path(root).resolve() / "camliflow_torch"
    spec = importlib.util.spec_from_file_location(
        name, package / "__init__.py", submodule_search_locations=[str(package)])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    path, seconds, _ = importlib.import_module(f"{name}.csrc.build").build()
    print(f"  other tree: built {path} in {seconds:.1f} s", flush=True)
    return tuple(importlib.import_module(f"{name}.{module}")
                 for module in ("ops.knn", "ops.interp", "ops.update3d", "models.camliraft_l",
                                "ops.gather"))


def stage_ms(fn, reps: int) -> list[tuple[str, float]]:
    """Each kernel of fn() in launch order with its mean device time over
    reps calls (torch.profiler's kernel events), or [] if the profiler saw
    none or another count per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):  # as in device_ms
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        if kernels:
            break
    if not kernels or len(kernels) % reps:
        return []
    per = len(kernels) // reps
    return [(kernels[i].name, sum(e.time_range.elapsed_us() for e in kernels[i::per]) / reps / 1e3)
            for i in range(per)]


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel symbol: the identifier (past an
    anonymous namespace) and its integer template arguments."""
    import re

    rest = mangled[2:] if mangled.startswith("_Z") else mangled
    if rest.startswith("N"):  # a nested name: skip an anonymous namespace
        rest = rest[1:]
        length = re.match(r"(\d+)", rest)
        if length and rest[len(length.group(1)):].startswith("_GLOBAL__N"):
            rest = rest[len(length.group(1)) + int(length.group(1)):]
    length = re.match(r"(\d+)", rest)
    if not length:
        return mangled[:60]
    start = len(length.group(1))
    ident, rest = rest[start:start + int(length.group(1))], rest[start + int(length.group(1)):]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not args:
        return ident
    values = re.findall(r"L[ib](\d+)E", args.group(1))
    return f"{ident}<{', '.join(values)}>"


def short_name(kernel: str) -> str:
    """A profiler's kernel name without its namespace and arguments."""
    import re

    found = re.search(r"::(\w+(?:<[^<>]*>)?)\(", kernel)
    return found.group(1) if found else kernel[:40]


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel from nvcc's -Xptxas -v output: registers, static
    shared memory, stack and spills. conv_tc_kernel<BM, BN, warps in M,
    warps in N, reduction slices, epilogue> and conv_tc_group_kernel<BM, BN,
    warps in M, warps in N, epilogue> (one slice; CLFM's dense layers) take
    their shared memory dynamically, TC_STAGES stages of the slices' A
    [BM][16] and the two weight planes [BN][16], which ptxas does not count:
    it is added."""
    import re

    lines, name, spills = [], None, ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name, spills = kernel_name(found.group(1)), ""
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split(":", 1)[-1].strip()
            if name.startswith(("conv_tc_kernel<", "conv_tc_group_kernel<")):
                bm, bn, _, _, *ks, _ = map(int, re.findall(r"\d+", name.split("<", 1)[1]))
                ks = ks[0] if ks else 1
                used += f", {TC_STAGES * 4 * 16 * ks * (bm + 2 * bn)} bytes dynamic smem"
            elif name.startswith(("gru_flowhead_3d_dense", "motion_encoder_3d_dense")):
                used += f", {TC_STAGES * 4 * 16 * (32 + 2 * 64)} bytes dynamic smem (dense steps)"
            elif name.startswith("corr3d_tail_kernel"):  # at the main path's shape
                used += (", 108,288 bytes dynamic smem at L = 4, C1 = 32, Cout = 128 "
                         "(the weights, the taps' rows, the level sums)")
            lines.append(f"{name}: {used} | {spills}")
            name = None
    return lines


def profile_request(evaluator, batch, top: int = 15):
    """One request under torch.profiler: the device's busy share of the
    request's wall time and the kernels that take the most device time.
    Returns (wall ms, device busy ms, kernel launches)."""
    wall, kernels = profile_kernels(lambda: evaluator.forward(batch))
    wall_us = 1e3 * wall
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
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


def main_path_clouds(device):
    """The main path's clouds: bench inputs in IDS (parallel) coordinates,
    both frames, [2, 8192, 3]."""
    import torch

    from camliflow_torch.ops.ids import make_parallel_camera_info, persp2paral

    pcs = torch.as_tensor(frame_pair(SEED + 100, 0)["pcs"][0], device=device)
    persp = {"sensor_h": 540, "sensor_w": 960, "f": INTRINSICS[0],
             "cx": INTRINSICS[1], "cy": INTRINSICS[2]}
    paral = make_parallel_camera_info(540, 960)
    return persp2paral(torch.stack([pcs[:, :3], pcs[:, 3:]]), persp, paral).contiguous()


def selection_calls(both, order, gen):
    """The main paths' calls of #1 and #3 on the clouds `both` and their FPS
    order: (the FPS levels, the KNN calls (label, support, query, k, the
    paths that make the call, a letter each time a request: F flagship, H
    fuse_hidden, L CamLiRAFT-L, P CamLiPWC-L, C CamLiPWC; none for the
    train paths' k=3 calls), the
    interpolation calls (label, support, features, query), k=3). The CLFM
    caches' projected points, the flow and the flow features come from
    `gen`. The PWC family's calls are a frame's: its pyramid runs each frame
    alone; a decoder level's two selections, the level's points among
    themselves and among frame 2's, are one row of the same shape."""
    import torch

    from camliflow_torch.ops.geometry import gather_points

    device = both.device
    lv = [gather_points(both, order[:, :m]) for m in N_SAMPLES]
    # the CLFM cache: the 1/8 pixel grid (68 x 120) against both frames'
    # projected points in 2-D, k=1
    feat_h, feat_w = -(-IMAGE_H // 8), -(-IMAGE_W // 8)
    uv = torch.rand(2, N_SAMPLES[1], 2, generator=gen, device=device)
    uv = (uv * torch.tensor([feat_w - 1.0, feat_h - 1.0], device=device)).contiguous()
    ys, xs = torch.meshgrid(torch.arange(float(feat_h), device=device),
                            torch.arange(float(feat_w), device=device), indexing="ij")
    pixels = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(2, -1, -1).contiguous()
    knn_calls = [
        ("encoder level 0", both, lv[0], 16, "FHL"),  # both frames
        ("encoder level 1", lv[0], lv[1], 16, "FHL"),
        ("pooling 2048", lv[1][1:], lv[2][1:], 3, "FHL"),
        ("pooling 1024", lv[2][1:], lv[3][1:], 3, "FHL"),
        ("pooling 512", lv[3][1:], lv[4][1:], 3, "FHL"),
        ("update neighbours", lv[1][:1], lv[1][:1], 32, "FHL"),
        ("final upsample", lv[1][:1], both[:1], 3, "FH"),
        ("CLFM pixel cache", uv, pixels, 1, "FH"),
    ]
    # the PWC family's: frame 1's pyramid 8192 -> 4096 -> ... -> 256 (each
    # frame's), a decoder level's two k=16 selections at 4096 .. 256 points,
    # and CamLiPWC's two CLFM caches a level: the level's pixel grid (1/4 of
    # the 576 x 960 resized images at level 1: 144 x 240) against its points
    # projected, 2-D, k=1
    frame = [both[:1]] + [level[:1] for level in lv]
    for i in range(len(N_SAMPLES)):
        n_in, n_out = frame[i].shape[1], frame[i + 1].shape[1]
        knn_calls.append((f"pyramid {n_in}->{n_out}", frame[i], frame[i + 1], 16, "PPCC"))
    for level in range(1, len(N_SAMPLES) + 1):
        n = frame[level].shape[1]
        knn_calls.append((f"decoder level {level} ({n})", frame[level], frame[level], 16,
                          "PPCC"))
    for level in range(1, len(N_SAMPLES) + 1):
        map_h, map_w = PWC_H >> (level + 1), IMAGE_W >> (level + 1)
        n = frame[level].shape[1]
        level_uv = torch.rand(1, n, 2, generator=gen, device=device)
        level_uv = (level_uv * torch.tensor([map_w - 1.0, map_h - 1.0], device=device))
        ys, xs = torch.meshgrid(torch.arange(float(map_h), device=device),
                                torch.arange(float(map_w), device=device), indexing="ij")
        grid = torch.stack([xs, ys], -1).reshape(1, -1, 2).contiguous()
        knn_calls.append((f"CLFM cache level {level} ({map_h}x{map_w})",
                          level_uv.contiguous(), grid, 1, "CC"))
    # KITTI fine-tuning's 2-D selections (its train steps and validation,
    # batches of 2): the flagship's CLFM cache on the 1/8 grid of 376 x 1242
    # padded to 376 x 1248, and CamLiPWC's caches on the levels of 376 x 1242
    # resized to 384 x 1280
    def grid_calls(label, map_h, map_w, n):
        uv = torch.rand(2, n, 2, generator=gen, device=device)
        uv = uv * torch.tensor([map_w - 1.0, map_h - 1.0], device=device)
        ys, xs = torch.meshgrid(torch.arange(float(map_h), device=device),
                                torch.arange(float(map_w), device=device), indexing="ij")
        grid = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(2, -1, -1).contiguous()
        knn_calls.append((f"KITTI {label} ({map_h}x{map_w})", uv.contiguous(), grid, 1, ""))

    kitti_h, kitti_w = -(-KITTI_PAD_H // 64) * 64, -(-KITTI_W // 64) * 64  # CamLiPWC's resize
    grid_calls("CLFM pixel cache", -(-KITTI_PAD_H // 8), -(-KITTI_W // 8), N_SAMPLES[1])
    for level in range(1, len(N_SAMPLES) + 1):
        grid_calls(f"CLFM cache level {level}", kitti_h >> (level + 1), kitti_w >> (level + 1),
                   N_SAMPLES[level - 1])
    # the train paths' k=3 selections, batches of 2 (each frame a sample):
    # CamLiRAFT-L's upsample 2048 -> 8192, and the interpolation's train form
    # in the PWC family, each level's flow upsampled to the next finer level
    # and the backwarps of decoder levels 1-4
    knn_calls.append(("train upsample [2,8192] <- [2,2048]", lv[1], both, 3, ""))
    finer = [both] + lv
    for i in range(len(N_SAMPLES)):
        n, m = finer[i].shape[1], finer[i + 1].shape[1]
        knn_calls.append((f"train level upsample [2,{n}] <- [2,{m}]", finer[i + 1], finer[i], 3,
                          ""))
    for level in range(1, len(N_SAMPLES)):
        xyz = lv[level - 1]
        warped = xyz + 0.05 * torch.randn(xyz.shape, generator=gen, device=device)
        knn_calls.append((f"train backwarp [2,{xyz.shape[1]}]", warped.contiguous(),
                          xyz.flip(0).contiguous(), 3, ""))
    # the backwarp of frame 2 by the flow, CamLiRAFT-L's final upsample and
    # CamLiPWC's level upsample (2048 -> 4096) of the flow and its 64
    # flow-feature channels
    xyz1, xyz2 = lv[1][:1], lv[1][1:]
    flow = 0.05 * torch.randn(xyz1.shape, generator=gen, device=device)
    flow_feat = torch.randn(1, N_SAMPLES[1], 64, generator=gen, device=device)
    interp_calls = [("backwarp", (xyz1 + flow).contiguous(), (-flow).contiguous(), xyz2),
                    ("upsample", xyz1, flow, both[:1]),
                    ("level upsample, 67 channels", xyz1, torch.cat([flow, flow_feat], -1),
                     lv[0][:1])]
    return lv, knn_calls, interp_calls


def kernel_parity(device, other=None) -> list[dict]:
    """Phase 3: each kernel vs its plain version at the main-path shapes."""
    import torch
    from torch import nn

    from camliflow_torch.models.camliraft_l import (
        Correlation3D,
        FlowHead3D,
        GRU3D,
        MotionEncoder3D,
    )
    from camliflow_torch.models.raft import FlowHead2D, GRU2D, MotionEncoder2D
    from camliflow_torch.nn.clfm import CLFM, fusion_interp_cache
    from camliflow_torch.ops import clfm, corr3d, fps, gather, interp, knn, update2d, update3d
    from camliflow_torch.runtime.checkpoint import random_weights

    both = main_path_clouds(device)  # [2, 8192, 3]
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = []

    def record(name, source, replaces, err, ms, plain_ms, ops, nbytes, label=None,
               entry=True, wrapper=None, library_ms=None, tensor_cores=False, **extra):
        """Print one measurement (as `label`); `entry` adds it to the kernels
        JSON line, whose launches are those of `wrapper` (default `name`).
        `library_ms`: one PyTorch call that computes the same function.
        `tensor_cores`: f32 work done on the tensor cores by the 3xTF32
        split, whose least time is 3 TF32 operations per f32 operation at
        the TF32 peak (bound_ms; the f32 bound outside the tensor cores
        beside it). `extra`: more keys of the entry."""
        bound_ms, bound_by = bound(ops, nbytes)
        if tensor_cores:
            extra = {"bound_f32_ms": bound_ms, "mma": TC_MMA, **extra}
            bound_ms, bound_by = bound(3 * ops, nbytes, PEAK_TF32)
        if entry:
            results.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": 0, "max_abs_err": err,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms,
                            "wrapper": wrapper or name, **extra})
        library = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        f32 = f", f32 {extra['bound_f32_ms']:.4f} ms" if tensor_cores else ""
        print(f"  {label or name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms{library}  bound {bound_ms:.4f} ms ({bound_by}{f32})",
              flush=True)

    # FPS [2, 8192] -> 4096: indices identical, also on a copy of the clouds
    # with every fifth point duplicated far away (exact ties), and again on a
    # second run. Each step updates every point's distance (8 flops), its
    # running min and the argmax compare.
    n_fps = N_SAMPLES[0]
    dup = both.clone()  # every fifth point a copy of the point half a cloud away
    dup[:, 1::5] = both[:, (torch.arange(1, N_POINTS, 5, device=device) + N_POINTS // 2)
                        % N_POINTS]
    refs = [fps.furthest_point_sampling_plain(cloud, n_fps) for cloud in (both, dup)]
    for name, cloud, ref in zip(("random", "duplicated"), (both, dup), refs):
        first = fps.furthest_point_sampling(cloud, n_fps)
        again = fps.furthest_point_sampling(cloud, n_fps)
        if not (torch.equal(first, ref) and torch.equal(again, first)):
            raise AssertionError(f"FPS on the {name} clouds: indices differ from the plain "
                                 "version or between two runs")
    got = fps.furthest_point_sampling(both, n_fps)
    ms = time_ms(lambda: fps.furthest_point_sampling(both, n_fps), 5)
    record("furthest_point_sampling", "camliflow_torch/csrc/fps.cu",
           "camliflow_tpu/ops/pallas_fps.py:109", 0.0, ms,
           time_ms(lambda: fps.furthest_point_sampling_plain(both, n_fps), 2),
           2 * n_fps * N_POINTS * 10, 4 * (2 * N_POINTS * 3 + 2 * n_fps),
           label=f"furthest_point_sampling (cluster of {fps.CLUSTER} blocks: "
                 f"{1e3 * ms / n_fps:.4f} us a step)",
           us_per_step=1e3 * ms / n_fps, cluster=fps.CLUSTER)

    # KNN (#1): every call the main paths make, indices bit for bit the plain
    # version's, also on a copy with exact ties (every 7th point repeats an
    # earlier one, every third query sits on a point), and the kernel's
    # device time at each (profiler; the 2-D call's two pad launches apart)
    lv, knn_calls, interp_calls = selection_calls(both, got, gen)
    feat_h, feat_w = -(-IMAGE_H // 8), -(-IMAGE_W // 8)
    xyz1, pc1 = lv[1][:1], both[:1]
    uv = next(call[1] for call in knn_calls if call[0] == "CLFM pixel cache")
    flow = interp_calls[1][2]  # the flow the interpolation upsamples

    def tie(support, query):
        support, query = support.clone(), query.clone()
        m7 = support[:, 1::7].shape[1]
        support[:, 1::7] = support[:, : 7 * m7 : 7].clone()
        n3 = query[:, ::3].shape[1]
        query[:, ::3] = support[:, torch.arange(n3, device=device) * 5 % support.shape[1]]
        return support, query

    # (with another tree, its wrappers are held to the plain versions too and
    # timed in turns with this tree's: other, this, this, other)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def mean(times):
        return sum(times) / len(times)

    def beside(times):  # each reading, where the other tree's stand beside
        if "other" not in times:
            return ""
        this, theirs = (", ".join(f"{t:.4f}" for t in times[key]) for key in ("this", "other"))
        return f" ({this}); other tree {theirs} ms"

    knn_wrappers = {"this": knn.k_nearest_neighbor}
    if other:
        knn_wrappers = {"other": other[0].k_nearest_neighbor, **knn_wrappers}
    knn_dev, knn_bound, knn_other = {}, {}, {}
    for label, support, query, k, _ in knn_calls:
        for sup, qry in ((support, query), tie(support, query)):
            ref = knn.k_nearest_neighbor_plain(sup, qry, k)
            for tree, wrapper in knn_wrappers.items():
                if not torch.equal(wrapper(sup, qry, k), ref):
                    raise AssertionError(f"KNN {label}: {tree} tree's indices differ from the "
                                         "plain version")
        calls = {tree: lambda w=wrapper: w(support, query, k)
                 for tree, wrapper in knn_wrappers.items()}
        times = in_turns(calls, 20, "knn_kernel")
        knn_dev[label] = mean(times["this"])
        if other:
            knn_other[label] = mean(times["other"])
        batch, m, dim = support.shape
        n = query.shape[1]
        knn_bound[label] = bound(batch * n * m * 9,  # 8 flops + 1 compare per pair
                                 4 * (batch * (m + n) * dim + batch * n * k))[0]
        plan = knn.select_plan(batch, n, m, k, sms)
        print(f"  k_nearest_neighbor {label} [{batch},{n}] <- [{batch},{m}], k={k}: plan "
              f"(slices, queries a block, a warp) {plan}; device {knn_dev[label]:.4f} ms"
              f"{beside(times)}, bound {knn_bound[label]:.4f} ms", flush=True)

    request_paths = (("flagship", "F"), ("camliraft_l", "L"), ("camlipwc_l", "P"),
                     ("camlipwc", "C"))

    def request(dev):  # the calls' device times summed a request of each path
        return {path: sum(paths.count(key) * dev[label] for label, *_, paths in knn_calls)
                for path, key in request_paths}

    knn_request = request(knn_dev)
    for tree, sums in (("", knn_request), ("other tree's ", request(knn_other) if other else None)):
        if sums:
            print(f"  {tree}k_nearest_neighbor device time a request: " + ", ".join(
                f"{path} ({sum(c[-1].count(key) for c in knn_calls)} calls) {sums[path]:.4f} ms"
                for path, key in request_paths), flush=True)
    record("k_nearest_neighbor", "camliflow_torch/csrc/knn.cu",
           "camliflow_tpu/ops/pallas_knn.py:67", 0.0,
           time_ms(lambda: knn.k_nearest_neighbor(both, lv[0], 16), 20),
           time_ms(lambda: knn.k_nearest_neighbor_plain(both, lv[0], 16), 3),
           2 * N_SAMPLES[0] * N_POINTS * 9,  # 8 flops + 1 compare per pair
           4 * (2 * N_POINTS * 3 + 2 * N_SAMPLES[0] * 3 + 2 * N_SAMPLES[0] * 16),
           label="k_nearest_neighbor encoder level 0 (by events)",
           device_ms=knn_dev["encoder level 0"], device_ms_by_call=knn_dev,
           bound_ms_by_call=knn_bound, device_ms_request=knn_request)

    # interpolation (#3): backwarp [1,2048] <- [1,2048] and upsample [1,8192],
    # k=3, C=3, and CamLiPWC's level upsample [1,4096] <- [1,2048], C=67:
    # within INTERP_TOL of the plain version, and with k=1 on each support's
    # index as its feature, the selected index itself. A call's work: the
    # selection's pairs (8 flops + 1 compare), then per query and neighbour
    # 12 flops of weight and 2 a channel
    index = torch.arange(float(N_SAMPLES[1]), device=device)[None, :, None].contiguous()
    interp_err, interp_ms, interp_dev, interp_bound = 0.0, {}, {}, {}
    for label, support, feats, query in interp_calls:
        a = interp.knn_interpolation(support, feats, query, 3)
        b = interp.knn_interpolation_plain(support, feats, query, 3)
        err = float((a - b).abs().max())
        if err > INTERP_TOL:
            raise AssertionError(f"interp {label}: max |d| {err}")
        picked = interp.knn_interpolation(support, index, query, 1)[..., 0].int()
        if not torch.equal(picked, knn.k_nearest_neighbor_plain(support, query, 1)[..., 0]):
            raise AssertionError(f"interp {label}: k=1 selects other supports than the plain KNN")
        interp_err = max(interp_err, err)
        call = lambda: interp.knn_interpolation(support, feats, query, 3)  # noqa: E731
        calls = {"this": call}
        if other:
            calls = {"other": lambda: other[1].knn_interpolation(support, feats, query, 3),
                     **calls}
            theirs = float((calls["other"]() - b).abs().max())
            if theirs > INTERP_TOL:
                raise AssertionError(f"other tree's interp {label}: max |d| {theirs}")
        times = in_turns(calls, 20, "interp_kernel")
        interp_ms[label], interp_dev[label] = time_ms(call, 50), mean(times["this"])
        n, (m, c) = query.shape[1], feats.shape[1:]
        interp_bound[label] = bound(n * m * 9 + n * 3 * (12 + 2 * c),
                                    4 * (m * 3 + m * c + n * 3 + n * c))[0]
        print(f"  knn_interpolation {label} [1,{n}] <- [1,{m}], C={c}: plan "
              f"{knn.select_plan(1, n, m, 3, sms)}; events "
              f"{interp_ms[label]:.4f} ms, device {interp_dev[label]:.4f} ms{beside(times)}, "
              f"bound {interp_bound[label]:.4f} ms", flush=True)
    m = N_SAMPLES[1]
    record("knn_interpolation", "camliflow_torch/csrc/interp.cu",
           "camliflow_tpu/ops/pallas_interp.py:81", interp_err, interp_ms["backwarp"],
           time_ms(lambda: interp.knn_interpolation_plain(*interp_calls[0][1:], 3), 20),
           m * m * 9 + m * 3 * (12 + 2 * 3), 4 * (m * 3 * 2 + m * 3 * 2),
           label="knn_interpolation backwarp (by events)", device_ms=interp_dev["backwarp"],
           upsample_ms=interp_ms["upsample"], upsample_device_ms=interp_dev["upsample"],
           upsample_bound_ms=interp_bound["upsample"], ms_by_call=interp_ms,
           device_ms_by_call=interp_dev, bound_ms_by_call=interp_bound)

    # Correlation3D selection + cost: levels 2048..256, k=16; indices and
    # costs bit for bit, also on a copy of the clouds with exact ties
    sizes = N_SAMPLES[1:]
    xyz2_warp = (lv[1][1:] + 0.05 * torch.randn(
        xyz1.shape, generator=gen, device=device)).contiguous()
    pyramid = torch.randn(1, sizes[0], sum(sizes), generator=gen, device=device)
    tied_2, tied_1 = xyz2_warp.clone(), xyz1.clone()
    tied_2[:, 1::7] = tied_2[:, : 7 * tied_2[:, 1::7].shape[1] : 7].clone()
    tied_1[:, ::3] = tied_2[:, 5 : 5 + tied_1[:, ::3].shape[1]]
    for query, support in ((xyz1, xyz2_warp), (tied_1, tied_2)):
        got = corr3d.correlation3d_knn(query, support, pyramid, sizes, 16)
        ref = corr3d.correlation3d_knn_plain(query, support, pyramid, sizes, 16)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError("corr3d: indices or costs differ from the plain version")
    idx_sel, cost = corr3d.correlation3d_knn(xyz1, xyz2_warp, pyramid, sizes, 16)
    starts, queries = corr3d.scan_plan(sizes)
    select = lambda: corr3d.correlation3d_knn(xyz1, xyz2_warp, pyramid, sizes, 16)  # noqa: E731
    print(f"  corr3d: {len(starts) - 1} slices a query, {queries} queries a block, "
          f"{-(-m // queries)} blocks; device {device_ms(select, 20):.4f} ms, host "
          f"{host_ms(select, 20):.4f} ms a call")
    n_sel = m * len(sizes) * 16
    record("correlation3d_knn", "camliflow_torch/csrc/corr3d.cu",
           "camliflow_tpu/ops/pallas_corr3d.py:440", 0.0, time_ms(select, 50),
           time_ms(lambda: corr3d.correlation3d_knn_plain(
               xyz1, xyz2_warp, pyramid, sizes, 16), 20),
           m * m * 9,  # one scan of the level-0 candidates serves every level
           # the points, the selected pyramid entries, indices and costs out
           4 * (2 * m * 3 + 3 * n_sel))

    # its index-only form (the training path's, with_cost=False) at the
    # train shapes, a batch of 2 (one cloud random, one with exact ties):
    # the full form's indices and the plain version's, bit for bit
    train_1 = torch.cat([xyz1, tied_1]).contiguous()
    train_2 = torch.cat([xyz2_warp, tied_2]).contiguous()
    train_pyramid = pyramid.expand(2, -1, -1).contiguous()
    only, none = corr3d.correlation3d_knn(train_1, train_2, None, sizes, 16, with_cost=False)
    full = corr3d.correlation3d_knn(train_1, train_2, train_pyramid, sizes, 16)[0]
    plain = corr3d.correlation3d_knn_plain(train_1, train_2, None, sizes, 16, with_cost=False)[0]
    if none is not None or not (torch.equal(only, full) and torch.equal(only, plain)):
        raise AssertionError("corr3d index-only: indices differ from the full form's or the "
                             "plain version's")
    select_only = lambda: corr3d.correlation3d_knn(  # noqa: E731
        train_1, train_2, None, sizes, 16, with_cost=False)
    only_dev = device_ms(select_only, 20, only="corr3d_kernel")
    full_dev = device_ms(lambda: corr3d.correlation3d_knn(train_1, train_2, train_pyramid,
                                                          sizes, 16), 20, only="corr3d_kernel")
    print(f"  corr3d index-only, batch 2: device {only_dev:.4f} ms a call, the full form "
          f"{full_dev:.4f} ms; host {host_ms(select_only, 20):.4f} ms", flush=True)
    record("correlation3d_knn (index-only)", "camliflow_torch/csrc/corr3d.cu",
           "camliflow_tpu/ops/pallas_corr3d.py:440", 0.0, time_ms(select_only, 50),
           time_ms(lambda: corr3d.correlation3d_knn_plain(
               train_1, train_2, None, sizes, 16, with_cost=False), 20),
           2 * m * m * 9,
           # the points in, the indices out: no pyramid, no costs
           4 * 2 * (2 * m * 3 + n_sel),
           wrapper="correlation3d_knn_index", device_ms=only_dev, full_form_device_ms=full_dev,
           batch=2)

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
               2 * pixels * macs, 4 * (pixels * (2 + 128 + 324 + 128) + weights),
               tensor_cores=True)

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
               2 * pixels * macs, 4 * (pixels * (3 * 128 + 128 + 2) + weights),
               tensor_cores=True)
        for _ in range(2):  # the flow head's split reduction meets in a fixed order
            again = update2d.gru_flowhead_2d(h, x2d, motion, gf)
            if not (torch.equal(again[0], h_k) and torch.equal(again[1], d_k)):
                raise AssertionError("gru_flowhead_2d: two runs give different bits")

        # #8's halves, as the fuse_hidden path calls them (CLFM between them)
        gp = update2d.prepare_gru_params(gru)
        hp = update2d.prepare_flow_head_params(head)
        x_cat = torch.cat([x2d, motion], dim=-1)
        h_k = update2d.gru_2d(h, x2d, motion, gp)
        err = check("gru_2d", h_k, update2d.gru_2d_plain(h, x_cat, gp))
        record("gru_2d", "camliflow_torch/csrc/update2d.cu",
               "camliflow_tpu/ops/pallas_update2d.py:235", err,
               time_ms(lambda: update2d.gru_2d(h, x2d, motion, gp), 20),
               time_ms(lambda: update2d.gru_2d_plain(h, x_cat, gp), 20),
               2 * pixels * 2 * 5 * 384 * (256 + 128),
               4 * (pixels * 4 * 128 + sum(size(gp[k]) for k in gp)), tensor_cores=True)
        d_k = update2d.flow_head_2d(h, hp)
        err = check("flow_head_2d", d_k, update2d.flow_head_2d_plain(h, hp))
        record("flow_head_2d", "camliflow_torch/csrc/update2d.cu",
               "camliflow_tpu/ops/pallas_update2d.py:235", err,
               time_ms(lambda: update2d.flow_head_2d(h, hp), 20),
               time_ms(lambda: update2d.flow_head_2d_plain(h, hp), 20),
               2 * pixels * (9 * 128 * 256 + 9 * 256 * 2),
               4 * (pixels * (128 + 2) + sum(size(hp[k]) for k in hp)), tensor_cores=True)

        # the whole RAFT iteration from one entry point: #9 then #8 on the
        # tile, 10 launches, bit for bit the two wrappers in sequence, which
        # are timed beside it (the port's own chain, not a library call)
        fused = lambda: update2d.update_2d(h, x2d, flow2d, corr, me, gf)  # noqa: E731
        chain = lambda: update2d.gru_flowhead_2d(  # noqa: E731
            h, x2d, update2d.motion_encoder_2d(flow2d, corr, me), gf)
        h_k, d_k = fused()
        h_c, d_c = chain()
        if not (torch.equal(h_k, h_c) and torch.equal(d_k, d_c)):
            raise AssertionError("update_2d: not bit for bit the chain motion_encoder_2d + "
                                 "gru_flowhead_2d")
        for _ in range(2):
            again = fused()
            if not (torch.equal(again[0], h_k) and torch.equal(again[1], d_k)):
                raise AssertionError("update_2d: two runs give different bits")
        h_p, d_p = update2d.update_2d_plain(h, x2d, flow2d, corr, me, gf)
        err = max(check("update_2d h'", h_k, h_p), check("update_2d delta", d_k, d_p))
        weights = sum(size(p) for k, p in me.items() if k != "conv_f1")
        weights += sum(size(p) for p in gf.values())
        macs = (324 * 256 + 9 * 256 * 192 + 9 * 128 * 64 + 9 * 256 * 126
                + 2 * 5 * 384 * (256 + 128) + 9 * 128 * 256 + 9 * 256 * 2)
        steps = stage_ms(fused, 10)
        update_dev, update_host = device_ms(fused, 10), host_ms(fused, 20)
        chain_ms, chain_dev = time_ms(chain, 20), device_ms(chain, 10)
        print("  update_2d device time by launch (profiler): " +
              ", ".join(f"{short_name(k)} {ms:.4f}" for k, ms in steps) +
              f"; {update_dev:.4f} ms device, host {update_host:.4f} ms a call; the chain "
              f"motion_encoder_2d + gru_flowhead_2d {chain_ms:.4f} ms by events, "
              f"{chain_dev:.4f} ms device")
        record("update_2d", "camliflow_torch/csrc/update2d.cu",
               "camliflow_tpu/ops/pallas_update2d.py:514", err,
               time_ms(fused, 20),
               time_ms(lambda: update2d.update_2d_plain(h, x2d, flow2d, corr, me, gf), 20),
               2 * pixels * macs, 4 * (pixels * (2 * 128 + 2 + 324 + 128 + 2) + weights),
               library_ms=chain_ms, tensor_cores=True, device_ms=update_dev,
               host_ms=update_host,
               library="the port's own wrappers motion_encoder_2d + gru_flowhead_2d in "
                       "sequence (the same 10 launches), not a library call",
               library_device_ms=chain_dev, steps_ms=[ms for _, ms in steps])

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

        # #6, and with another tree its #6 too, held to the plain version
        # (the flow columns bit for bit) and to itself on a second run; timed
        # by events, by profiler device time (in turns with the other tree's,
        # each tree's own kernels), by launch, and by host time a call
        flow3d, corr3 = rand3(3, 0.05), rand3(128)
        me3 = update3d.prepare_motion_encoder_3d_params(encoder)
        me_plain = update3d.motion_encoder_3d_plain(flow3d, corr3, idx, dw_me, me3)
        me_calls = {"this": lambda: update3d.motion_encoder_3d(flow3d, corr3, idx, dw_me, me3)}
        me_only = {"this": "motion_encoder_3d"}
        if other:  # its own module hoists the weights in its own layout
            other_encoder = other[3].MotionEncoder3D().to(device)
            other_encoder.load_state_dict(encoder.state_dict())
            dw_other = other_encoder.precompute_weights(xyz1, idx)
            me_other = other[2].prepare_motion_encoder_3d_params(other_encoder)
            me_calls = {"other": lambda: other[2].motion_encoder_3d(flow3d, corr3, idx, dw_other,
                                                                    me_other), **me_calls}
            me_only["other"] = ""  # whatever kernels the other tree's #6 launches
        for tree, call in me_calls.items():
            motion3 = call()
            err = check(f"{tree} tree's motion_encoder_3d", motion3, me_plain)
            if not torch.equal(motion3[..., -3:], flow3d):
                raise AssertionError(f"{tree} tree's motion_encoder_3d: the flow columns differ")
            if not torch.equal(call(), motion3):
                raise AssertionError(f"{tree} tree's motion_encoder_3d: two runs give "
                                     "different bits")
        me_times = in_turns(me_calls, 20, me_only)
        me_dev = mean(me_times["this"])
        me_steps = stage_ms(me_calls["this"], 20)
        me_host = {tree: host_ms(call, 20) for tree, call in me_calls.items()}
        print("  motion_encoder_3d steps, device time (profiler): " + ", ".join(
            f"{ms:.4f}" for _, ms in me_steps) + f"; device {me_dev:.4f} ms a call"
            f"{beside(me_times)}; host " + ", ".join(
                f"{tree} {ms:.4f}" for tree, ms in me_host.items()) + " ms a call", flush=True)
        weights = sum(size(me3[k]) for k in update3d.ME_CONVS)
        me_floats = sum(dw_me[k].shape[2] * me3[k].cout for k in update3d.ME_CONVS)  # 5,328
        record("motion_encoder_3d", "camliflow_torch/csrc/update3d.cu",
               "camliflow_tpu/ops/pallas_update3d.py:248", err,
               time_ms(me_calls["this"], 50),
               time_ms(lambda: update3d.motion_encoder_3d_plain(flow3d, corr3, idx, dw_me, me3),
                       20),
               # the MLPs' multiply-adds, a multiply and a max per gathered value
               2 * n * (linear_macs({k: me3[k] for k in update3d.ME_CONVS}) + me_floats),
               # points, neighbours (int32), the hoisted weights (unpadded), output
               4 * (n * (3 + 128 + 32 + 128) + n * me_floats + weights),
               device_ms=me_dev, host_ms=me_host["this"],
               steps_ms=[ms for _, ms in me_steps],
               **({"other_device_ms": mean(me_times["other"]),
                   "other_host_ms": me_host["other"]} if other else {}))

        # #7 held to the plain version and to itself on a second run, at the
        # loop's 2048 points and at the eval CLI's batch of 8; its steps by
        # profiler device time
        h3, x3 = torch.tanh(rand3(128)), torch.relu(rand3(128))
        gf3 = update3d.prepare_gru_flowhead_3d_params(gru, head)
        h_p, d_p = update3d.gru_flowhead_3d_plain(h3, x3, motion3, idx, dw_gf, gf3)
        default = lambda: update3d.gru_flowhead_3d(h3, x3, motion3, idx, dw_gf, gf3)  # noqa: E731
        h_k, d_k = default()
        err = max(check("gru_flowhead_3d h'", h_k, h_p), check("gru_flowhead_3d delta", d_k, d_p))
        again = default()
        if not (torch.equal(again[0], h_k) and torch.equal(again[1], d_k)):
            raise AssertionError("gru_flowhead_3d: two runs give different bits")
        gf_calls = {"this": default}
        if other:  # the other tree's #7: the same bits, and its device time in turns
            gf_other = other[2].prepare_gru_flowhead_3d_params(gru, head)
            gf_calls = {"other": lambda: other[2].gru_flowhead_3d(h3, x3, motion3, idx, dw_gf,
                                                                  gf_other), **gf_calls}
            theirs = gf_calls["other"]()
            if not (torch.equal(theirs[0], h_k) and torch.equal(theirs[1], d_k)):
                raise AssertionError("gru_flowhead_3d: not the other tree's bits")
        gf_times = in_turns(gf_calls, 20, "gru_flowhead_3d")
        print(f"  gru_flowhead_3d: device {mean(gf_times['this']):.4f} ms a call"
              f"{beside(gf_times)}{'; the other tree bit for bit' if other else ''}", flush=True)
        rep = (8, 1, 1)
        xyz8 = xyz1.repeat(rep).contiguous()
        idx8 = knn.k_nearest_neighbor(xyz8, xyz8, 32)
        dw8 = {**gru.precompute_weights(xyz8, idx8), **head.precompute_weights(xyz8, idx8)}
        args8 = (h3.repeat(rep), x3.repeat(rep), motion3.repeat(rep), idx8, dw8, gf3)
        ref8 = update3d.gru_flowhead_3d_plain(*args8)
        got8 = update3d.gru_flowhead_3d(*args8)
        err = max(err, check("gru_flowhead_3d bs=8 h'", got8[0], ref8[0]),
                  check("gru_flowhead_3d bs=8 delta", got8[1], ref8[1]))
        bs8 = {"ms": time_ms(lambda: update3d.gru_flowhead_3d(*args8), 20),
               "device_ms": device_ms(lambda: update3d.gru_flowhead_3d(*args8), 10)}
        del dw8, args8, ref8, got8
        print(f"  gru_flowhead_3d at bs=8 (16,384 points): {bs8['ms']:.4f} ms by events, "
              f"{bs8['device_ms']:.4f} ms device")
        steps = stage_ms(default, 20)
        names = ("dense z|r + q_xm", "tail z|r", "dense q_h", "tail q + conv1 (FMA)",
                 "tail conv1 + conv2 (FMA)", "tail conv2 + fc")
        steps_ms = {name: ms for name, (_, ms) in zip(names, steps)}
        if len(steps) == len(names):
            print("  gru_flowhead_3d steps, device time (profiler): " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in steps_ms.items()) +
                f"; total {sum(steps_ms.values()):.4f} ms")
        else:
            print(f"  gru_flowhead_3d: the profiler saw {len(steps)} kernels a call")
        gf_host = host_ms(default, 20)
        print(f"  gru_flowhead_3d: host {gf_host:.4f} ms a call")
        keys = ("zr", "q", "conv1", "conv2", "fc")  # the function's own layers
        weights = sum(size(gf3[k]) for k in keys)
        record("gru_flowhead_3d", "camliflow_torch/csrc/update3d.cu",
               "camliflow_tpu/ops/pallas_update3d.py:372", err, time_ms(default, 50),
               time_ms(lambda: update3d.gru_flowhead_3d_plain(h3, x3, motion3, idx, dw_gf, gf3),
                       20),
               2 * n * (sum(gf3[k].cin * gf3[k].cout for k in keys) + dw_floats(dw_gf)),
               4 * (n * (3 * 128 + 32 + 128 + 3) + n * dw_floats(dw_gf) + weights),
               steps_ms=steps_ms, host_ms=gf_host, bs8=bs8)

        # the PointConvDW tail alone, at the fuse_hidden path's four shapes:
        # GRU3D's z|r and q (k=4), FlowHead3D's conv1 and conv2 (k=32); with
        # another tree, its tail too, bit for bit both, timed in turns
        tail_dev, tail_other, tail_bound = {}, {}, {}  # by shape, filled as they run
        for key, channels in (("conv_zr", 256), ("conv_q", 128), ("conv1", 128),
                              ("conv2", 64)):
            table, w = rand3(channels), dw_gf[key]
            ref = update3d.dw_max_plain(table, idx, w)
            tails = {"this": update3d.dw_max}
            if other:
                tails = {"other": other[2].dw_max, **tails}
            for tree, wrapper in tails.items():
                for _ in range(2):
                    if not torch.equal(wrapper(table, idx, w), ref):
                        raise AssertionError(f"{tree} tree's dw_max {key}: not bit-identical to "
                                             "the plain version")
            calls = {tree: lambda fn=wrapper: fn(table, idx, w) for tree, wrapper in tails.items()}
            times = in_turns(calls, 20, {"this": "dw_max_tail", "other": ""})
            hosts = {tree: host_ms(call, 20) for tree, call in calls.items()}
            k = w.shape[2]
            tail_dev[key] = mean(times["this"])
            if other:
                tail_other[key] = mean(times["other"])
            tail_bound[key] = bound(2 * n * k * channels,
                                    4 * (2 * n * channels + n * 32 + n * k * channels))[0]
            print(f"  dw_max {key} (k={k}, C={channels}): device {tail_dev[key]:.4f} ms"
                  f"{beside(times)}; host " + ", ".join(
                      f"{tree} {ms:.4f}" for tree, ms in hosts.items()) + " ms a call",
                  flush=True)
            record("dw_max", "camliflow_torch/csrc/update3d.cu",
                   "camliflow_tpu/ops/pallas_ohg.py:177", 0.0,
                   time_ms(calls["this"], 50),
                   time_ms(lambda: update3d.dw_max_plain(table, idx, w), 20),
                   2 * n * k * channels,  # a multiply and a max per gathered value
                   4 * (2 * n * channels + n * 32 + n * k * channels),
                   label=f"dw_max {key} (k={k}, C={channels}, by events)", entry=key == "conv1",
                   device_ms=tail_dev[key], host_ms=hosts["this"], device_ms_by_shape=tail_dev,
                   bound_ms_by_shape=tail_bound,
                   **({"other_device_ms_by_shape": tail_other} if other else {}))

    # the Correlation3D tail on the selection above (L=4, k=16, 2048 queries)
    tail_block = Correlation3D(n_levels=len(sizes), out_channels=128, k=16)
    random_weights(tail_block, SEED + 9)
    tail = corr3d.prepare_corr3d_tail_params(tail_block.to(device))
    with torch.inference_mode():
        args = (xyz1, xyz2_warp, idx_sel, cost, tail, len(sizes), 16)
        got = corr3d.corr3d_tail(*args)
        err = check("corr3d_tail", got, corr3d.corr3d_tail_plain(*args))
        for _ in range(2):  # the level sums and the merge add in a fixed order
            if not torch.equal(corr3d.corr3d_tail(*args), got):
                raise AssertionError("corr3d_tail: two runs give different bits")
        c1 = tail.w2.shape[0]
        tail_dev = device_ms(lambda: corr3d.corr3d_tail(*args), 20)
        tail_host = host_ms(lambda: corr3d.corr3d_tail(*args), 20)
        print(f"  corr3d_tail: device {tail_dev:.4f} ms, host {tail_host:.4f} ms a call")
        record("corr3d_tail", "camliflow_torch/csrc/corr3d_tail.cu",
               "camliflow_tpu/ops/pallas_corr3d.py:729", err,
               time_ms(lambda: corr3d.corr3d_tail(*args), 50),
               time_ms(lambda: corr3d.corr3d_tail_plain(*args), 20),
               2 * m * (n_sel // m * (4 * c1 + c1 * c1) + len(sizes) * c1 * 128),
               4 * (2 * m * 3 + 2 * n_sel + sum(t.numel() for t in tail) + m * 128),
               device_ms=tail_dev, host_ms=tail_host)

    # CLFM at the flagship's corr (324, 128) and motion (128, 128) widths:
    # the 1/8 map against the loop's 2048 projected points
    hw = feat_h * feat_w
    for c2, c3 in ((324, 128), (128, 128)):
        block = CLFM(c2, 128).eval()
        random_weights(block, SEED + 10)
        block = block.to(device)
        with torch.inference_mode():
            cache = fusion_interp_cache(uv[:1].contiguous(), feat_h, feat_w)
            inputs = (torch.randn(1, feat_h, feat_w, c2, generator=gen, device=device),
                      torch.randn(1, m, c3, generator=gen, device=device),
                      clfm.hoist_interp_score(block.interp, cache[1]), cache[0],
                      *clfm.grid_sample_cache(uv[:1], feat_h, feat_w))
            params = clfm.prepare_clfm_params(block)
            got_2d, got_3d = clfm.clfm_fused(*inputs, params)
            ref_2d, ref_3d = clfm.clfm_fused_plain(*inputs, params)
            err = max(check("clfm out_2d", got_2d, ref_2d), check("clfm out_3d", got_3d, ref_3d))
            for _ in range(2):  # the SK means and heads sum in a fixed order
                again = clfm.clfm_fused(*inputs, params)
                if not (torch.equal(again[0], got_2d) and torch.equal(again[1], got_3d)):
                    raise AssertionError("clfm_fused: two runs give different bits")
            macs = hw * (c3 * c3 + c2 * c2 + c3 * c2) + m * (c2 * c2 + c2 * c3 + c3 * c3)
            heads = sum(params[key].mid.numel() + params[key].out.numel()
                        for key in ("sk_2d", "sk_3d"))
            macs += heads
            weights = sum(params[key].cin * params[key].cout + params[key].cout
                          for key in clfm.DENSE) + heads
            stages = stage_ms(lambda: clfm.clfm_fused(*inputs, params), 20)
            names = ("gather", "dense 1 (a, interp, sm, b3)", "dense 2 (b, a3)", "partial sums",
                     "SK heads", "blend")
            if len(stages) == len(names):
                print(f"  clfm_fused (C2 {c2}, C3 {c3}) device time by stage (profiler): " +
                      ", ".join(f"{label} {ms:.4f} ms" for label, (_, ms) in zip(names, stages)) +
                      f"; total {sum(ms for _, ms in stages):.4f} ms; host "
                      f"{host_ms(lambda: clfm.clfm_fused(*inputs, params), 20):.4f} ms a call")
                print("    kernels: " + ", ".join(k.split("(")[0][-40:] for k, _ in stages))
            else:
                print(f"  clfm_fused: the profiler saw {len(stages)} kernels a call: "
                      f"{[k for k, _ in stages]}")
            record("clfm_fused", "camliflow_torch/csrc/clfm.cu",
                   "camliflow_tpu/ops/pallas_clfm.py:200", err,
                   time_ms(lambda: clfm.clfm_fused(*inputs, params), 20),
                   time_ms(lambda: clfm.clfm_fused_plain(*inputs, params), 20),
                   2 * macs,
                   # maps in and out, score, nn, taps, weights
                   4 * (2 * hw * c2 + 2 * m * c3 + hw * c3 + hw + 8 * m + weights),
                   label=f"clfm_fused (C2 {c2}, C3 {c3})", entry=c2 == 324, tensor_cores=True,
                   stages_ms={label: ms for label, (_, ms) in zip(names, stages)})

    # the k-major gather: PointConv's at the encoder's level 0 ([2, 8192] ->
    # [2, 4096], k=16) and level 1 ([2, 4096] -> [2, 2048]), xyz and
    # [xyz, features] (99 and 131 channels), the upsample's, and CamLiPWC's
    # widest, FlowEstimator3D's first PointConv at level 1 (4096 points
    # among themselves, [xyz, 195 channels]); each held bit for bit to the
    # plain version (with another tree, its gather too) and timed by
    # profiler device time in turns with the other tree's, by events and by
    # host time a call
    enc = [knn.k_nearest_neighbor(both, lv[0], 16), knn.k_nearest_neighbor(lv[0], lv[1], 16)]
    tables = [torch.cat([both, torch.randn(2, N_POINTS, 96, generator=gen, device=device)], -1),
              torch.cat([lv[0], torch.randn(2, N_SAMPLES[0], 128, generator=gen,
                                            device=device)], -1),
              torch.cat([lv[0][:1], torch.randn(1, N_SAMPLES[0], 195, generator=gen,
                                                device=device)], -1)]
    up_idx = knn.k_nearest_neighbor(xyz1, pc1, 3)
    estimator_idx = knn.k_nearest_neighbor(lv[0][:1], lv[0][:1], 16)
    cases = [("level 0 xyz", both, enc[0]), ("level 0", tables[0], enc[0]),
             ("level 1 xyz", lv[0], enc[1]), ("level 1", tables[1], enc[1]),
             ("upsample xyz", xyz1, up_idx), ("upsample flow", flow, up_idx),
             ("estimator level 1", tables[2], estimator_idx)]
    gathers = {"this": gather.gather_points_kmajor}
    if other:
        gathers = {"other": other[4].gather_points_kmajor, **gathers}
    gather_dev, gather_other, gather_bound, gather_host = {}, {}, {}, {}
    for label, data, index in cases:
        ref = gather.gather_points_kmajor_plain(data, index)
        for tree, wrapper in gathers.items():
            if not torch.equal(wrapper(data, index), ref):
                raise AssertionError(f"{tree} tree's gather {label}: not bit-identical to the "
                                     "plain version")
        calls = {tree: lambda fn=wrapper: fn(data, index) for tree, wrapper in gathers.items()}
        times = in_turns(calls, 50, "gather_kmajor")
        hosts = {tree: host_ms(call, 50) for tree, call in calls.items()}
        events = {tree: time_ms(call, 50) for tree, call in calls.items()}
        gather_dev[label], gather_host[label] = mean(times["this"]), hosts["this"]
        if other:
            gather_other[label] = mean(times["other"])
        nbytes = 4 * (data.numel() + index.numel()) + 4 * index.numel() * data.shape[-1]
        gather_bound[label] = bound(0, nbytes)[0]
        batch, m, k = index.shape
        print(f"  gather_points_kmajor {label} {tuple(data.shape)} x {tuple(index.shape)}: plan "
              f"{gather.gather_plan(batch, m, k, 4 * data.shape[-1], sms)}; device "
              f"{gather_dev[label]:.4f} ms{beside(times)}; events " + ", ".join(
                  f"{tree} {ms:.4f}" for tree, ms in events.items()) + " ms; host " + ", ".join(
                  f"{tree} {ms:.4f}" for tree, ms in hosts.items()) + " ms a call; bound "
              f"{gather_bound[label]:.4f} ms", flush=True)
    library_by_call = {}  # the entry's (filled as the loop goes)
    for level, (label, data, index) in enumerate(cases[1:4:2] + cases[6:]):
        # the library call: one advanced indexing, [B, 1, 1] x [B, k, M] -> [B, k, M, C]
        rows = torch.arange(data.shape[0], device=device)[:, None, None]
        if not torch.equal(data[rows, index.transpose(1, 2)],
                           gather.gather_points_kmajor(data, index)):
            raise AssertionError("gather: the library call computes another function")
        library = lambda: data[rows, index.transpose(1, 2)]  # noqa: E731
        library_dev = library_by_call[label] = device_ms(library, 50)
        print(f"  gather_points_kmajor {label}: advanced indexing {library_dev:.4f} ms device",
              flush=True)
        record("gather_points_kmajor", "camliflow_torch/csrc/gather.cu",
               "camliflow_tpu/ops/pallas_gather.py:71", 0.0,
               time_ms(lambda: gather.gather_points_kmajor(data, index), 50),
               time_ms(lambda: gather.gather_points_kmajor_plain(data, index).contiguous(), 20),
               0, 4 * (data.numel() + index.numel()) + 4 * index.numel() * data.shape[-1],
               label=f"gather_points_kmajor {label} (by events)", entry=level == 0,
               library_ms=time_ms(library, 50), library_device_ms=library_dev,
               device_ms=gather_dev[label], host_ms=gather_host[label],
               device_ms_by_call=gather_dev, bound_ms_by_call=gather_bound,
               host_ms_by_call=gather_host, library_device_ms_by_call=library_by_call,
               **({"other_device_ms_by_call": gather_other} if other else {}))

    # tools/probe_gather_matrix.py's twelve cases through the same kernel;
    # each is a B=1, k=1 row gather, which torch.index_select computes. Timed
    # twice: CUDA events around back-to-back calls (host and device), and
    # the profiler's device time of the kernels alone
    probe_ms = probe_plain_ms = probe_library_ms = probe_bytes = 0.0
    probe_dev_ms = probe_library_dev_ms = 0.0
    for case in gather.PROBE_CASES:
        data, index, finish, want = gather.probe_case(case, gen, device)
        got = finish(gather.gather_points_kmajor(data, index))
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"probe case {case[0]}: not bit-identical to torch indexing")
        ms = time_ms(lambda: gather.gather_points_kmajor(data, index), 20)
        library_ms = time_ms(lambda: torch.index_select(data[0], 0, index[0, :, 0]), 20)
        dev_ms = device_ms(lambda: gather.gather_points_kmajor(data, index), 20)
        library_dev_ms = device_ms(lambda: torch.index_select(data[0], 0, index[0, :, 0]), 20)
        print(f"    probe {case[0]}: kernel {ms:.4f} ms (device {dev_ms:.4f})  index_select "
              f"{library_ms:.4f} ms (device {library_dev_ms:.4f})")
        probe_ms += ms
        probe_library_ms += library_ms
        probe_dev_ms += dev_ms
        probe_library_dev_ms += library_dev_ms
        probe_plain_ms += time_ms(lambda: gather.gather_points_kmajor_plain(data, index)
                                  .contiguous(), 20)
        probe_bytes += (data.numel() + index.numel() * data.shape[-1]) * data.element_size()
        probe_bytes += 4 * index.numel()
    record("probe_gather_matrix (12 cases, summed)", "camliflow_torch/csrc/gather.cu",
           "tools/probe_gather_matrix.py:91", 0.0, probe_ms, probe_plain_ms, 0, probe_bytes,
           wrapper="gather_points_kmajor", library_ms=probe_library_ms,
           device_ms=probe_dev_ms, library_device_ms=probe_library_dev_ms)
    print(f"  probe device time (profiler, 12 cases summed): kernel {probe_dev_ms:.4f} ms, "
          f"index_select {probe_library_dev_ms:.4f} ms", flush=True)
    return results


def drive(name, evaluator, batches, wrappers, card) -> dict:
    """1 warm-up and 3 requests through the Evaluator's run_things (one batch
    ahead), then the same 3 requests each through `forward` for their own
    times; the launch counts of run_things' 3 requests (counters zeroed just
    before them)."""
    import torch

    evaluator.run_things(batches[:1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evaluator.request_ms.clear()
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    metrics = evaluator.run_things(batches[1:])  # one batch ahead
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {key: fn.launches for key, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = 1e3 * seconds / 3
    evaluator.request_ms.clear()
    for batch in batches[1:]:  # each request alone, start to finish
        evaluator.forward(batch)
    requests = ", ".join(f"{t:.3f}" for t in evaluator.request_ms)
    shown = " | ".join(f"{k} {v:.6f}" for k, v in metrics.items() if k.startswith("EPE"))
    print(f"  {name}: {shown} | {ms:.3f} ms per frame pair | {1e3 / ms:.3f} "
          f"frame-pairs/s | requests [{requests}] ms, median "
          f"{np.median(evaluator.request_ms):.3f} | peak {peak:.1f} MiB | {card}")
    print(f"  {name} launches over the 3 requests:", launches, flush=True)
    return launches


def stack(batches: list[dict]) -> dict:
    """bs=1 frame pairs as one batch, in order."""
    return {key: np.concatenate([b[key] for b in batches]) for key in batches[0]}


def drive_batch(name, evaluator, images, wrappers, per_request, card) -> dict:
    """The eval CLI's batch: BATCH frame pairs made as frame_pair makes them,
    each first run alone on the card, then one warm-up and one timed
    request of all of them, and a profiled one. Every kernel's launches in
    the timed request (counters zeroed just before it) must equal a bs=1
    request's, and each sample's output must lie within phase 5's envelope
    of the same sample run alone. Returns the launches."""
    import torch

    batches = [frame_pair(SEED + 20 + i, i, images) for i in range(BATCH)]
    alone = [evaluator.forward(b) for b in batches]
    batch = stack(batches)
    evaluator.forward(batch)  # warm-up at this batch's shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    out = evaluator.forward(batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - start)
    launches = {key: fn.launches for key, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    deltas = {}
    for key, tol, unit in (("flow_3d", FLOW_3D_TOL, "m"), ("flow_2d", FLOW_2D_TOL, "px")):
        if key not in out:
            continue
        check_output(out, key, (BATCH,) + alone[0][key].shape[1:])
        deltas[key] = max(float(np.abs(out[key][i] - alone[i][key][0]).max())
                          for i in range(BATCH))
        if not deltas[key] <= tol:
            raise AssertionError(f"bs={BATCH}: a sample's {key} differs from the same sample "
                                 f"alone by {deltas[key]} {unit} > {tol}")
    wall, busy, total = profile_request(evaluator, batch, top=5)
    print(f"  {name} bs={BATCH}: request {ms:.3f} ms ({ms / BATCH:.3f} ms a frame pair), "
          f"profiled {wall:.3f} ms wall, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), {total} kernel launches; peak {peak:.1f} MiB; max "
          "|sample - alone| " + ", ".join(f"{k} {d:.3e}" for k, d in deltas.items()) +
          f" | {card}", flush=True)
    got = {k: launches[k] for k in per_request}
    if got != per_request:
        raise AssertionError(f"bs={BATCH} launches per request {got}, expected {per_request}")
    print(f"  {name} bs={BATCH} launches in the request:", launches, flush=True)
    return launches


def check_output(out: dict, key: str, shape: tuple) -> np.ndarray:
    value = out[key]
    if value.shape != shape or not np.isfinite(value).all():
        raise AssertionError(f"bad {key}: shape {value.shape}, finite {np.isfinite(value).all()}")
    return value


KITTI_P2 = (721.5377, 0.0, 609.5593, 44.85728, 0.0, 721.5377, 172.854, 0.2163791,
            0.0, 0.0, 1.0, 0.002745884)  # KITTI's P_rect_02 (2011_09_26 calibration)
KITTI_H, KITTI_W = 375, 1242  # a KITTI image; the reader pads it to 376 x 1242
KITTI_FRAMES = 8
WORK = "build/chip_smoke"  # under the checkout's ignored build/


def kitti_disparity(rng, shift: float) -> np.ndarray:
    """A road-like disparity map at KITTI's focal length and 0.54 m baseline:
    depth from 70 m at row 110 down to 3 m at the bottom row, less `shift`
    (frame 2: the car moved forward), boxes of nearer objects, far sky above
    row 100, noise, and 2% of the pixels invalid (0)."""
    rows = np.arange(KITTI_H, dtype=np.float32)[:, None] * np.ones((1, KITTI_W), np.float32)
    depth = 70.0 * (3.0 / 70.0) ** np.clip((rows - 110) / (KITTI_H - 1 - 110), 0, 1) - shift
    for x0, y0, z in ((200, 150, 12.0), (700, 170, 25.0), (1000, 140, 8.0)):
        depth[y0:y0 + 80, x0:x0 + 150] = np.minimum(depth[y0:y0 + 80, x0:x0 + 150], z - shift)
    disp = 0.54 * KITTI_P2[0] / depth + 0.2 * rng.rand(KITTI_H, KITTI_W)
    disp[:100] = 0.54 * KITTI_P2[0] / 150.0
    disp[rng.rand(KITTI_H, KITTI_W) < 0.02] = 0.0
    return disp.astype(np.float32)


def write_kitti_split(root) -> None:
    """A synthetic KITTI testing split of KITTI_FRAMES frames at 375 x 1242,
    written with the port's own PNG encoder: calib_cam_to_cam (KITTI's
    P_rect_02), image_2 (both frames) and disp_ganet (both frames)."""
    import os

    from camliflow_torch.data import io
    from camliflow_torch.data.png import write_png

    base = os.path.join(root, "testing")
    for sub in ("calib_cam_to_cam", "image_2", "disp_ganet"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.RandomState(SEED + 40)
    cols = np.arange(KITTI_W)[None, :, None]
    for i in range(KITTI_FRAMES):
        with open(os.path.join(base, "calib_cam_to_cam", "%06d.txt" % i), "w") as f:
            f.write("P_rect_02: " + " ".join(f"{v:e}" for v in KITTI_P2) + "\n")
        for suffix, shift in (("10", 0.0), ("11", 1.0)):
            image = (rng.randint(0, 60, (KITTI_H, KITTI_W, 3)) + (cols + 40 * i) % 190)
            write_png(os.path.join(base, "image_2", "%06d_%s.png" % (i, suffix)),
                      image.astype(np.uint8))
            io.save_disp_png(os.path.join(base, "disp_ganet", "%06d_%s.png" % (i, suffix)),
                             kitti_disparity(rng, shift))


def write_pfm(path, image: np.ndarray) -> None:
    """A greyscale little-endian PFM, bottom row first."""
    with open(path, "wb") as f:
        f.write(b"Pf\n%d %d\n-1.0\n" % (image.shape[1], image.shape[0]))
        np.flipud(image).astype("<f4").tofile(f)


def profiled(fn) -> tuple[float, float]:
    """fn() under torch.profiler: (wall ms, device busy ms)."""
    wall, kernels = profile_kernels(fn)
    return wall, sum(e.self_device_time_total for e in kernels) / 1e3


def host_syncs(fn) -> list[str]:
    """The places where fn() made the host wait for the card, from
    torch.cuda.set_sync_debug_mode("warn"): file:line (repo-relative) and
    the warning, with their counts."""
    import collections
    import os
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}: {str(w.message).splitlines()[0][:70]}"
        for w in caught if "called a synchronizing" in str(w.message))
    return [f"{count}x {site}" for site, count in sites.most_common()]


def lookahead_phase(device, card) -> None:
    """The flagship over 4 batches of BATCH in-memory frame pairs through
    run_things: with the Evaluator's one-batch lookahead and with a
    synchronous loop over forward, in turns (lookahead, synchronous,
    synchronous, lookahead). Outputs and metrics bit for bit equal; wall
    time per batch of each run and each loop's device busy share by
    profiler; the host's time to issue one forward (enqueue) and to reduce
    one batch's metrics; the places where one forward makes the host
    wait."""
    import torch

    from camliflow_torch.models.camliraft import CamLiRAFT
    from camliflow_torch.runtime.checkpoint import random_weights
    from camliflow_torch.runtime.evaluator import Evaluator

    model = CamLiRAFT(FLAGSHIP_CFGS)
    random_weights(model, SEED)
    ev = Evaluator(model, device)
    data = [stack([frame_pair(SEED + 60 + 8 * j + i, 8 * j + i, True) for i in range(BATCH)])
            for j in range(4)]
    ev.forward(data[0])  # warm-up at this batch's shapes
    torch.cuda.synchronize()
    lookahead = ev.batches

    def synchronous(loader):
        for batch in loader:
            yield batch, ev.forward(batch)

    loops = {"lookahead": lookahead, "synchronous": synchronous}
    runs = {name: [] for name in loops}
    for name in ("lookahead", "synchronous", "synchronous", "lookahead"):
        seen = []

        def recording(loader, loop=loops[name], seen=seen):
            for batch, out in loop(loader):
                seen.append(out)
                yield batch, out

        ev.batches = recording
        start = time.perf_counter()
        metrics = ev.run_things(data)
        torch.cuda.synchronize()
        runs[name].append((1e3 * (time.perf_counter() - start) / len(data), seen, metrics))
    busy = {}
    for name, loop in loops.items():
        ev.batches = loop
        busy[name] = profiled(lambda: ev.run_things(data))
    ev.batches = lookahead
    for name, results in runs.items():
        wall, share = busy[name][0], 100 * busy[name][1] / busy[name][0]
        print(f"  {name}: " + ", ".join(f"{ms:.3f}" for ms, _, _ in results) +
              f" ms a batch of {BATCH} ({len(data)} batches a run); profiled {wall:.3f} ms "
              f"wall, device busy {busy[name][1]:.3f} ms ({share:.1f}%) | {card}", flush=True)
    reference = runs["synchronous"][0]
    for name, results in runs.items():
        for _, seen, metrics in results:
            if len(seen) != len(reference[1]) or any(
                    set(a) != set(b) or any(not np.array_equal(a[k], b[k]) for k in a)
                    for a, b in zip(seen, reference[1])):
                raise AssertionError(f"{name}: outputs differ from the synchronous loop's")
            if metrics != reference[2]:
                raise AssertionError(f"{name}: metrics {metrics} differ from {reference[2]}")
    print(f"  every run's outputs and metrics bit for bit the same: {reference[2]}")
    start = time.perf_counter()
    pending = ev.enqueue(data[0])
    issued = time.perf_counter()
    outputs = ev.fetch(pending)
    fetched = time.perf_counter()
    ev.batches = lambda loader: zip(loader, [outputs] * len(data))
    start_metrics = time.perf_counter()
    ev.run_things(data)
    metrics_ms = 1e3 * (time.perf_counter() - start_metrics) / len(data)
    ev.batches = lookahead
    print(f"  one batch: the host issues its forward in {1e3 * (issued - start):.3f} ms, its "
          f"outputs are on the host {1e3 * (fetched - start):.3f} ms after the start; the "
          f"host's metric sums {metrics_ms:.3f} ms a batch | {card}", flush=True)
    sites = host_syncs(lambda: ev.enqueue(data[0]))
    print(f"  host syncs in one enqueued forward (set_sync_debug_mode): {len(sites)} places")
    for site in sites:
        print(f"    {site}")


def map_kernels_2d(device, feat_h: int, feat_w: int) -> dict[str, float]:
    """#9, #8 and #11 (corr widths) at a 1/8 map of feat_h x feat_w against
    their plain versions (CONV_TOL), with phase 3's weight seeds: ms a call
    by CUDA events, by wrapper. Not by profiler: on the H100 its profiles of
    these calls kept a varying share of their launches, no two alike."""
    import torch
    from torch import nn

    from camliflow_torch.models.raft import FlowHead2D, GRU2D, MotionEncoder2D
    from camliflow_torch.nn.clfm import CLFM, fusion_interp_cache
    from camliflow_torch.ops import clfm, update2d
    from camliflow_torch.runtime.checkpoint import random_weights

    gen = torch.Generator(device=device).manual_seed(SEED)
    blocks = nn.ModuleList([MotionEncoder2D(), GRU2D(), FlowHead2D()])
    random_weights(blocks, SEED + 7)
    encoder, gru, head = blocks.to(device)
    block = CLFM(324, 128).eval()
    random_weights(block, SEED + 10)
    block = block.to(device)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=device)

    def check(name, got, ref):
        err = float((got - ref).abs().max())
        if not err <= CONV_TOL * (1.0 + float(ref.abs().max())):
            raise AssertionError(f"{name} at {feat_h}x{feat_w}: max |d| {err}")

    shape = (1, feat_h, feat_w)
    times = {}
    with torch.inference_mode():
        flow2d, corr = rand(*shape, 2, scale=2.0), rand(*shape, 324)
        me = update2d.prepare_motion_encoder_params(encoder)
        check("motion_encoder_2d", update2d.motion_encoder_2d(flow2d, corr, me),
              update2d.motion_encoder_2d_plain(flow2d, corr, me))
        times["motion_encoder_2d"] = time_ms(
            lambda: update2d.motion_encoder_2d(flow2d, corr, me), 20)
        h, x2d, motion = torch.tanh(rand(*shape, 128)), torch.relu(rand(*shape, 128)), \
            rand(*shape, 128)
        gf = update2d.prepare_gru_flowhead_params(gru, head)
        got, ref = (update2d.gru_flowhead_2d(h, x2d, motion, gf),
                    update2d.gru_flowhead_2d_plain(h, x2d, motion, gf))
        check("gru_flowhead_2d h'", got[0], ref[0])
        check("gru_flowhead_2d delta", got[1], ref[1])
        times["gru_flowhead_2d"] = time_ms(
            lambda: update2d.gru_flowhead_2d(h, x2d, motion, gf), 20)
        m = N_SAMPLES[1]
        uv = (torch.rand(1, m, 2, generator=gen, device=device)
              * torch.tensor([feat_w - 1.0, feat_h - 1.0], device=device)).contiguous()
        cache = fusion_interp_cache(uv, feat_h, feat_w)
        inputs = (rand(*shape, 324), rand(1, m, 128),
                  clfm.hoist_interp_score(block.interp, cache[1]), cache[0],
                  *clfm.grid_sample_cache(uv, feat_h, feat_w))
        params = clfm.prepare_clfm_params(block)
        got, ref = clfm.clfm_fused(*inputs, params), clfm.clfm_fused_plain(*inputs, params)
        check("clfm out_2d", got[0], ref[0])
        check("clfm out_3d", got[1], ref[1])
        times["clfm_fused"] = time_ms(lambda: clfm.clfm_fused(*inputs, params), 20)
    return times


def submission_phase(device, wrappers, per_request, card, kernels) -> dict:
    """The KITTI submission on the card: a synthetic testing split of
    KITTI_FRAMES frames at 375 x 1242, the flagship at full width with
    seeded random weights, bs=8, 8192 points, configured as
    `python -m camliflow_torch.kitti_submission model=camliraft` configures
    it. One warm-up run, then a timed one with every wrapper's launches
    counted (one request of 8 frames, plus a densification a frame). Holds
    the files' shapes, #3 at the densify shape against its chunked plain
    version, one frame against the CPU, and #1 at the same shape. Returns
    the launches of the timed run."""
    import os
    import shutil

    import torch

    from camliflow_torch import kitti_submission
    from camliflow_torch.data import io
    from camliflow_torch.data.datasets import KITTITest, collate
    from camliflow_torch.data.png import read_png
    from camliflow_torch.models.camliraft import CamLiRAFT
    from camliflow_torch.ops import interp, knn
    from camliflow_torch.runtime.checkpoint import random_weights
    from camliflow_torch.runtime.evaluator import Evaluator
    from camliflow_torch.runtime.submission import SubmissionWriter, over_query_chunks

    root = os.path.join(WORK, "kitti")
    shutil.rmtree(root, ignore_errors=True)
    start = time.perf_counter()
    write_kitti_split(root)
    print(f"  wrote {KITTI_FRAMES} synthetic KITTI frames in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    cfgs, _ = kitti_submission.configure(["model=camliraft", f"testset.root_dir={root}"])
    model = CamLiRAFT(cfgs.model.to_dict())
    random_weights(model, SEED)
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    length = KITTITest.__len__
    KITTITest.__len__ = lambda self: KITTI_FRAMES  # the split's first 8 frames
    try:
        writer = SubmissionWriter(cfgs, model, device)
        out_root = os.path.join(WORK, "submission")
        writer.run(out_root)  # warm-up at KITTI's shapes
        torch.cuda.synchronize()
        writer.frame_ms = {key: [] for key in writer.frame_ms}
        for fn in wrappers.values():
            fn.launches = 0
        start = time.perf_counter()
        writer.run(out_root)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - start)
        launches = {key: fn.launches for key, fn in wrappers.items()}
    finally:
        KITTITest.__len__ = length
    expected = {**per_request, "knn_interpolation": per_request["knn_interpolation"]
                + KITTI_FRAMES}
    got = {k: launches[k] for k in expected}
    if got != expected:
        raise AssertionError(f"submission launches {got}, expected {expected} (one flagship "
                             f"request and a densification a frame)")
    shapes = {"disp_0": ((KITTI_H, KITTI_W), np.uint16),
              "flow_initial": ((KITTI_H, KITTI_W, 3), np.uint16),
              "disp_1_initial": ((KITTI_H, KITTI_W), np.uint16),
              "occ": ((KITTI_H, KITTI_W), np.uint8)}
    for sub, (shape, dtype) in shapes.items():
        for i in range(KITTI_FRAMES):
            image = read_png(os.path.join(out_root, "testing", sub, "%06d_10.png" % i))
            if image.shape != shape or image.dtype != dtype:
                raise AssertionError(f"{sub}/{i}: {image.dtype} {image.shape}, expected "
                                     f"{dtype.__name__} {shape}")
    # the split per frame: the forward of the batch (synchronous, again),
    # reading a frame, the densification, the files
    dataset = KITTITest(cfgs.testset)
    start = time.perf_counter()
    samples = [dataset[i] for i in range(KITTI_FRAMES)]
    read_ms = 1e3 * (time.perf_counter() - start) / KITTI_FRAMES
    evaluator = writer.evaluator
    evaluator.request_ms.clear()
    evaluator.forward(collate(samples))
    forward_ms = evaluator.request_ms[-1] / KITTI_FRAMES
    densify_ms = float(np.mean(writer.frame_ms["densify"]))
    files_ms = float(np.mean(writer.frame_ms["files"]))
    print(f"  submission: {wall / KITTI_FRAMES:.3f} ms a frame ({wall:.3f} ms for "
          f"{KITTI_FRAMES}, one batch); split a frame: forward {forward_ms:.3f} (a bs={BATCH} "
          f"request / {BATCH}), reading {read_ms:.3f}, densify {densify_ms:.3f}, files "
          f"{files_ms:.3f} ms | {card}", flush=True)
    print(f"  submission launches: {launches}", flush=True)

    # one frame alone: the card against the CPU (phase 5's envelope)
    frame = collate(samples[:1])
    out = evaluator.forward(frame)
    pad_h, pad_w = frame["images"].shape[1:3]  # the reader's zero padding, 376 x 1242
    for key, shape in (("flow_3d", (1, cfgs.testset.n_points, 3)),
                       ("flow_2d", (1, pad_h, pad_w, 2))):
        check_output(out, key, shape)
    cpu_model = CamLiRAFT(cfgs.model.to_dict())
    cpu_model.load_state_dict(cpu_state)
    ref = Evaluator(cpu_model, "cpu").forward(frame)
    for key, tol, unit in (("flow_3d", FLOW_3D_TOL, "m"), ("flow_2d", FLOW_2D_TOL, "px")):
        delta = float(np.abs(out[key] - ref[key]).max())
        print(f"  KITTI frame 0 max|d{key}| {delta:.3e} {unit} (bound {tol}), |{key}| up to "
              f"{np.abs(ref[key]).max():.3f} {unit}", flush=True)
        if not delta <= tol:
            raise AssertionError(f"KITTI frame 0: CUDA vs CPU max |d{key}| {delta} > {tol}")

    # #3 at the densify shape: [1, 375 * 1242] queries <- [1, 8192] supports
    f, cx, cy = (float(v) for v in frame["intrinsics"][0])
    disp1 = io.load_disp_png(os.path.join(root, "testing", "disp_ganet", "000000_10.png"))[0]
    queries = io.disp2pc(disp1, baseline=0.54, f=f, cx=cx, cy=cy).reshape(1, -1, 3)
    query = torch.as_tensor(queries.astype(np.float32), device=device).contiguous()
    support = torch.as_tensor(frame["pcs"][:, :, :3], device=device).contiguous()
    feats = torch.as_tensor(out["flow_3d"], device=device).contiguous()
    n, m = query.shape[1], support.shape[1]

    def chunked(fn):  # the plain version's dense [1, 32768, M] distances and their sort
        return over_query_chunks(fn, query, 32768)

    got = interp.knn_interpolation(support, feats, query, 3)
    start = time.perf_counter()
    ref = chunked(lambda q: interp.knn_interpolation_plain(support, feats, q, 3))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - start)
    err = float((got - ref).abs().max())
    if not err <= INTERP_TOL:
        raise AssertionError(f"interp densify: max |d| {err}")
    index = torch.arange(float(m), device=device)[None, :, None].contiguous()
    picked = interp.knn_interpolation(support, index, query, 1)[..., 0].int()
    nearest = chunked(lambda q: knn.k_nearest_neighbor_plain(support, q, 1))[..., 0]
    if not torch.equal(picked, nearest):
        raise AssertionError("interp densify: k=1 selects other supports than the plain KNN")
    if not torch.equal(knn.k_nearest_neighbor(support, query, 3),
                       chunked(lambda q: knn.k_nearest_neighbor_plain(support, q, 3))):
        raise AssertionError("KNN at the densify shape: indices differ from the plain version")
    call = lambda: interp.knn_interpolation(support, feats, query, 3)  # noqa: E731
    dev = device_ms(call, 5, only="interp_kernel", per_call=1)
    events = time_ms(call, 5)
    pairs = n * m
    bound_ms = bound(pairs * 9 + n * 3 * (12 + 2 * 3), 4 * (m * 3 * 2 + n * 3 * 2))[0]
    print(f"  knn_interpolation densify [1,{n}] <- [1,{m}], k=3, C=3: plan "
          f"{knn.select_plan(1, n, m, 3, torch.cuda.get_device_properties(device).multi_processor_count)}"
          f"; device {dev:.4f} ms, events {events:.4f} ms, chunked plain "
          f"{plain_ms:.1f} ms; "
          f"bound {bound_ms:.4f} ms ({pairs:.3e} pairs; 8 flops a pair without the compare: "
          f"{1e3 * pairs * 8 / PEAK_F32:.4f} ms); max |d| {err:.3g}; the k=1 pick and #1's "
          f"k=3 indices bit for bit | {card}", flush=True)
    for entry in kernels:
        if entry["name"] == "knn_interpolation":
            entry.update(densify_device_ms=dev, densify_ms=events, densify_plain_ms=plain_ms,
                         densify_bound_ms=bound_ms, densify_max_abs_err=err)

    # #9, #8 and #11 at KITTI's 1/8 map beside the bench's
    feat = (-(-pad_h // 8), -(-pad_w // 8))
    here, bench = map_kernels_2d(device, *feat), map_kernels_2d(device, 68, 120)
    print(f"  at the {feat[0]}x{feat[1]} map ({feat[0] * feat[1]} px) against 68x120 (8160 px), "
          "ms a call by events: " + ", ".join(f"{k} {here[k]:.4f} / {bench[k]:.4f}" for k in here),
          flush=True)
    for entry in kernels:
        if entry["name"] in here and entry["wrapper"] == entry["name"]:
            entry.update(ms_47x156=here[entry["name"]], ms_68x120=bench[entry["name"]])
    return launches


def demo_phase(device, wrappers, per_request, card) -> dict:
    """camliflow_torch.demo on a synthetic 960 x 540 pair with PFM
    disparities (5-30 m at the demo's f = 1050 px, baseline 1 m): the
    flagship (conf/model/camliraft.yaml) on the card with seeded random
    weights, its launches counted (one request), then on the CPU; flow_3d
    and flow_2d within phase 5's envelope. Returns the card run's
    launches."""
    import os

    import torch

    from camliflow_torch import demo
    from camliflow_torch.data.png import read_png, write_png

    root = os.path.join(WORK, "demo")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(SEED + 50)
    rows = np.arange(IMAGE_H, dtype=np.float32)[:, None] * np.ones((1, IMAGE_W), np.float32)
    for i in (1, 2):
        image = rng.randint(0, 60, (IMAGE_H, IMAGE_W, 3)) + (np.arange(IMAGE_W)[None, :, None]
                                                            + 7 * i) % 190
        write_png(os.path.join(root, f"image{i}.png"), image.astype(np.uint8))
        depth = 30.0 - 25.0 * rows / (IMAGE_H - 1) - 0.3 * i
        write_pfm(os.path.join(root, f"disp{i}.pfm"),
                  -(INTRINSICS[0] / depth + 0.2 * rng.rand(IMAGE_H, IMAGE_W)))
    args = ["--image1", f"{root}/image1.png", "--image2", f"{root}/image2.png",
            "--disp1", f"{root}/disp1.pfm", "--disp2", f"{root}/disp2.pfm"]
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    out = demo.main(demo.parse_args(args + ["--out_dir", f"{root}/cuda"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {key: fn.launches for key, fn in wrappers.items()}
    got = {k: launches[k] for k in per_request}
    if got != per_request:
        raise AssertionError(f"demo launches {got}, expected {per_request}")
    picture = read_png(f"{root}/cuda/flow_2d.png")
    if picture.shape != (3 * IMAGE_H, IMAGE_W, 3) or picture.dtype != np.uint8:
        raise AssertionError(f"demo flow_2d.png: {picture.dtype} {picture.shape}")
    saved = np.load(f"{root}/cuda/flow_3d.npz")
    if not np.array_equal(saved["flow_3d"], out["flow_3d"][0]):
        raise AssertionError("demo flow_3d.npz holds another flow than the run's")
    ref = demo.main(demo.parse_args(args + ["--out_dir", f"{root}/cpu", "--device", "cpu"]))
    for key, tol, unit in (("flow_3d", FLOW_3D_TOL, "m"), ("flow_2d", FLOW_2D_TOL, "px")):
        check_output(out, key, ref[key].shape)
        delta = float(np.abs(out[key] - ref[key]).max())
        print(f"  demo max|d{key}| {delta:.3e} {unit} (bound {tol}), |{key}| up to "
              f"{np.abs(ref[key]).max():.3f} {unit}")
        if not delta <= tol:
            raise AssertionError(f"demo: CUDA vs CPU max |d{key}| {delta} > {tol}")
    print(f"  demo on the card: {seconds:.1f} s (model built, random weights, one request, "
          f"files); launches {launches} | {card}", flush=True)
    return launches


class IndexOnly:
    """#4's index-only launches (`correlation3d_knn(..., with_cost=False)`),
    which the wrapper counts beside its full form's, under the `launches`
    name every other counter has."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    @property
    def launches(self) -> int:
        return self.wrapper.index_launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.wrapper.index_launches = value


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name, each with its `launches`
    counter (a process's own: phase 10's ranks build theirs)."""
    from camliflow_torch.ops import clfm, corr3d, fps, gather, interp, knn, update2d, update3d

    return {"k_nearest_neighbor": knn.k_nearest_neighbor,
            "furthest_point_sampling": fps.furthest_point_sampling,
            "knn_interpolation": interp.knn_interpolation,
            "correlation3d_knn": corr3d.correlation3d_knn,
            "motion_encoder_2d": update2d.motion_encoder_2d,
            "gru_flowhead_2d": update2d.gru_flowhead_2d,
            "gru_2d": update2d.gru_2d,
            "flow_head_2d": update2d.flow_head_2d,
            "update_2d": update2d.update_2d,
            "motion_encoder_3d": update3d.motion_encoder_3d,
            "gru_flowhead_3d": update3d.gru_flowhead_3d,
            "corr3d_tail": corr3d.corr3d_tail,
            "clfm_fused": clfm.clfm_fused,
            "gather_points_kmajor": gather.gather_points_kmajor,
            "dw_max": update3d.dw_max,
            "correlation3d_knn_index": IndexOnly(corr3d.correlation3d_knn)}


TRAIN_PAIRS = 8  # frame pairs of the synthetic training split
TRAIN_POINTS = 10000  # points a cloud (the reader samples 8192 of them)
TRAIN_BATCH = 2
TRAIN_ITERS = 10  # conf/model/camliraft.yaml n_iters_train
LOSS_TOL = 1e-4  # relative, the f32 train step's loss on the card against the CPU
GRAD_TOL = 1e-3  # max|dg| <= GRAD_TOL * (1 + max|g_cpu|), each parameter
PARAM_TOL = 1e-5  # the parameters after the step, absolute, where the gradients agree in sign
RESUME_TOL = 1e-5  # relative, the first loss after a resume against the straight run


def write_things_split(root, split: str, pairs: int, seed: int) -> None:
    """A FlyingThings3D-prep split in tools/make_synthetic_dataset.py's
    layout (image_clean, flow_2d, flow_3d, pc, occ_mask_3d; pair i is frames
    2i and 2i + 1), at 960 x 540 with TRAIN_POINTS points a cloud inside
    the camera's view (f 1050, 5-35 m), written with the port's writers."""
    import os

    from camliflow_torch.data.io import save_flow_png
    from camliflow_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    base = os.path.join(root, split)
    for sub in ("image_clean", "flow_2d", "flow_3d", "pc", "occ_mask_3d"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    f, cx, cy = INTRINSICS
    ramp = (np.arange(IMAGE_W)[None, :, None] + np.arange(IMAGE_H)[:, None, None]) % 200
    for i in range(pairs):
        first = 2 * i
        for j in (first, first + 1):
            image = rng.randint(0, 55, (IMAGE_H, IMAGE_W, 3)) + (ramp + 5 * j) % 200
            write_png(os.path.join(base, "image_clean", "%07d.png" % j), image.astype(np.uint8))
        flow_2d = (3 * rng.randn(IMAGE_H, IMAGE_W, 2)).astype(np.float32)
        save_flow_png(os.path.join(base, "flow_2d", "%07d.png" % first), flow_2d,
                      (rng.rand(IMAGE_H, IMAGE_W) > 0.1).astype(np.float32))
        depth = rng.uniform(5.0, 35.0, TRAIN_POINTS)
        u, v = rng.uniform(0, IMAGE_W - 1, TRAIN_POINTS), rng.uniform(0, IMAGE_H - 1, TRAIN_POINTS)
        pc1 = np.stack([(u - cx) * depth / f, (v - cy) * depth / f, depth], -1).astype(np.float32)
        pc2 = (pc1 + 0.1 * rng.randn(TRAIN_POINTS, 3)).astype(np.float32)
        np.savez(os.path.join(base, "pc", "%07d.npz" % first), pc1=pc1, pc2=pc2)
        np.save(os.path.join(base, "flow_3d", "%07d.npy" % first), pc2 - pc1)
        np.save(os.path.join(base, "occ_mask_3d", "%07d.npy" % first),
                np.packbits(rng.rand(TRAIN_POINTS) > 0.9))


def training_phase(device, wrappers, card) -> dict:
    """Phase 9: `python -m camliflow_torch.train trainset=flyingthings3d_subset
    valset=flyingthings3d_subset model=camliraft`'s Trainer on the card at
    the flagship's full width (conf/model/camliraft.yaml and
    conf/training/flyingthings3d_subset/camliraft.yaml: ResNet-50 to stage
    2, 960x540, 8192 points, 10 iterations, amp, augmentation on), batches
    of 2, on a synthetic FlyingThings3D-prep set of 8 pairs: epoch 0 (its
    first step the warm-up), epoch 1 timed with every counter zeroed just
    before it (launches held: #1-#4 at their counts a step, #4 only in its
    index-only form, #5-#13 never), one step profiled, a validation pass, a
    checkpoint saved and resumed; every step's loss finite and both branch
    gradient norms finite and > 0. Then, augmentation off, a run resumed
    after epoch 0 against the run that went on (first loss within
    RESUME_TOL), and one f32 step at batch 1 and 2 iterations on the card
    against the same step on the CPU. Returns the timed epoch's launches."""
    import copy
    import os
    import shutil

    import torch

    from camliflow_torch.data.datasets import collate, dataset_factory
    from camliflow_torch.models.camliraft import loss_fn
    from camliflow_torch.models.factory import model_factory, optimizer_factory
    from camliflow_torch.runtime.trainer import Trainer, device_batch
    from camliflow_torch.runtime.train_state import train_step
    from camliflow_torch.utils.config import compose

    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    start = time.perf_counter()
    write_things_split(os.path.join(root, "data"), "train", TRAIN_PAIRS, SEED + 70)
    write_things_split(os.path.join(root, "data"), "val", 4, SEED + 71)
    print(f"  wrote {TRAIN_PAIRS} + 4 pairs at {IMAGE_W}x{IMAGE_H}, {TRAIN_POINTS} points a "
          f"cloud in {time.perf_counter() - start:.1f} s", flush=True)

    def cfgs(name, *extra):
        return compose("conf", trainset="flyingthings3d_subset", valset="flyingthings3d_subset",
                       model="camliraft", base="trainer.yaml", overrides=[
                           f"trainset.root_dir={root}/data", f"valset.root_dir={root}/data",
                           f"model.batch_size={TRAIN_BATCH}", "training.epochs=2",
                           f"log.dir={root}/{name}", "log.print_interval=1",
                           "log.val_interval=100", "trainset.n_workers=4",
                           "valset.n_workers=4", *extra])

    main_cfgs = cfgs("run")
    if not (main_cfgs.model.n_iters_train == TRAIN_ITERS and main_cfgs.training.amp
            and main_cfgs.trainset.augmentation.enabled and main_cfgs.trainset.n_points == N_POINTS
            and main_cfgs.model.backbone.depth == 50):
        raise AssertionError("the composed config is not the flagship's training config")
    def check_steps(history):
        for record in history:
            if not (np.isfinite(record["loss"]) and all(
                    np.isfinite(record[k]) and record[k] > 0 for k in ("grad_norm_2d",
                                                                       "grad_norm_3d"))):
                raise AssertionError(f"training step {record}: a loss or gradient norm is not "
                                     "finite, or a branch's gradient is 0")
        return history

    trainer = Trainer(main_cfgs, device)
    steps = len(trainer.train_loader)
    start = time.perf_counter()
    trainer.train_one_epoch(0)
    torch.cuda.synchronize()
    first_epoch = time.perf_counter() - start
    records = check_steps(trainer.history)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    trainer.train_one_epoch(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {key: fn.launches for key, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    per_step = {key: count / steps for key, count in launches.items()}
    want = {**dict.fromkeys(wrappers, 0), "k_nearest_neighbor": 8,
            "furthest_point_sampling": 1, "knn_interpolation": TRAIN_ITERS,
            "correlation3d_knn_index": TRAIN_ITERS}
    if per_step != want:
        raise AssertionError(f"training launches a step {per_step}, expected {want}")
    records += check_steps(trainer.history)
    ms = 1e3 * seconds / steps
    batch = device_batch(collate([trainer.train_set[i] for i in range(TRAIN_BATCH)]), device)
    step = lambda: train_step(trainer.model, trainer.optimizer, batch,  # noqa: E731
                              trainer.loss_fn, trainer.cfgs.model, trainer.step)
    wall, kernels = profile_kernels(step)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  train steps (epoch 1, {steps} steps of {TRAIN_BATCH}): {ms:.1f} ms a step, "
          f"{1e3 * TRAIN_BATCH / ms:.2f} frame pairs/s (epoch 0, the first step warming up: "
          f"{1e3 * first_epoch / steps:.1f} ms a step); profiled step: wall {wall:.1f} ms, device "
          f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} "
          f"kernel launches; peak memory {peak:.0f} MiB | {card}", flush=True)
    print(f"  launches a step: { {k: v for k, v in per_step.items() if v} } (the fused "
          "kernels #5-#13: 0)", flush=True)
    print("  per step:", [{k: round(v, 4) if isinstance(v, float) else v for k, v in r.items()}
                          for r in records], flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x  "
              f"{short_name(e.key)[:80]}")

    summary = trainer.validate(1)
    if not all(np.isfinite(v) for v in summary.values()):
        raise AssertionError(f"validation: {summary}")
    path = trainer.save_ckpt(1)
    resumed = Trainer(cfgs("run", "ckpt.resume=true"), device)
    if (resumed.start_epoch, resumed.step) != (2, trainer.step) or any(
            not torch.equal(v, trainer.model.state_dict()[k])
            for k, v in resumed.model.state_dict().items()):
        raise AssertionError("the resumed trainer does not hold the saved state")
    print(f"  validation: EPE2d {summary['epe2d']:.3f} px, EPE3d {summary['epe3d']:.3f} m; "
          f"saved {path} and resumed (epoch {resumed.start_epoch}, step {resumed.step})",
          flush=True)
    del resumed

    # resumed against uninterrupted, augmentation off
    off = "trainset.augmentation.enabled=false"
    straight = Trainer(cfgs("straight", off), device)
    straight.train_one_epoch(0)
    straight.save_ckpt(0)
    straight.train_one_epoch(1)
    split = Trainer(cfgs("straight", off, "ckpt.resume=true"), device)
    split.train_one_epoch(split.start_epoch)
    want_losses = [r["loss"] for r in straight.history if r["epoch"] == 1]
    got_losses = [r["loss"] for r in split.history]
    rel = abs(got_losses[0] - want_losses[0]) / abs(want_losses[0])
    print(f"  resume: epoch-1 losses resumed {got_losses}, straight {want_losses}; first "
          f"step's relative difference {rel:.2e} (bound {RESUME_TOL})", flush=True)
    if not rel <= RESUME_TOL:
        raise AssertionError(f"resumed loss {got_losses[0]} vs {want_losses[0]}")
    del straight, split, trainer

    # one f32 train step, batch 1, 2 iterations: the card against the CPU
    f32_cfgs = {**main_cfgs.model.to_dict(), "n_iters_train": 2}
    torch.manual_seed(SEED)
    cpu_model = model_factory(f32_cfgs)(f32_cfgs).train()
    card_model = copy.deepcopy(cpu_model).to(device).train()
    sample = collate([dataset_factory(cfgs("f32", off).trainset)[0]])
    results = {}
    for name, model, dev in (("cuda", card_model, device), ("cpu", cpu_model, torch.device("cpu"))):
        optimizer = optimizer_factory(main_cfgs.training, model, steps)
        start = time.perf_counter()
        loss, _, _ = train_step(model, optimizer, device_batch(sample, dev), loss_fn, f32_cfgs, 0)
        loss = float(loss)
        results[name] = (loss, {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                         {k: p.detach().cpu() for k, p in model.named_parameters()},
                         time.perf_counter() - start)
        lr = max(group["lr"] for group in optimizer.param_groups)
    (loss_gpu, grads_gpu, params_gpu, s_gpu), (loss_cpu, grads_cpu, params_cpu, s_cpu) = (
        results["cuda"], results["cpu"])
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_ratio, grad_worst = max(
        (float((grads_gpu[k] - g).abs().max()) / (GRAD_TOL * (1 + float(g.abs().max()))), k)
        for k, g in grads_cpu.items())
    agree, flipped = step_differences(params_gpu, params_cpu, grads_gpu, grads_cpu)
    n_flipped = sum(n for _, n, _ in flipped.values())
    flip_err = max((d for d, _, _ in flipped.values()), default=0.0)
    param_err, param_worst = max((d, k) for k, d in agree.items())
    print(f"  f32 step, batch 1, 2 iterations: loss card {loss_gpu:.6f}, CPU {loss_cpu:.6f} "
          f"(relative {loss_rel:.2e}, bound {LOSS_TOL}); worst gradient at {grad_ratio:.3f} of "
          f"its bound ({grad_worst}); parameters after the step max|d| {param_err:.2e} "
          f"({param_worst}; bound {PARAM_TOL}) where the two gradients agree in sign; "
          f"{n_flipped} elements of {sum(p.numel() for p in params_cpu.values())} where they "
          f"differ in sign (f32 rounding of near-zero gradients: Adam's first step moves each "
          f"by about +-lr = {lr:g} on either side), max|d| {flip_err:.2e} (bound 2 lr), in "
          f"{ {k: (n, f'{g:.1e}') for k, (_, n, g) in flipped.items()} } (elements, largest "
          f"|g_cpu|); card {s_gpu:.1f} s, CPU {s_cpu:.1f} s", flush=True)
    if not (loss_rel <= LOSS_TOL and grad_ratio <= 1.0 and param_err <= PARAM_TOL
            and flip_err <= 2 * lr * (1 + 1e-3)):
        raise AssertionError("the f32 train step on the card differs from the CPU's")
    return launches


def step_differences(params_a, params_b, grads_a, grads_b):
    """Two devices' parameters after one optimizer step from the same
    weights: ({name: max |dp| over the elements whose two gradients have the
    same sign}, {name: (max |dp|, count, max |g_b|) over the elements whose
    gradients differ in sign}, the latter only where there are some). Adam's
    first step moves an element by lr * g / (|g| + eps), about +-lr, so an
    element whose gradient rounds to the other sign on the other device
    (|g| within the devices' rounding difference) moves 2 lr apart."""
    import torch

    agree, flipped = {}, {}
    for name, p in params_b.items():
        diff = (params_a[name] - p).abs()
        other = torch.sign(grads_a[name]) != torch.sign(grads_b[name])
        agree[name] = float(diff[~other].max()) if bool((~other).any()) else 0.0
        if bool(other.any()):
            flipped[name] = (float(diff[other].max()), int(other.sum()),
                             float(grads_b[name][other].abs().max()))
    return agree, flipped


# phase 9's other five families: (config name, launches a train step at
# full width, derived from the code, the branches the family labels
# parameters with). CamLiRAFT-L: the flagship's selections less the fusion
# cache (2 encoder levels, the k=32 neighbours, the upsample's k=3, 3
# pooling levels), #3 on the detached flow and #4 index-only once an
# iteration (10); the PWC family's point side: 10 KNN in the two pyramids,
# 2 a decoder level, then 13 k=3 selections of the interpolation's train
# form (4 level upsamples, 4 backwarps, 5 final upsamples), CamLiPWC 2
# fusion caches a level more; RAFT and PWC: none of the port's kernels.
TRAIN_FAMILIES = (
    ("camliraft_l", {"k_nearest_neighbor": 7, "furthest_point_sampling": 1,
                     "knn_interpolation": 10, "correlation3d_knn_index": 10}, ("2d",)),
    ("raft", {}, ("2d",)),
    ("pwc", {}, ("2d",)),
    ("camlipwc_l", {"k_nearest_neighbor": 33, "furthest_point_sampling": 1}, ("2d",)),
    ("camlipwc", {"k_nearest_neighbor": 43, "furthest_point_sampling": 1}, ("2d", "3d")),
)
FAMILY_PAIRS = 4  # the families' training split: 2 steps of 2 an epoch
# the f32 step against the CPU, cut so the CPU side stays short
SMALL_H, SMALL_W, SMALL_POINTS, SMALL_ITERS = 256, 448, 2048, 2
SMALL_SAMPLES = [1024, 512, 256, 128, 64]


def small_batch(seed: int, kitti: bool = False) -> dict:
    """One frame pair at SMALL_W x SMALL_H with SMALL_POINTS points in its
    view (its own intrinsics, 5-35 m), targets included; with `kitti`,
    KITTI's targets: the 3D flow with a validity channel of ones, no
    occlusion mask."""
    rng = np.random.RandomState(seed)
    f, cx, cy = INTRINSICS[0] * SMALL_W / IMAGE_W, (SMALL_W - 1) / 2, (SMALL_H - 1) / 2
    depth = rng.uniform(5.0, 35.0, SMALL_POINTS)
    u, v = rng.uniform(0, SMALL_W - 1, SMALL_POINTS), rng.uniform(0, SMALL_H - 1, SMALL_POINTS)
    pc1 = np.stack([(u - cx) * depth / f, (v - cy) * depth / f, depth], -1)[None]
    pc2 = pc1 + 0.1 * rng.randn(*pc1.shape)
    flow_2d = np.concatenate([3 * rng.randn(1, SMALL_H, SMALL_W, 2),
                              rng.rand(1, SMALL_H, SMALL_W, 1) > 0.1], -1)
    out = {"images": rng.randint(0, 255, (1, SMALL_H, SMALL_W, 6)), "flow_2d": flow_2d,
           "pcs": np.concatenate([pc1, pc2], -1), "flow_3d": pc2 - pc1,
           "intrinsics": np.float32([[f, cx, cy]]),
           "occ_mask_3d": rng.rand(1, SMALL_POINTS) > 0.9}
    if kitti:
        out["flow_3d"] = np.concatenate([out["flow_3d"], np.ones((1, SMALL_POINTS, 1))], -1)
        del out["occ_mask_3d"]
    return {k: np.asarray(v, dtype=np.float32) for k, v in out.items()}


def adam_step_differences(params_a, params_b, grads_a, grads_b, start, opt):
    """`step_differences` for a first Adam/AdamW step with any eps: (the
    largest |dp| - bound over all elements, the elements where the bound
    exceeds PARAM_TOL + 0.1 lr). Adam's first step moves an element by
    lr u, u = g / (|g| + eps) for the gradient g the optimizer sees (with
    Adam's L2 term for decayed parameters), so two devices' steps differ by
    lr |u_a - u_b|: about 2 lr where their gradients round to opposite
    signs, ~0 where |g| >> eps, and in between where |g| is near eps (PWC's
    eps is 1e-7). The bound is PARAM_TOL + lr |u_a - u_b|."""
    import torch

    worst, sensitive = -float("inf"), 0
    for group in opt.param_groups:
        lr, eps, decay = group["lr"], group["eps"], group["weight_decay"]
        l2 = isinstance(opt, torch.optim.Adam) and not isinstance(opt, torch.optim.AdamW)
        for name in group["names"]:
            dirs = []
            for g in (grads_a[name], grads_b[name]):
                g = g + decay * start[name] if l2 else g
                dirs.append(g / (g.abs() + eps))
            du = (dirs[0] - dirs[1]).abs()
            diff = (params_a[name] - params_b[name]).abs()
            worst = max(worst, float((diff - PARAM_TOL - lr * du * (1 + 1e-3)).max()))
            sensitive += int((du > 0.1).sum())
    return worst, sensitive


def timed_epochs(trainer, wrappers, want, label, check_steps) -> dict:
    """Epoch 0 (its first step the warm-up), then epoch 1 timed with every
    counter zeroed just before it: launches a step held to `want` (every
    other wrapper's 0), each step's record checked by `check_steps`. Returns
    steps, the two epochs' seconds, launches (the timed epoch's), launches a
    step, peak MiB and the step records."""
    import torch

    steps = len(trainer.train_loader)
    start = time.perf_counter()
    trainer.train_one_epoch(0)
    torch.cuda.synchronize()
    first_epoch = time.perf_counter() - start
    records = check_steps(trainer.history)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(trainer.device)
    start = time.perf_counter()
    trainer.train_one_epoch(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {key: fn.launches for key, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(trainer.device) / 2**20
    per_step = {key: count / steps for key, count in launches.items()}
    expected = {**dict.fromkeys(wrappers, 0), **want}
    if per_step != expected:
        raise AssertionError(f"{label} training launches a step {per_step}, expected {expected}")
    records += check_steps(trainer.history)
    return {"steps": steps, "first_epoch": first_epoch, "seconds": seconds,
            "launches": launches, "per_step": per_step, "peak": peak, "records": records}


def report_steps(trainer, label, shape, timed, card) -> None:
    """One train step under the profiler (its batch already on the card),
    then the timed epoch's ms a step, frame pairs/s, the profiled step's
    device busy share and launches, peak memory, launches a step, the step
    records and the top kernels."""
    from camliflow_torch.data.datasets import collate
    from camliflow_torch.runtime.trainer import device_batch
    from camliflow_torch.runtime.train_state import train_step

    batch = device_batch(collate([trainer.train_set[i] for i in range(TRAIN_BATCH)]),
                         trainer.device)
    step = lambda: train_step(trainer.model, trainer.optimizer, batch,  # noqa: E731
                              trainer.loss_fn, trainer.cfgs.model, trainer.step,
                              trainer.model_name)
    wall, kernels = profile_kernels(step)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ms = 1e3 * timed["seconds"] / timed["steps"]
    print(f"  {label} train steps (epoch 1, {timed['steps']} steps of {TRAIN_BATCH}, {shape}, "
          f"amp): {ms:.1f} ms a step, {1e3 * TRAIN_BATCH / ms:.2f} frame pairs/s (epoch 0, the "
          f"first step warming up: {1e3 * timed['first_epoch'] / timed['steps']:.1f} ms a step); "
          f"profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} kernel launches; the "
          f"loader's share {100 * max(0.0, 1 - wall / ms):.1f}% (timed step against profiled); "
          f"peak memory {timed['peak']:.0f} MiB | {card}", flush=True)
    print(f"  {label} launches a step: "
          f"{ {k: v for k, v in timed['per_step'].items() if v} } (every other wrapper: 0)",
          flush=True)
    print(f"  {label} per step:", [{k: round(v, 4) if isinstance(v, float) else v
                                    for k, v in r.items()} for r in timed["records"]],
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x  "
              f"{short_name(e.key)[:80]}")


def f32_step_against_cpu(device, family, cfgs, steps, sample, label) -> None:
    """One f32 train step of `family` on `cfgs` (its model and training
    groups) at SMALL_W x SMALL_H, SMALL_POINTS points and SMALL_ITERS
    iterations (batch 1) on the card against the same step on the CPU: the
    loss within LOSS_TOL, every gradient within GRAD_TOL (1 + max|g|), every
    parameter within PARAM_TOL + lr |du| of Adam's step direction."""
    import copy

    import torch

    from camliflow_torch.models.factory import model_factory, optimizer_factory, training_functions
    from camliflow_torch.runtime.trainer import device_batch
    from camliflow_torch.runtime.train_state import train_step

    f32_cfgs = {**cfgs.model.to_dict(), "compute_dtype": "float32", "batch_size": 1}
    if "n_iters_train" in f32_cfgs:
        f32_cfgs["n_iters_train"] = SMALL_ITERS
    if family not in ("raft", "pwc"):  # the families that take the clouds
        f32_cfgs["n_samples_list"] = SMALL_SAMPLES
    torch.manual_seed(SEED)
    cpu_model = model_factory(f32_cfgs)(f32_cfgs).train()
    card_model = copy.deepcopy(cpu_model).to(device).train()
    start_params = {k: p.detach().clone() for k, p in cpu_model.named_parameters()}
    loss_fn, _ = training_functions(family)
    results = {}
    for name, model, dev in (("cuda", card_model, device),
                             ("cpu", cpu_model, torch.device("cpu"))):
        optimizer = optimizer_factory(cfgs.training, model, steps, family)
        names = {id(q): k for k, q in model.named_parameters()}
        for group in optimizer.param_groups:
            group["names"] = [names[id(p)] for p in group["params"]]
        start = time.perf_counter()
        loss, _, _ = train_step(model, optimizer, device_batch(sample, dev), loss_fn, f32_cfgs,
                                0, family)
        loss = float(loss)
        results[name] = (loss, {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                         {k: p.detach().cpu() for k, p in model.named_parameters()},
                         time.perf_counter() - start, optimizer)
    (loss_gpu, grads_gpu, params_gpu, s_gpu, _), (loss_cpu, grads_cpu, params_cpu, s_cpu,
                                                  opt_cpu) = results["cuda"], results["cpu"]
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_ratio, grad_worst = max(
        (float((grads_gpu[k] - g).abs().max()) / (GRAD_TOL * (1 + float(g.abs().max()))), k)
        for k, g in grads_cpu.items())
    agree, flipped = step_differences(params_gpu, params_cpu, grads_gpu, grads_cpu)
    over, sensitive = adam_step_differences(params_gpu, params_cpu, grads_gpu, grads_cpu,
                                            start_params, opt_cpu)
    lr = max(group["lr"] for group in opt_cpu.param_groups)
    param_err, param_worst = max((d, k) for k, d in agree.items())
    print(f"  {label} f32 step, batch 1, {SMALL_W}x{SMALL_H}, {SMALL_POINTS} pts, "
          f"{SMALL_ITERS} iters (cut from full width so the CPU side stays short): loss card "
          f"{loss_gpu:.6f}, CPU {loss_cpu:.6f} (relative {loss_rel:.2e}, bound {LOSS_TOL}); "
          f"worst gradient at {grad_ratio:.3f} of its bound ({grad_worst}); parameters after "
          f"the step max|d| {param_err:.2e} ({param_worst}) where the gradients agree in sign, "
          f"{sum(n for _, n, _ in flipped.values())} elements where they differ (lr {lr:g}); "
          f"every element within PARAM_TOL {PARAM_TOL} + lr |du| of Adam's step direction "
          f"u = g / (|g| + eps) ({over:.2e} over), {sensitive} elements with |du| > 0.1; "
          f"card {s_gpu:.1f} s, CPU {s_cpu:.1f} s", flush=True)
    if not (np.isfinite(loss_cpu) and loss_rel <= LOSS_TOL and grad_ratio <= 1.0
            and over <= 0.0 and sensitive <= 1e-2 * sum(p.numel() for p in params_cpu.values())):
        raise AssertionError(f"{label}: the f32 train step on the card differs from the CPU's")


def branch_checker(label, branches):
    """A check of step records: the loss and each branch's gradient norm
    finite, the norms > 0."""
    def check_steps(history):
        for record in history:
            if not (np.isfinite(record["loss"]) and all(
                    np.isfinite(record[f"grad_norm_{b}"]) and record[f"grad_norm_{b}"] > 0
                    for b in branches)):
                raise AssertionError(f"{label} training step {record}: a loss or gradient "
                                     "norm is not finite, or a branch's gradient is 0")
        return history
    return check_steps


def family_training_phase(device, wrappers, card, root, family, want, branches) -> dict:
    """Phase 9 for one of the other five families: `python -m
    camliflow_torch.train trainset=flyingthings3d_subset
    valset=flyingthings3d_subset model=<family>`'s Trainer on the card at the
    family's full width with its own training config (amp, augmentation
    on), batches of 2 on FAMILY_PAIRS synthetic 960x540 pairs: epoch 0 (the
    warm-up), epoch 1 timed with every counter zeroed just before it
    (launches a step held to `want`, every other wrapper's 0), every step's
    loss and each of the family's branch gradient norms finite and > 0, one
    profiled step (device busy share), a validation pass with finite
    metrics; then one f32 step at SMALL_W x SMALL_H, SMALL_POINTS points and
    SMALL_ITERS iterations (batch 1) on the card against the same step on
    the CPU. Returns the timed epoch's launches."""
    from camliflow_torch.runtime.trainer import Trainer
    from camliflow_torch.utils.config import compose

    cfgs = compose("conf", trainset="flyingthings3d_subset", valset="flyingthings3d_subset",
                   model=family, base="trainer.yaml", overrides=[
                       f"trainset.root_dir={root}/data", f"valset.root_dir={root}/data",
                       "trainset.split=train_small", f"model.batch_size={TRAIN_BATCH}",
                       "training.epochs=2", f"log.dir={root}/{family}", "log.print_interval=1",
                       "log.val_interval=100", "trainset.n_workers=4", "valset.n_workers=4"])
    own = compose("conf", trainset="flyingthings3d_subset", valset="flyingthings3d_subset",
                  model=family, base="trainer.yaml")
    if not (cfgs.model.name == family and cfgs.training.to_dict() == {
            **own.training.to_dict(), "epochs": 2} and cfgs.training.amp
            and cfgs.trainset.augmentation.enabled and cfgs.trainset.n_points == N_POINTS
            and cfgs.model.get("n_iters_train") == own.model.get("n_iters_train")
            and cfgs.model.get("n_samples_list") == own.model.get("n_samples_list")):
        raise AssertionError(f"the composed config is not {family}'s training config")

    trainer = Trainer(cfgs, device)
    timed = timed_epochs(trainer, wrappers, want, family, branch_checker(family, branches))
    shape = (f"{cfgs.trainset.augmentation.random_crop.crop_size[0]}x"
             f"{cfgs.trainset.augmentation.random_crop.crop_size[1]} crops"
             if cfgs.trainset.augmentation.random_crop.enabled else f"{IMAGE_W}x{IMAGE_H}")
    report_steps(trainer, family,
                 f"{shape if cfgs.trainset.with_image else 'no images'}, "
                 f"{f'{N_POINTS} pts' if cfgs.trainset.with_pc else 'no points'}, "
                 f"{cfgs.model.get('n_iters_train', 'no')} iters", timed, card)
    summary = trainer.validate(1)
    if not summary or not all(np.isfinite(v) for v in summary.values()):
        raise AssertionError(f"{family} validation: {summary}")
    print(f"  {family} validation: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        summary.items())), flush=True)
    del trainer

    # one f32 train step at the reduced size: the card against the CPU
    f32_step_against_cpu(device, family, cfgs, timed["steps"], small_batch(SEED + 80), family)
    return timed["launches"]


# phase 9's KITTI fine-tunes: (model, launches a train step at full width,
# the branches the family labels parameters with). The selections do not
# depend on the image size or freeze_bn, so they are FlyingThings3D's:
# CamLiRAFT FPS once, KNN 8 (2 encoder levels, the fusion cache, the k=32
# neighbours, the upsample's k=3, 3 pooling levels), #3 on the detached flow
# and #4 index-only once an iteration; CamLiPWC FPS once, KNN 43 (10 in the
# two pyramids, 2 a decoder level, 10 fusion caches, 13 k=3 selections of the
# interpolation's train form). tests/test_torch_train_kitti.py counts them
# at a KITTI-config step on the CPU.
KITTI_FINE_TUNES = (
    ("camliraft", {"k_nearest_neighbor": 8, "furthest_point_sampling": 1,
                   "knn_interpolation": TRAIN_ITERS, "correlation3d_knn_index": TRAIN_ITERS},
     ("2d", "3d")),
    ("camlipwc", {"k_nearest_neighbor": 43, "furthest_point_sampling": 1}, ("2d", "3d")),
)
# KITTI's fixed splits (160 and 40 frames) cut in the process to their first
# frames: training160's 1-4, training40's 0 and 5
KITTI_TRAIN_FRAMES, KITTI_VAL_FRAMES = 4, 2
KITTI_PAD_H = 376  # the reader zero-pads 375 rows to 376 x 1242


def write_kitti_training_split(root, frames: int) -> None:
    """KITTI's training layout for frames 0 .. frames - 1 at 375 x 1242,
    written with the port's writers: calib_cam_to_cam (KITTI's P_rect_02),
    image_2 (both frames), flow_occ (a forward motion's flow, expanding from
    the principal point by 3%: up to 19 px, so most of frame 2's points stay
    in its image; 70% of the pixels valid), disp_occ_0 and disp_occ_1
    (`kitti_disparity`: 3-70 m, frame 2 1 m nearer)."""
    import os

    from camliflow_torch.data import io
    from camliflow_torch.data.png import write_png

    base = os.path.join(root, "training")
    for sub in ("calib_cam_to_cam", "image_2", "flow_occ", "disp_occ_0", "disp_occ_1"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.RandomState(SEED + 90)
    cols = np.arange(KITTI_W)[None, :, None]
    ys, xs = np.mgrid[0:KITTI_H, 0:KITTI_W].astype(np.float32)
    cx, cy = KITTI_P2[2], KITTI_P2[6]
    for i in range(frames):
        path = lambda sub, name: os.path.join(base, sub, name % i)  # noqa: E731
        with open(path("calib_cam_to_cam", "%06d.txt"), "w") as f:
            f.write("P_rect_02: " + " ".join(f"{v:e}" for v in KITTI_P2) + "\n")
        for suffix in ("10", "11"):
            image = rng.randint(0, 60, (KITTI_H, KITTI_W, 3)) + (cols + 40 * i) % 190
            write_png(path("image_2", f"%06d_{suffix}.png"), image.astype(np.uint8))
        flow = np.stack([0.03 * (xs - cx), 0.03 * (ys - cy)], -1)
        flow = (flow + 0.5 * rng.randn(KITTI_H, KITTI_W, 2)).astype(np.float32)
        io.save_flow_png(path("flow_occ", "%06d_10.png"), flow,
                         (rng.rand(KITTI_H, KITTI_W) > 0.3).astype(np.float32))
        io.save_disp_png(path("disp_occ_0", "%06d_10.png"), kitti_disparity(rng, 0.0))
        io.save_disp_png(path("disp_occ_1", "%06d_10.png"), kitti_disparity(rng, 1.0))


@contextlib.contextmanager
def kitti_splits_cut(train: int, val: int):
    """Within the block, KITTI readers keep the first `train` frames of
    training160 and the first `val` of the other splits: the smoke's cut of
    KITTI's fixed split lists, which no config key shrinks."""
    from camliflow_torch.data import datasets

    original = datasets.KITTI.__init__

    def cut(reader, cfgs, seed=0):
        original(reader, cfgs, seed)
        reader.indices = reader.indices[:train if cfgs.split == "training160" else val]

    datasets.KITTI.__init__ = cut
    try:
        yield
    finally:
        datasets.KITTI.__init__ = original


def event_records(path) -> list[tuple]:
    """The events of a TensorBoard file after its header, each (tag, step,
    scalar value or None, (height, width, PNG bytes) or None), its TFRecord
    framing and masked CRCs checked."""
    import struct

    from camliflow_torch.utils.tensorboard import masked_crc

    def fields(buf):
        out, off = {}, 0

        def varint():
            nonlocal off
            value, shift = 0, 0
            while True:
                b = buf[off]
                off += 1
                value |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    return value

        while off < len(buf):
            key = varint()
            wire = key & 7
            if wire == 0:
                value = varint()
            elif wire == 1:
                (value,), off = struct.unpack_from("<d", buf, off), off + 8
            elif wire == 2:
                n = varint()
                value, off = buf[off:off + n], off + n
            elif wire == 5:
                (value,), off = struct.unpack_from("<f", buf, off), off + 4
            else:
                raise AssertionError(f"wire type {wire} in an event")
            out.setdefault(key >> 3, []).append(value)
        return out

    data, off, records = open(path, "rb").read(), 0, []
    while off < len(data):
        header = data[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        payload = data[off + 12:off + 12 + length]
        if (struct.unpack_from("<I", data, off + 8)[0] != masked_crc(header)
                or struct.unpack_from("<I", data, off + 12 + length)[0] != masked_crc(payload)):
            raise AssertionError(f"{path}: a record's CRC does not check")
        records.append(fields(payload))
        off += 16 + length
    if records[0].get(3) != [b"brain.Event:2"]:
        raise AssertionError(f"{path}: no brain.Event:2 header")
    out = []
    for event in records[1:]:
        value = fields(fields(event[5][0])[1][0])
        image = fields(value[4][0]) if 4 in value else None
        out.append((value[1][0].decode(), event[2][0], value[2][0] if 2 in value else None,
                    (image[1][0], image[2][0], image[4][0]) if image else None))
    return out


def kitti_training_phase(device, wrappers, card, root, family, want, branches) -> dict:
    """Phase 9's KITTI fine-tune of `family`: `python -m camliflow_torch.train
    trainset=kitti valset=kitti model=<family>`'s Trainer on the card with
    conf/training/kitti/<family>.yaml at full width (`freeze_bn`, no
    warm-up, amp, colour jitter, flip and scale on 376 x 1242 frames, 8192
    points), batches of 2 on KITTI_TRAIN_FRAMES synthetic frames (KITTI's
    splits cut in the process): epoch 0 (the warm-up), epoch 1 timed with
    every counter zeroed just before it (launches a step held to `want`),
    every loss and branch gradient norm finite and > 0, every BatchNorm's
    running statistics bit for bit unchanged over both epochs, one profiled
    step, then a validation pass at 376 x 1242 through the Evaluator with
    `log.save_image_summary`: tb/ parsed back (the epochs' scalars as
    metrics.jsonl has them, the val/flow2d image) and
    images/flow2d_epoch001.png decoded to 376 x 1242 x 3; and one f32 step
    of the KITTI config at SMALL_W x SMALL_H against the CPU. Returns the
    timed epoch's launches."""
    import json
    import os

    import torch

    from camliflow_torch.data.datasets import KITTI
    from camliflow_torch.data.png import decode, read_png
    from camliflow_torch.nn.layers import BatchNorm
    from camliflow_torch.runtime.trainer import Trainer
    from camliflow_torch.utils.config import compose

    log_dir = os.path.join(root, family)
    cfgs = compose("conf", trainset="kitti", valset="kitti", model=family, base="trainer.yaml",
                   overrides=[f"trainset.root_dir={root}/data", f"valset.root_dir={root}/data",
                              f"model.batch_size={TRAIN_BATCH}", "training.epochs=2",
                              f"log.dir={log_dir}", "log.print_interval=1",
                              "log.val_interval=100", "log.save_image_summary=true",
                              "trainset.n_workers=4", "valset.n_workers=4"])
    own = compose("conf", trainset="kitti", valset="kitti", model=family, base="trainer.yaml")
    if not (cfgs.model.name == family and cfgs.model.freeze_bn
            and cfgs.training.to_dict() == {**own.training.to_dict(), "epochs": 2}
            and cfgs.training.warmup_epochs == 0 and cfgs.training.amp
            and cfgs.trainset.augmentation.enabled and cfgs.trainset.split == "training160"
            and cfgs.valset.split == "training40" and not cfgs.valset.augmentation.enabled
            and cfgs.trainset.n_points == cfgs.valset.n_points == N_POINTS
            and cfgs.model.to_dict() == {**own.model.to_dict(), "batch_size": TRAIN_BATCH}):
        raise AssertionError(f"the composed config is not {family}'s KITTI fine-tune")
    with kitti_splits_cut(KITTI_TRAIN_FRAMES, KITTI_VAL_FRAMES):
        trainer = Trainer(cfgs, device)
    if not (isinstance(trainer.train_set, KITTI) and len(trainer.train_set) == KITTI_TRAIN_FRAMES
            and len(trainer.val_set) == KITTI_VAL_FRAMES):
        raise AssertionError("the KITTI splits were not cut")
    norms = {name for name, m in trainer.model.named_modules() if isinstance(m, BatchNorm)}
    start = {name: value.clone() for name, value in trainer.model.named_buffers()
             if name.rsplit(".", 1)[0] in norms}
    if not start:
        raise AssertionError(f"{family} has no BatchNorm statistics to hold")

    timed = timed_epochs(trainer, wrappers, want, f"KITTI {family}",
                         branch_checker(f"KITTI {family}", branches))
    moved = [name for name, value in trainer.model.named_buffers()
             if name in start and not torch.equal(value, start[name])]
    if moved:
        raise AssertionError(f"freeze_bn: {len(moved)} BatchNorm buffers moved, {moved[:4]}")
    report_steps(trainer, f"KITTI {family}",
                 f"{KITTI_W}x{KITTI_PAD_H}, {N_POINTS} pts, "
                 f"{cfgs.model.get('n_iters_train', 'no')} iters, freeze_bn", timed, card)
    print(f"  KITTI {family}: {len(start)} BatchNorm buffers of {len(norms)} BatchNorms bit for "
          "bit unchanged over both epochs (freeze_bn)", flush=True)

    summary = trainer.validate(1)
    trainer.tb.close()
    if not summary or not all(np.isfinite(v) for v in summary.values()):
        raise AssertionError(f"KITTI {family} validation: {summary}")
    image = read_png(os.path.join(log_dir, "images", "flow2d_epoch001.png"))
    if image.shape != (KITTI_PAD_H, KITTI_W, 3):
        raise AssertionError(f"the image summary is {image.shape}")
    lines = [json.loads(x) for x in open(os.path.join(log_dir, "metrics.jsonl"))]
    want_scalars = [(f"{x['tag']}/{k}", x["epoch"], float(np.float32(v))) for x in lines
                    for k, v in x.items() if k not in ("tag", "epoch")]
    events = event_records(trainer.tb.path)
    scalars = [(tag, step, value) for tag, step, value, _ in events if value is not None]
    images = [(tag, step, im) for tag, step, _, im in events if im is not None]
    if scalars != want_scalars:
        raise AssertionError(f"tb/ scalars {scalars} against metrics.jsonl's {want_scalars}")
    if (len(images) != 1 or images[0][:2] != ("val/flow2d", 1)
            or images[0][2][:2] != (KITTI_PAD_H, KITTI_W)
            or not np.array_equal(decode(images[0][2][2]), image)):
        raise AssertionError("tb/ holds no val/flow2d event equal to the summary image")
    print(f"  KITTI {family} validation ({KITTI_VAL_FRAMES} frames at {KITTI_W}x{KITTI_PAD_H}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(summary.items()))
          + f"; tb/ {len(scalars)} scalars as metrics.jsonl has them and val/flow2d at step 1; "
          f"images/flow2d_epoch001.png {image.shape}", flush=True)
    del trainer

    f32_step_against_cpu(device, family, cfgs, timed["steps"], small_batch(SEED + 81, kitti=True),
                         f"KITTI {family}")
    return timed["launches"]


# phase 10: data parallelism
DP_WARM = 2  # steps after the compared first one before the timed ones (DDP rebuilds
# its gradient buckets at its second step)
DP_TIMED = 10
DP_TIMEOUT = 600  # seconds a group of ranks may take, start-up included
DP_FRAMES = 5  # (c)'s frames: global batches of 2 leave rank 1's last slice empty
BUFFER_TOL = 1e-6  # BatchNorm statistics, |d| <= BUFFER_TOL (1 + |b|) (tests/torch_train_parity.py)
# aten operations whose CUDA kernels PyTorch documents as nondeterministic
# (atomic adds), or deterministic only under `use_deterministic_algorithms`
NONDETERMINISTIC_OPS = ("aten::index_add_", "aten::index_put_", "aten::_index_put_impl_",
                        "aten::scatter_add_", "aten::scatter_reduce_", "aten::put_",
                        "aten::embedding_dense_backward", "aten::grid_sampler_2d_backward",
                        "aten::upsample_bilinear2d_backward", "aten::convolution_backward",
                        "aten::max_pool2d_with_indices_backward",
                        "aten::adaptive_avg_pool2d_backward", "aten::avg_pool2d_backward")
# relative, (c)'s totals: the Evaluator adds each sample's float32 sums into
# float32 accumulators (NumPy's scalar promotion), so the order of the
# samples rounds in the 7th digit
SUM_TOL = 1e-6


def dp_cfgs(root: str, label: str):
    """The flagship's training config (conf/training/flyingthings3d_subset/
    camliraft.yaml) at full width in f32 (amp off), global batch 2, on the
    train_small split, its log directory <root>/dp/<label>."""
    from camliflow_torch.utils.config import compose

    return compose("conf", trainset="flyingthings3d_subset", valset="flyingthings3d_subset",
                   model="camliraft", base="trainer.yaml", overrides=[
                       f"trainset.root_dir={root}/data", f"valset.root_dir={root}/data",
                       "trainset.split=train_small", f"model.batch_size={TRAIN_BATCH}",
                       "training.amp=false", f"log.dir={root}/dp/{label}",
                       "trainset.n_workers=0", "valset.n_workers=0"])


def dp_steps(trainer, wrappers, path: str, timed: int = DP_TIMED) -> dict:
    """The Trainer's first step on its (rank's slice of the) first global
    batch of epoch 0, through `trainer.ddp` as `train_one_epoch` takes it,
    every counter zeroed just before; the loss, every parameter, gradient
    and buffer after it into `path`; then, with `timed`, DP_WARM more steps
    on the same batch and `timed` timed ones for ms a step. Returns the
    loss, launches, lr and ms."""
    import torch

    from camliflow_torch.runtime.train_state import train_step
    from camliflow_torch.runtime.trainer import device_batch

    trainer.train_loader.set_epoch(0)
    batch = device_batch(next(iter(trainer.train_loader)), trainer.device)

    def step(index):
        return train_step(trainer.ddp, trainer.optimizer, batch, trainer.loss_fn,
                          trainer.cfgs.model, index, trainer.model_name)[0]

    for fn in wrappers.values():
        fn.launches = 0
    loss = float(step(0))
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in wrappers.items()}
    arrays = {"loss": np.float32(loss)}
    for key, param in trainer.model.named_parameters():
        arrays[f"param/{key}"] = param.detach().cpu().numpy()
        arrays[f"grad/{key}"] = param.grad.cpu().numpy()
    arrays.update({f"buffer/{k}": v.cpu().numpy() for k, v in trainer.model.named_buffers()})
    np.savez(path, **arrays)
    lr = max(group["lr"] for group in trainer.optimizer.param_groups)
    ms = None
    if timed:
        for index in range(1, 1 + DP_WARM):
            step(index)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for index in range(1 + DP_WARM, 1 + DP_WARM + timed):
            step(index)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start) / timed
    return {"loss": loss, "launches": launches, "lr": lr, "ms": ms, "batch": len(batch["pcs"])}


class Frames:
    """(c)'s frames as a dataset: `frame_pair`'s samples with images."""

    def __init__(self, n: int):
        self.samples = []
        for i in range(n):
            pair = frame_pair(SEED + 1 + i, i, images=True)
            self.samples.append({k: v[0] if k != "index" else i for k, v in pair.items()})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def dp_eval(device, batch_size: int) -> dict:
    """The flagship (random weights from SEED) through `Evaluator.run_things`
    over DP_FRAMES frames in global batches of `batch_size`, each rank its
    slice."""
    from camliflow_torch.data.datasets import batches
    from camliflow_torch.models.camliraft import CamLiRAFT
    from camliflow_torch.parallel import dist
    from camliflow_torch.runtime.checkpoint import random_weights
    from camliflow_torch.runtime.evaluator import Evaluator

    model = CamLiRAFT(FLAGSHIP_CFGS)
    random_weights(model, SEED)
    evaluator = Evaluator(model, device)
    return evaluator.run_things(batches(Frames(DP_FRAMES), batch_size, dist.rank(),
                                        dist.world_size()))


def dp_rank(device, root: str, label: str, evaluate: bool) -> None:
    """One rank of phase 10 (in a process `dist.spawn` started, in its
    group): `dp_steps` on the DDP Trainer, then, with `evaluate`,
    `dp_eval` in global batches of 2; its results into
    <root>/dp/<label>.rank<r>.json and .npz."""
    import gc

    import torch

    from camliflow_torch.parallel import dist
    from camliflow_torch.runtime.trainer import Trainer

    path = f"{root}/dp/{label}.rank{dist.rank()}"
    trainer = Trainer(dp_cfgs(root, label), device)
    result = dp_steps(trainer, kernel_wrappers(), path + ".npz")
    result.update(rank=dist.rank(), world=dist.world_size(), device=str(device),
                  backend=torch.distributed.get_backend(),
                  wrapped=type(trainer.ddp).__name__)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if evaluate:
        result["things"] = {k: float(v) for k, v in dp_eval(device, TRAIN_BATCH).items()}
    with open(path + ".json", "w") as f:
        json.dump(result, f)


def dp_differences(want: dict, got: dict) -> dict:
    """Two first steps' saved arrays: bit for bit or not; the loss's
    relative difference; the parameters by `step_differences`; the largest
    BatchNorm-statistic difference against BUFFER_TOL (1 + |b|)."""
    import torch

    params = [{k[6:]: torch.from_numpy(v[k]) for k in v if k.startswith("param/")}
              for v in (got, want)]
    grads = [{k[5:]: torch.from_numpy(v[k]) for k in v if k.startswith("grad/")}
             for v in (got, want)]
    agree, flipped = step_differences(*params, *grads)
    buffers = [k for k in want if k.startswith("buffer/")]
    ratio, worst = max(
        (float(np.max(np.abs(got[k] - want[k]) / (BUFFER_TOL * (1 + np.abs(want[k]))))), k)
        for k in buffers)
    return {"identical": all(np.array_equal(got[k], want[k]) for k in want if k[:5] != "grad/"),
            "loss_rel": abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"])),
            "param_err": max(agree.values()), "param_worst": max(agree, key=agree.get),
            "flipped": sum(n for _, n, _ in flipped.values()),
            "flip_err": max((d for d, _, _ in flipped.values()), default=0.0),
            "buffer_ratio": ratio, "buffer_worst": worst,
            "buffer_max": max(float(np.max(np.abs(got[k] - want[k]))) for k in buffers)}


def one_process_step(device, root: str, label: str, wrappers, timed: int = 0) -> dict:
    """`dp_steps` on a Trainer of its own, outside any group, freed after."""
    import gc

    import torch

    from camliflow_torch.runtime.trainer import Trainer

    trainer = Trainer(dp_cfgs(root, label), device)
    result = dp_steps(trainer, wrappers, f"{root}/dp/{label}.npz", timed)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return result


def one_process(index: int, root: str, device: str, label: str) -> None:
    """Phase 10's one process, in a new interpreter as the ranks are (the
    step times of the chip_smoke process, after nine phases, are not a new
    process's): the timed first step; for the reference ("alone"), the same
    first step again under the profiler (the aten operations it runs); the
    results into <root>/dp/<label>.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    wrappers = kernel_wrappers()
    result = one_process_step(device, root, label, wrappers, DP_TIMED)
    if label == "alone":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            one_process_step(device, root, "alone_again", wrappers)
        result["ops"] = sorted({e.key for e in prof.key_averages()
                                if e.key in NONDETERMINISTIC_OPS})
    with open(f"{root}/dp/{label}.json", "w") as f:
        json.dump(result, f)


def fresh_process(fn, *args) -> None:
    """fn(0, *args) in a new interpreter; raises if it fails or runs past
    DP_TIMEOUT."""
    import torch.multiprocessing as mp

    context = mp.start_processes(fn, args=args, nprocs=1, join=False, start_method="spawn")
    if not context.join(timeout=DP_TIMEOUT):
        for process in context.processes:
            process.kill()
        raise TimeoutError(f"{fn.__name__} still ran after {DP_TIMEOUT} s")


def data_parallel_phase(device, wrappers, card) -> dict:
    """Phase 10: the flagship's Trainer at full width in f32 (dp_cfgs),
    global batch 2: one process's first step (twice, to see whether the card
    repeats it bit for bit) and DP_TIMED timed steps after DP_WARM more, in
    a new process as each rank is, and again after the ranks (the spread
    of its time); (a) one rank over NCCL
    (DistributedDataParallel) against it, bit for bit where one process
    repeats itself, else within (b)'s bounds with the nondeterministic
    operations named; (b) two ranks over gloo sharing cuda:0, batch 1 each,
    against it: loss within LOSS_TOL / 10, parameters within PARAM_TOL where
    the gradients agree in sign (2 lr where they differ), BatchNorm
    statistics within BUFFER_TOL (1 + |b|), both ranks bit for bit alike;
    launches a step held per rank (#1 8, #2 1, #3 10, #4 index-only 10, the
    rest 0); (c) the two ranks' `run_things` over DP_FRAMES frames in global
    batches of 2 against one process's at batch 1 (rank 1's last slice
    empty), within SUM_TOL. Each group of ranks is waited for at most
    DP_TIMEOUT s. Returns the launches of the one-process step and the
    ranks' first steps."""
    import os

    import torch

    from camliflow_torch.parallel import dist

    root = os.path.join(WORK, "train")
    for split, pairs, seed in (("train_small", FAMILY_PAIRS, SEED + 72), ("val", 4, SEED + 71)):
        if not os.path.isdir(os.path.join(root, "data", split)):  # phase 9's, unless it failed
            write_things_split(os.path.join(root, "data"), split, pairs, seed)
    os.makedirs(os.path.join(root, "dp"), exist_ok=True)
    want = {**dict.fromkeys(wrappers, 0), "k_nearest_neighbor": 8,
            "furthest_point_sampling": 1, "knn_interpolation": TRAIN_ITERS,
            "correlation3d_knn_index": TRAIN_ITERS}
    total = dict.fromkeys(wrappers, 0)

    def held(label, launches):
        if launches != want:
            raise AssertionError(f"{label}: launches of the first step {launches}, "
                                 f"expected {want}")
        for key, count in launches.items():
            total[key] += count

    fresh_process(one_process, root, str(device), "alone")
    with open(f"{root}/dp/alone.json") as f:
        alone = json.load(f)
    held("one process", alone["launches"])
    arrays = {label: dict(np.load(f"{root}/dp/{label}.npz")) for label in ("alone", "alone_again")}
    again = dp_differences(arrays["alone"], arrays["alone_again"])
    lr = alone["lr"]
    print(f"  one process, batch {alone['batch']}: loss {alone['loss']:.6f}, {alone['ms']:.1f} ms "
          f"a step ({DP_TIMED} steps after {1 + DP_WARM}, f32) | {card}", flush=True)
    why = ""
    if not again["identical"]:  # the operations that may add in any order, and a check
        ops = alone["ops"]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            pair = [one_process_step(device, root, label, wrappers)
                    for label in ("deterministic", "deterministic_again")]
        finally:
            torch.use_deterministic_algorithms(False)
        repeats = dp_differences(*(dict(np.load(f"{root}/dp/{label}.npz"))
                                   for label in ("deterministic", "deterministic_again")))
        why = (f"; the step runs {ops} (PyTorch's nondeterministic CUDA operations); under "
               f"use_deterministic_algorithms two first steps are bit for bit alike: "
               f"{repeats['identical']} (losses {pair[0]['loss']:.6f}, {pair[1]['loss']:.6f})")
    print(f"  one process again from the same weights and batch: bit for bit "
          f"{again['identical']} (loss relative {again['loss_rel']:.2e}; parameters max|d| "
          f"{again['param_err']:.3e} where the gradients agree in sign, {again['flipped']} "
          f"elements where not, max|d| {again['flip_err']:.3e}; BatchNorm statistics max|d| "
          f"{again['buffer_max']:.3e}){why}", flush=True)

    def check_bounds(label, d):
        if not (d["loss_rel"] <= LOSS_TOL / 10 and d["param_err"] <= PARAM_TOL
                and d["flip_err"] <= 2 * lr * (1 + 1e-3) and d["buffer_ratio"] <= 1.0):
            raise AssertionError(f"{label} differs from one process beyond the bounds: {d}")

    def ranks(label, world, evaluate):
        start = time.perf_counter()
        dist.spawn(dp_rank, world, (root, label, evaluate), device_type="cuda",
                   timeout=DP_TIMEOUT)
        results = [json.load(open(f"{root}/dp/{label}.rank{r}.json")) for r in range(world)]
        saved = [dict(np.load(f"{root}/dp/{label}.rank{r}.npz")) for r in range(world)]
        for result in results:
            held(f"{label} rank {result['rank']}", result["launches"])
        return results, saved, time.perf_counter() - start

    # (a) one rank over NCCL
    (a,), (a_arrays,), seconds = ranks("nccl1", 1, False)
    if (a["backend"], a["wrapped"], a["world"]) != ("nccl", "DistributedDataParallel", 1):
        raise AssertionError(f"(a) ran as {a}")
    d = dp_differences(arrays["alone"], a_arrays)
    print(f"  (a) 1 rank over {a['backend']} on {a['device']}, batch {a['batch']}, "
          f"DistributedDataParallel: loss {a['loss']:.6f} (relative {d['loss_rel']:.2e}); "
          f"bit for bit the one-process step (loss, parameters, BatchNorm statistics): "
          f"{d['identical']}; parameters max|d| {d['param_err']:.3e} ({d['param_worst']}) where "
          f"the gradients agree in sign, {d['flipped']} elements where not (max|d| "
          f"{d['flip_err']:.3e}, bound 2 lr = {2 * lr:g}); BatchNorm statistics max|d| "
          f"{d['buffer_max']:.3e} ({d['buffer_ratio']:.3f} of the bound); {a['ms']:.1f} ms a "
          f"step against one process's {alone['ms']:.1f}; the group {seconds:.1f} s, "
          f"start-up included | {card}", flush=True)
    if again["identical"] and not d["identical"]:
        raise AssertionError("(a) one rank differs from one process, which repeats itself")
    check_bounds("(a)", d)

    # (b) two ranks over gloo on one card, then (c) their evaluation
    results, saved, seconds = ranks("gloo2", 2, True)
    for key in saved[0]:
        if not np.array_equal(saved[0][key], saved[1][key]) and not key.startswith("grad/"):
            raise AssertionError(f"(b) the ranks hold different {key}")
    d = dp_differences(arrays["alone"], saved[0])
    b = results[0]
    print(f"  (b) 2 ranks over {b['backend']}, both on {b['device']}, batch {b['batch']} each "
          f"of the global {TRAIN_BATCH}: loss {b['loss']:.6f} (relative {d['loss_rel']:.2e}, "
          f"bound {LOSS_TOL / 10:g}); parameters max|d| {d['param_err']:.3e} "
          f"({d['param_worst']}; bound {PARAM_TOL}) where the gradients agree in sign, "
          f"{d['flipped']} elements where not (max|d| {d['flip_err']:.3e}, bound 2 lr); "
          f"BatchNorm statistics max|d| {d['buffer_max']:.3e} ({d['buffer_ratio']:.3f} of "
          f"{BUFFER_TOL} (1 + |b|), {d['buffer_worst']}); the ranks bit for bit alike; ms a "
          f"step rank 0 {results[0]['ms']:.1f}, rank 1 {results[1]['ms']:.1f} against one "
          f"process's {alone['ms']:.1f}; launches a step each rank "
          f"{ {k: v for k, v in results[0]['launches'].items() if v} }; the group "
          f"{seconds:.1f} s, start-up included | {card}", flush=True)
    check_bounds("(b)", d)

    single = {k: float(v) for k, v in dp_eval(device, 1).items()}
    worst = max(abs(r["things"][k] - v) / max(abs(v), 1e-30) for r in results
                for k, v in single.items())
    print(f"  (c) 2 ranks, run_things over {DP_FRAMES} frames in global batches of "
          f"{TRAIN_BATCH} (rank 1's last slice empty): totals {results[0]['things']}, one "
          f"process at batch 1 {single}; max relative difference {worst:.2e} (bound "
          f"{SUM_TOL}: the same samples' sums added in another order)", flush=True)
    if not (results[0]["things"] == results[1]["things"] and set(single) == set(
            results[0]["things"]) and worst <= SUM_TOL):
        raise AssertionError("(c) the ranks' totals are not one process's")

    fresh_process(one_process, root, str(device), "alone_after")
    with open(f"{root}/dp/alone_after.json") as f:
        after = json.load(f)
    held("one process, after the ranks", after["launches"])
    print(f"  ms a step ({DP_TIMED} steps after {1 + DP_WARM}, each in a process of its own): "
          f"one process {alone['ms']:.1f} before the ranks and {after['ms']:.1f} after; (a) "
          f"one rank over NCCL {a['ms']:.1f}; (b) two ranks over gloo on the one card "
          f"{results[0]['ms']:.1f}, {results[1]['ms']:.1f} | {card}", flush=True)
    return total


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Proof that the port runs on one CUDA card.")
    parser.add_argument("--other", metavar="TREE",
                        help="another checkout (a parent unpacked by git archive into an "
                             "ignored directory, say) whose #1, #3, #6, #7, #12 and #13 "
                             "phase 3 times beside this tree's")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    try:
        from camliflow_torch.csrc import build as kbuild
        from camliflow_torch.models.camliraft import CamLiRAFT
        from camliflow_torch.models.camliraft_l import CamLiRAFTL
        from camliflow_torch.models.camlipwc import CamLiPWC
        from camliflow_torch.models.camlipwc_l import CamLiPWCL
        from camliflow_torch.models.pwc import PWC
        from camliflow_torch.models.raft import RAFT
        from camliflow_torch.runtime.checkpoint import random_weights
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
    print("[1/10] device:", torch.cuda.get_device_name(0), "| torch",
          torch.__version__, "| CUDA", torch.version.cuda, flush=True)
    card = smi[0] if smi else "nvidia-smi gave no output"
    print(card, flush=True)

    # 2. build
    print("[2/10] build", flush=True)
    try:
        path, seconds, log = kbuild.build()
        kbuild.library()
        for line in ptxas_summary(log):
            print("  ptxas:", line)
        print(f"  built {path.name} in {seconds:.1f} s", flush=True)
    except Exception:  # report and stop: nothing below can run unbuilt
        traceback.print_exc()
        return 1

    # 3. per-kernel parity
    print("[3/10] kernels vs plain versions at main-path shapes (a plain version "
          "repeats its kernel's arithmetic in PyTorch ops, cuDNN convolutions for "
          "the 2D chain, and is no yardstick of speed)", flush=True)
    kernels = []
    try:
        with torch.no_grad():  # the fused kernels and their packers are forward-only
            kernels = kernel_parity(device, other_tree(args.other) if args.other else None)
    except Exception:
        traceback.print_exc()
        failures.append("kernels")

    wrappers = kernel_wrappers()
    # per path, each kernel's launches per request (0: never on this path).
    # The encoders' PointConvs gather twice each (xyz, [xyz, features]):
    # CamLiRAFT-L runs 3 encoder passes of 2 PointConvs, the flagship 2 (both
    # frames share fnet's) and 2 gathers in the final upsample.
    point = {"furthest_point_sampling": 1, "correlation3d_knn": N_ITERS,
             "corr3d_tail": N_ITERS, "correlation3d_knn_index": 0}
    flagship = {**point, "k_nearest_neighbor": 8, "knn_interpolation": N_ITERS,
                "gather_points_kmajor": 10, "motion_encoder_2d": N_ITERS,
                "motion_encoder_3d": N_ITERS, "update_2d": 0}
    # with fuse_hidden, #8's halves run on their own (CLFM between them)
    halves = {"gru_2d": N_ITERS, "flow_head_2d": N_ITERS, "gru_flowhead_2d": 0}
    pwc_point = {**dict.fromkeys(wrappers, 0), "k_nearest_neighbor": 20,
                 "furthest_point_sampling": 1, "knn_interpolation": 9,
                 "gather_points_kmajor": 40}
    paths = (
        ("CamLiRAFT-L", CamLiRAFTL, L_CFGS, False,
         {**point, "k_nearest_neighbor": 6, "knn_interpolation": N_ITERS + 1,
          "gather_points_kmajor": 12, "motion_encoder_3d": N_ITERS,
          "gru_flowhead_3d": N_ITERS, "motion_encoder_2d": 0, "gru_flowhead_2d": 0,
          "gru_2d": 0, "flow_head_2d": 0, "update_2d": 0, "clfm_fused": 0, "dw_max": 0}),
        ("CamLiRAFT", CamLiRAFT, FLAGSHIP_CFGS, True,
         {**flagship, "clfm_fused": 2 * N_ITERS, "gru_flowhead_2d": N_ITERS, "gru_2d": 0,
          "flow_head_2d": 0, "gru_flowhead_3d": N_ITERS, "dw_max": 0}),
        # GRU3D and FlowHead3D as torch ops around their 4 PointConvDW tails
        ("CamLiRAFT fuse_hidden", CamLiRAFT, HIDDEN_CFGS, True,
         {**flagship, **halves, "clfm_fused": 3 * N_ITERS, "gru_flowhead_3d": 0,
          "dw_max": 4 * N_ITERS}),
        ("RAFT", RAFT, RAFT_CFGS, True,
         {**dict.fromkeys(wrappers, 0), "update_2d": N_ITERS}),
        # the PWC family (no refinement loop): the point side's KNN in each
        # pyramid PointConv (5 a frame) and twice a decoder level, #3 in the
        # level upsample and the backwarp (levels 4-1) and the final
        # upsample, #12 in 20 PointConvs; CamLiPWC adds 2 CLFM caches a level
        ("PWC", PWC, PWC_CFGS, True, dict.fromkeys(wrappers, 0)),
        ("CamLiPWC-L", CamLiPWCL, CAMLIPWC_L_CFGS, False, pwc_point),
        ("CamLiPWC", CamLiPWC, CAMLIPWC_CFGS, True,
         {**pwc_point, "k_nearest_neighbor": 30}),
    )
    total = dict.fromkeys(wrappers, 0)
    for label, cls, cfgs, images, per_request in paths:
        # 4. end to end
        has_points = cls not in (RAFT, PWC)
        iterative = cls in (CamLiRAFTL, CamLiRAFT, RAFT)
        points = f"{N_POINTS} pts, " if has_points else ""
        print(f"[4/10] {label} eval: {points}"
              f"{f'{IMAGE_W}x{IMAGE_H} images, ' if images else ''}"
              f"{f'{N_ITERS} iters, ' if iterative else ''}bs=1"
              f"{', IDS on' if has_points else ''}", flush=True)
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
            got = {k: launches[k] / 3 for k in per_request}
            if got != per_request:
                raise AssertionError(f"launches per request {got}, expected {per_request}")
            out = evaluator.forward(batches[0])
            if has_points:
                check_output(out, "flow_3d", (1, N_POINTS, 3))
            if images:
                check_output(out, "flow_2d", (1, IMAGE_H, IMAGE_W, 2))
            if iterative:
                profile_split(evaluator, batches[1])
            else:
                profile_request(evaluator, batches[1])
        except Exception:
            traceback.print_exc()
            failures.append(f"{label} end to end")
        try:  # the eval CLI's batch of 8
            drive_batch(label, evaluator, images, wrappers, per_request, card)
        except Exception:
            traceback.print_exc()
            failures.append(f"{label} bs={BATCH}")

        # 5. CUDA vs CPU
        print(f"[5/10] {label}: same weights and input on the CPU (plain versions)",
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

    # 6-8. this slice's paths: the lookahead, the KITTI submission, the demo
    flagship_request = next(per_request for label, _, _, _, per_request in paths
                            if label == "CamLiRAFT")
    print("[6/10] the Evaluator's one-batch lookahead against a synchronous loop: the "
          f"flagship, 4 batches of {BATCH} frame pairs", flush=True)
    try:
        lookahead_phase(device, card)
    except Exception:
        traceback.print_exc()
        failures.append("lookahead")
    print(f"[7/10] KITTI submission: {KITTI_FRAMES} synthetic frames at {KITTI_W}x{KITTI_H}, "
          f"the flagship, bs={BATCH}, {N_POINTS} pts, densified by #3", flush=True)
    try:
        launches = submission_phase(device, wrappers, flagship_request, card, kernels)
        for key, count in launches.items():
            total[key] += count
    except Exception:
        traceback.print_exc()
        failures.append("submission")
    print(f"[8/10] demo: a synthetic {IMAGE_W}x{IMAGE_H} pair with PFM disparities, the "
          "flagship, on the card and on the CPU", flush=True)
    try:
        launches = demo_phase(device, wrappers, flagship_request, card)
        for key, count in launches.items():
            total[key] += count
    except Exception:
        traceback.print_exc()
        failures.append("demo")
    print(f"[9/10] training: the flagship's Trainer at full width ({IMAGE_W}x{IMAGE_H}, "
          f"{N_POINTS} pts, {TRAIN_ITERS} iters, amp, augmentation), batches of {TRAIN_BATCH}, "
          f"{TRAIN_PAIRS} synthetic pairs; resume; an f32 step against the CPU", flush=True)
    try:
        launches = training_phase(device, wrappers, card)
        for key, count in launches.items():
            total[key] += count
    except Exception:
        traceback.print_exc()
        failures.append("training")
    import os

    root = os.path.join(WORK, "train")
    try:
        write_things_split(os.path.join(root, "data"), "train_small", FAMILY_PAIRS, SEED + 72)
        if not os.path.isdir(os.path.join(root, "data", "val")):
            write_things_split(os.path.join(root, "data"), "val", 4, SEED + 71)
    except Exception:
        traceback.print_exc()
        failures.append("training data")
    for family, want, branches in TRAIN_FAMILIES:
        print(f"[9/10] training {family}: its Trainer at full width (its own training config, "
              f"amp, augmentation), batches of {TRAIN_BATCH}, {FAMILY_PAIRS} synthetic pairs; "
              "an f32 step against the CPU", flush=True)
        try:
            launches = family_training_phase(device, wrappers, card, root, family, want,
                                             branches)
            for key, count in launches.items():
                total[key] += count
        except Exception:
            traceback.print_exc()
            failures.append(f"training {family}")
    kitti_root = os.path.join(WORK, "kitti_train")
    try:
        import shutil

        shutil.rmtree(kitti_root, ignore_errors=True)
        start = time.perf_counter()
        write_kitti_training_split(os.path.join(kitti_root, "data"), 6)
        print(f"  wrote 6 KITTI training frames at {KITTI_W}x{KITTI_H} in "
              f"{time.perf_counter() - start:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        failures.append("KITTI training data")
    for family, want, branches in KITTI_FINE_TUNES:
        print(f"[9/10] KITTI fine-tune {family}: its Trainer on conf/training/kitti/{family}.yaml "
              f"at full width (freeze_bn, amp, augmentation), batches of {TRAIN_BATCH}, "
              f"{KITTI_TRAIN_FRAMES} training and {KITTI_VAL_FRAMES} validation frames; an f32 "
              "step against the CPU", flush=True)
        try:
            start = time.perf_counter()
            launches = kitti_training_phase(device, wrappers, card, kitti_root, family, want,
                                            branches)
            for key, count in launches.items():
                total[key] += count
            print(f"  KITTI fine-tune {family}: {time.perf_counter() - start:.1f} s", flush=True)
        except Exception:
            traceback.print_exc()
            failures.append(f"KITTI fine-tune {family}")

    print(f"[10/10] data-parallel: the flagship's Trainer at full width ({IMAGE_W}x{IMAGE_H}, "
          f"{N_POINTS} pts, {TRAIN_ITERS} iters, f32), global batch {TRAIN_BATCH}: one process; "
          "(a) 1 rank over NCCL; (b) 2 ranks over gloo on the one card; (c) their run_things "
          f"over {DP_FRAMES} frames", flush=True)
    try:
        start = time.perf_counter()
        launches = data_parallel_phase(device, wrappers, card)
        for key, count in launches.items():
            total[key] += count
        print(f"  data-parallel: {time.perf_counter() - start:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        failures.append("data-parallel")

    # each kernel's launches over the paths' measured requests
    for entry in kernels:
        entry["launches"] = total[entry.pop("wrapper")]
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
