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
3. kernels: each of the thirteen kernels, and each fast form, against its
   plain PyTorch version on the card, at the shapes the main paths give it
   (and #8's two halves, which the fuse_hidden path launches, and the k-major gather on
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
   PointConvDW tail, k-major gather and 2D chain's bf16 forms are held to
   the plain versions too and timed beside this tree's, by device time in
   turns, the GRU + flow head held to this tree's bit for bit); the 2D
   chain's bf16 forms (#9, #8 and its halves, #10, on conv_tile_bf16.cuh)
   at bs 1 and 8, each twice bit for bit, #10 bit for bit #9 then #8, beside
   the same convs as a chain of bf16 cuDNN calls the port never makes; the k-major gather bit for bit at
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
   time, and at the eval CLI's batch of 8 by device time beside its bound
   (f32 and bf16 weights; with --other in turns); the RAFT iteration (#10)
   bit for bit the motion encoder then the GRU + flow head, by events,
   device time by launch and host time, beside
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
   timeout;
11. the fast path (fast_inference=on): CamLiRAFT-L, the flagship with
   fuse_hidden off and on, and RAFT at full width with phase 4's weights,
   at bs=1 (3 requests through run_things, launches held to the fast
   forms: #4's int8 form, #5 with the scale, #6, #7, #13 on bf16 weights,
   #8-#10 on the tile's bf16 mode) and at bs=8, each against the exact
   path on the same inputs (on the weights the fast path multiplies by,
   within 1e-2 px and 5e-3 m; on the f32 weights, within the JAX
   package's fast-vs-exact test bound), with request times and peak
   memory of both paths, then against the CPU's plain fast versions; and
   the eval CLI once with 'model.fast_inference="on"'. Phase 3 holds each
   fast form to its plain version too, timed beside its exact form.

12. the last modules: (a) a raw FlyingThings3D subset at 960x540 (9
   training and 3 validation frames: PFM disparities and disparity changes,
   .flo flows, occlusion PNGs, images) written with the port's writers and
   preprocessed by `python -m camliflow_torch.preprocess_flyingthings3d_subset`
   in both modes, its files checked (n_points, depth < 35 m, no NaN, the
   copies), seconds a frame pair; (b) the flagship's train step at full width
   through the Trainer on (a)'s output (augmentation off), stacked,
   loss_in_scan, remat_scan and both in turns, then stacked again, at
   batch 2 and 8, f32 and amp, from the same weights on the same batch:
   each held to stacked (loss within 1e-5 relative, every gradient within
   1e-3 (1 + max|g|), BatchNorm statistics within 1e-6 (1 + |b|)), each
   remat setting to its setting without remat bit for bit where the stacked
   step repeats itself bit for bit, launches a step held (#1 8, #2 1, #3 and
   #4 index-only 10), ms a step and peak memory; (c) PointNet2 (8192 -> 4096
   points, k 16), FusionAwareInterpCVPR, FusionAwareInterp (k 3, no cache)
   and CLFM with the add, concat and gated heads at CamLiPWC's level-1
   shapes (144x240 pixels, 4096 points), InstanceNorm and LayerNorm at
   68x120x128: the card against the CPU, #1's launches held.
13. the JAX package's gated operand forms, each path with its switches set
   in this process around its runs and restored after them: CamLiRAFT-L
   with CAMLIFLOW_UPDATE3D=1 (#6 and #7 on int8 hoisted weights), the
   flagship with CAMLIFLOW_UPDATE3D=1 and CAMLIFLOW_CLFM=1 (and #11's bf16
   form at corr and motion), the flagship with fuse_hidden and
   CAMLIFLOW_CLFM=1, fast_inference=on, at full width on phase 4's weights
   and inputs: launches held (#6 and #7's int8 forms 20 each a request,
   #11's bf16 form 40, fuse_hidden's exact hidden fusion 20), against the
   CPU's plain version of the same form at bs=1, and on the two int8 paths
   at bs=2 too, where the int8 scales are the batch's (phase 5's envelope),
   against the fast form at bs=1 and 8 (the JAX package's fast-vs-exact
   test bound), at bs=8 each sample against the same sample alone (phase
   5's envelope with CAMLIFLOW_CLFM alone; on the int8 paths, whose scales
   are the batch's, 0.02 m and 5e-3 px), request ms and peak memory beside
   the fast form's. Phase 3 holds each gated form to its plain version
   within one bf16 step and times it beside its fast form.

Each path's launches (4, 7, 8, 9, 10, 11, 12 and 13) are counted with every counter
zeroed just before it and read just after. Each phase's header ends with
the seconds since the start. Prints its total time, the kernels' JSON line, then the card's name and power limit, then, as
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
from typing import NamedTuple

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
PEAK_BF16 = 989e12  # H100 SXM bf16 on the tensor cores, dense, op/s
TC_MMA = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, 3xTF32"  # conv_tile_tc.cuh
BF16_MMA = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"  # the tile's bf16 mode
WGMMA_BF16 = "wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16"  # conv_tile_bf16.cuh
# the fast path (fast_inference=on): each fast form against its plain version,
# max|kernel - plain| <= FAST_TOL * (1 + max|plain|) (bf16 roundings after
# sums in another order can flip: about two bf16 steps of the largest value).
# Fast against exact on the same inputs, two ways (phase 11):
# - against the exact path on the weights the fast path multiplies by (the
#   convs it packs to bf16, rounded: bf16_packed_convs), within the JAX
#   package's on-hardware gate (tools/measure_model.py numerics). Its exact
#   reference ran on the TPU, whose f32 convolutions take bf16 operands by
#   default (DEFAULT precision), so it shared those rounded weights;
# - against the f32 exact path within the JAX package's fast-vs-exact test
#   bound, whose exact reference is f32 (its CPU tests): max(floor, 2% of the
#   flow's largest magnitude). The rounded weights alone move the flagship's
#   2D flow by ~8e-3 px over 20 iterations (a fixed perturbation of the
#   model, each iteration's delta alike).
FAST_TOL = 2.0**-6
FAST_2D_TOL = 1e-2  # px
FAST_3D_TOL = 5e-3  # m
FAST_2D_FLOOR, FAST_3D_FLOOR, FAST_SHARE = 0.15, 0.02, 0.02  # px, m, of the scale
# each kernel with a fast form: its exact wrapper's name -> the fast form's
# (#8's halves keep their exact forms on the main paths: with fuse_hidden the
# fast path runs GRU2D and FlowHead2D exact, as the JAX package's does)
FAST_FORMS = {"correlation3d_knn": "correlation3d_knn_int8",
              "corr3d_tail": "corr3d_tail_scaled",
              "motion_encoder_3d": "motion_encoder_3d_bf16",
              "gru_flowhead_3d": "gru_flowhead_3d_bf16",
              "dw_max": "dw_max_bf16",
              "motion_encoder_2d": "motion_encoder_2d_bf16",
              "gru_flowhead_2d": "gru_flowhead_2d_bf16",
              "update_2d": "update_2d_bf16"}
# the JAX package's gated operand forms (phase 13), each counted on its
# wrapper's own counter: name -> (the wrapper's name, the counter)
GATED_FORMS = {"motion_encoder_3d_int8": ("motion_encoder_3d", "int8_launches"),
               "gru_flowhead_3d_int8": ("gru_flowhead_3d", "int8_launches"),
               "clfm_fused_bf16": ("clfm_fused", "fast_launches")}
GATED_TOL = 2.0**-7  # a gated form against its plain version: one bf16 step of the largest value
SK_MEAN_TOL = 2.0**-14  # #11's SK mean against its plain version, of its largest value
SK_WEIGHT_TOL = 2.0**-12  # #11's SK pair weights (values near 1/2) against their plain ones
TC_STAGES = 3  # conv_tile_tc.cuh's kStages


def b16_smem_bytes(bn: int) -> int:
    """conv_tile_bf16.cuh's B16Shape<BN>::kSmemBytes: its ring of A (8 KB) and
    B (BN x 128 bytes) stages, 160 KB of them at BN >= 192, else 6 or 8
    stages; the gather's 64 KB of staging; the barriers; 1 KB to align."""
    stage = 64 * 128 + bn * 128
    stages = 160 * 1024 // stage if bn >= 192 else (6 if bn >= 128 else 8)
    return stages * stage + 64 * 1024 + 2 * stages * 8 + 1024


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
BATCH_TURNS = 5  # phase 11's bs-8 requests on each path


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


def sk_close(name: str, got, ref) -> None:
    """#11's SK state (`ops.clfm.sk_state`: each side's mean of a + b over its
    rows, from the column sums the kernel wrote by tile, and the pair
    weights its heads wrote) against the plain version's: the means within
    SK_MEAN_TOL * max |mean|, the weights within SK_WEIGHT_TOL. A tile's sums
    missing at 68 x 120 (one of 128) move the mean by ~1/128 of its size and
    another batch item's sums by far more; one bf16 step of a rounded mean
    moves a weight by up to ~7e-5."""
    for side, (mean, weights), (mean_ref, weights_ref) in zip(("2D", "3D"), got, ref):
        d_mean = float((mean - mean_ref).abs().max())
        limit = SK_MEAN_TOL * float(mean_ref.abs().max())
        d_w = float((weights - weights_ref).abs().max())
        print(f"  {name} SK {side}: max |mean - plain| {d_mean:.3e} (bound {limit:.3e}), "
              f"max |weight - plain| {d_w:.3e} (bound {SK_WEIGHT_TOL:.3e})")
        if not (d_mean <= limit and d_w <= SK_WEIGHT_TOL):
            raise AssertionError(f"{name}: the SK {side} side's mean or weights stray")


def distinct_items(x):
    """x [B, ...] with batch item k scaled by 1 + k / 4 and shifted by k / 4,
    so that no two items share an SK mean."""
    import torch

    k = torch.arange(x.shape[0], dtype=x.dtype, device=x.device).view(-1, *(1,) * (x.dim() - 1))
    return x * (1 + 0.25 * k) + 0.25 * k


def gated_close(name: str, got, ref) -> float:
    """A gated form (CAMLIFLOW_UPDATE3D=1's int8 #6 and #7, CAMLIFLOW_CLFM=1's
    bf16 #11) against its plain version: max |got - ref| within GATED_TOL *
    max |ref| (one bf16 step); prints it and the share of values equal bit
    for bit. Returns the max."""
    err = float((got - ref).abs().max())
    limit = GATED_TOL * float(ref.abs().max())
    same = float((got == ref).float().mean())
    print(f"  {name}: max |kernel - plain| {err:.3e} (bound {limit:.3e}), "
          f"{100 * same:.2f}% of values bit for bit")
    if not err <= limit:
        raise AssertionError(f"{name}: max |d| {err} > {limit}")
    return err


def fast_close(name: str, got, ref) -> float:
    """A fast form against its plain version: max |got - ref| within
    FAST_TOL * (1 + max |ref|); prints it and the share of values equal bit
    for bit. Returns the max."""
    err = float((got - ref).abs().max())
    limit = FAST_TOL * (1.0 + float(ref.abs().max()))
    same = float((got == ref).float().mean())
    print(f"  {name}: max |kernel - plain| {err:.3e} (bound {limit:.3e}), "
          f"{100 * same:.2f}% of values bit for bit")
    if not err <= limit:
        raise AssertionError(f"{name}: max |d| {err} > {limit}")
    return err


PROFILE_TRIES = 6  # the profiler on the H100 drops all or part of a run's events, now and then


class KernelTime(NamedTuple):
    """One kernel's entry in a profile, as `key_averages()` gives it: its
    name, its launches and their device time (µs)."""

    key: str
    count: int
    self_device_time_total: float


def device_kernels(prof, only: str = "") -> list[KernelTime]:
    """The device kernels of a finished torch.profiler run whose name holds
    `only`, grouped by name, with the names, counts and device times that
    `prof.key_averages()` gives them, read from the profiler's raw events:
    `key_averages()` first builds an event tree over every host op, which
    takes tens of seconds for a request of thousands of launches."""
    import torch

    names, counts, times = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA or e.is_async()
                or e.start_thread_id() != e.end_thread_id()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        raw = e.name()
        if raw not in names:  # key_averages' key: the demangled name
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        name = names[raw]
        if only in name:
            counts[name] = counts.get(name, 0) + 1
            times[name] = times.get(name, 0.0) + (e.end_ns() - e.start_ns()) / 1e3
    return [KernelTime(name, counts[name], times[name]) for name in counts]


def profile_whole(seen: int, earlier: list[int], partial: bool = False) -> bool:
    """Whether a profile that recorded `seen` launches is taken as whole
    (profile_kernels), after profiles of the same run that recorded
    `earlier`: it kept a launch, and with `partial` that is all; else some
    earlier profile that kept a launch agrees with it within 1%."""
    return bool(seen) and (partial or any(abs(seen - e) <= e // 100 for e in earlier if e))


def profile_kernels(fn, only: str = "", partial: bool = False) -> tuple[float, list]:
    """fn() under torch.profiler: (wall ms, the device kernels it launched
    whose name holds `only`). A profile is taken as whole when it holds as
    many launches as an earlier profile of fn(), within 1%: over thousands
    of launches the profiles of one run differ by a few, while one that
    lost part of its events lost far more, and two losses seldom agree.
    Any earlier profile, not only the one before: where the profiler loses
    part of every other profile, the whole ones agree with each other. With
    `partial`, any profile that kept a launch will do (the caller averages
    over the launches it kept). Another profile is taken until one does, up
    to PROFILE_TRIES; then it raises, so no device time is ever reported
    that was not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    named = f" named {only}" if only else ""
    earlier = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - start)
        kernels = device_kernels(prof, only)
        seen = sum(e.count for e in kernels)
        if profile_whole(seen, earlier, partial):
            return wall, kernels
        if earlier or not seen:
            against = f", the ones before {earlier}" if earlier else ""
            print(f"  (profile {attempt + 1} of {PROFILE_TRIES} recorded {seen} kernel launches"
                  f"{named}{against})", flush=True)
        earlier.append(seen)
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
    """Another checkout's wrappers of #1, #3, the 3D chain (#6, #7, #13),
    #12, the 2D chain (#8-#10) and CLFM (#11): its ops.knn, ops.interp,
    ops.update3d, models.camliraft_l (whose modules hoist the weights as its
    wrappers take them), ops.gather, ops.update2d and ops.clfm, to time
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
                                "ops.gather", "ops.update2d", "ops.clfm"))


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
            elif name.startswith("conv_bf16_kernel<"):  # <BN, producer warpgroups, epilogue>
                bn = int(re.findall(r"\d+", name.split("<", 1)[1])[0])
                used += f", {b16_smem_bytes(bn)} bytes dynamic smem"
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


def fast_2d_forms(device, gen, blocks, inputs, exact, other, record) -> None:
    """Phase 3's 2D chain in bf16 (#9, #8 and its halves, #10) on
    conv_tile_bf16.cuh's wgmma tile, at the flagship's 1/8 map, bs 1 and
    BATCH; `inputs` the bs-1 (flow, corr, h, x2d, motion), `exact` the exact
    packings and #10's exact call, timed beside; `record` kernel_parity's."""
    import torch

    from camliflow_torch.ops import update2d

    encoder, gru, head = blocks
    flow2d, corr, h, x2d, motion = inputs
    me, gf, fused = exact
    feat_h, feat_w = flow2d.shape[1:3]
    pixels = feat_h * feat_w

    def mean(times):
        return sum(times) / len(times)

    def beside(times):  # each reading, where the other tree's stand beside
        if "other" not in times:
            return ""
        this, theirs = (", ".join(f"{t:.4f}" for t in times[key]) for key in ("this", "other"))
        return f" ({this}); other tree {theirs} ms"

    # the fast path's forms on conv_tile_bf16.cuh's wgmma tile (bf16
    # weight planes, bf16 intermediates), each against its plain bf16
    # version (FAST_TOL) at bs 1 and 8; #10 bit for bit #9 then #8 and
    # two runs bit for bit; device time by profiler beside the other
    # tree's forms (in turns, other, this, this, other) and beside a
    # yardstick the port never calls: the same convs alone as cuDNN bf16
    # channels-last F.conv2d calls
    me16, gf16 = update2d.prepare_update_2d_params(encoder, gru, head, bf16=True)
    gp16 = {k: gf16[k] for k in update2d.GRU_CONVS}
    hp16 = {k: gf16[k] for k in update2d.HEAD_CONVS}
    if other:
        me_o, gf_o = other[5].prepare_update_2d_params(encoder, gru, head, bf16=True)
        gp_o = {k: gf_o[k] for k in update2d.GRU_CONVS}
        hp_o = {k: gf_o[k] for k in update2d.HEAD_CONVS}
    convs16 = {key: conv for p in (me16, gf16) for key, conv in p.items() if key != "conv_f1"}
    me_keys, gru_keys, head_keys = (list(update2d.ME_CONVS), list(update2d.GRU_CONVS),
                                    list(update2d.HEAD_CONVS))
    form_convs = {"motion_encoder_2d": me_keys, "gru_flowhead_2d": gru_keys + head_keys,
                  "gru_2d": gru_keys, "flow_head_2d": head_keys,
                  "update_2d": me_keys + gru_keys + head_keys}

    def cudnn_chain(keys, batch):
        """The convs `keys` alone, as bf16 channels-last F.conv2d calls
        with their biases on inputs of their shapes: a chain of
        len(keys) cuDNN calls, no epilogue, concat or rounding."""
        import torch.nn.functional as F

        calls = []
        for key in keys:
            conv = convs16[key]
            weight = conv.oihw().to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            bias = conv.bias[: conv.cout].to(torch.bfloat16)
            x = torch.randn(batch, conv.cin, feat_h, feat_w, generator=gen, device=device)
            x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            calls.append((x, weight, bias, ((conv.kh - 1) // 2, (conv.kw - 1) // 2)))
        return lambda: [F.conv2d(x, w, b, padding=pad) for x, w, b, pad in calls]

    weights16 = {key: 2 * conv.kh * conv.kw * conv.cin * conv.cout + 4 * conv.cout
                 for key, conv in convs16.items()}  # bf16 weights, f32 biases
    macs16 = {"motion_encoder_2d": 324 * 256 + 9 * 256 * 192 + 9 * 128 * 64 + 9 * 256 * 126,
              "gru_2d": 2 * 5 * 384 * (256 + 128), "flow_head_2d": 9 * 128 * 256 + 9 * 256 * 2}
    macs16["gru_flowhead_2d"] = macs16["gru_2d"] + macs16["flow_head_2d"]
    macs16["update_2d"] = macs16["motion_encoder_2d"] + macs16["gru_flowhead_2d"]
    # f32 values read and written a pixel: each input once, each output once
    floats16 = {"motion_encoder_2d": 2 + 324 + 128 + 128, "gru_2d": 3 * 128 + 128,
                "flow_head_2d": 128 + 2, "gru_flowhead_2d": 3 * 128 + 128 + 2,
                "update_2d": 2 * 128 + 2 + 324 + 128 + 128 + 2}
    fast2d = {}  # form -> {batch: measurements}
    for batch in (1, BATCH):
        if batch == 1:
            fl, co, hb, xb, mb = flow2d, corr, h, x2d, motion
        else:
            def rand_b(channels, scale=1.0):
                return scale * torch.randn(batch, feat_h, feat_w, channels, generator=gen,
                                           device=device)

            fl, co = rand_b(2, 2.0), rand_b(324)
            hb, xb, mb = torch.tanh(rand_b(128)), torch.relu(rand_b(128)), rand_b(128)
        mo = update2d.motion_encoder_2d(fl, co, me16)
        if not torch.equal(mo[..., -2:], fl):
            raise AssertionError("motion_encoder_2d (bf16): the flow tail is not the flow")
        forms = {  # this tree's call, the other tree's, the plain version
            "motion_encoder_2d": (
                lambda: update2d.motion_encoder_2d(fl, co, me16),
                other and (lambda: other[5].motion_encoder_2d(fl, co, me_o)),
                lambda: update2d.motion_encoder_2d_plain(fl, co, me16)),
            "gru_flowhead_2d": (
                lambda: update2d.gru_flowhead_2d(hb, xb, mb, gf16),
                other and (lambda: other[5].gru_flowhead_2d(hb, xb, mb, gf_o)),
                lambda: update2d.gru_flowhead_2d_plain(hb, xb, mb, gf16)),
            "gru_2d": (
                lambda: update2d.gru_2d(hb, xb, mb, gp16),
                other and (lambda: other[5].gru_2d(hb, xb, mb, gp_o)),
                lambda: update2d.gru_2d_plain(hb, torch.cat([xb, mb], dim=-1), gp16)),
            "flow_head_2d": (
                lambda: update2d.flow_head_2d(hb, hp16),
                other and (lambda: other[5].flow_head_2d(hb, hp_o)),
                lambda: update2d.flow_head_2d_plain(hb, hp16)),
            "update_2d": (
                lambda: update2d.update_2d(hb, xb, fl, co, me16, gf16),
                other and (lambda: other[5].update_2d(hb, xb, fl, co, me_o, gf_o)),
                lambda: update2d.update_2d_plain(hb, xb, fl, co, me16, gf16)),
        }
        h_c, d_c = update2d.gru_flowhead_2d(hb, xb, mo, gf16)
        h_k, d_k = update2d.update_2d(hb, xb, fl, co, me16, gf16)
        if not (torch.equal(h_k, h_c) and torch.equal(d_k, d_c)):
            raise AssertionError(f"update_2d (bf16) bs {batch}: not bit for bit the chain "
                                 "motion_encoder_2d + gru_flowhead_2d")
        if not torch.equal(h_k, h_k.bfloat16().float()):
            raise AssertionError("update_2d (bf16): h' is not bf16-valued")
        for name, (fn, fn_other, plain) in forms.items():
            got, ref = fn(), plain()
            got, ref = (got if isinstance(got, tuple) else (got,)), \
                (ref if isinstance(ref, tuple) else (ref,))
            parts = ("h'", "delta") if len(got) > 1 else ("",)
            err = max(fast_close(f"{name} (bf16) bs {batch}{' ' if part else ''}{part}", g, r)
                      for part, g, r in zip(parts, got, ref))
            for _ in range(2):
                again = fn()
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, g) for a, g in zip(again, got)):
                    raise AssertionError(f"{name} (bf16) bs {batch}: two runs give "
                                         "different bits")
            calls = {"this": fn} if not other else {"other": fn_other, "this": fn}
            times = in_turns(calls, 10, "")
            keys = form_convs[name]
            chain = cudnn_chain(keys, batch)
            px = batch * pixels
            fast2d.setdefault(name, {})[batch] = m = {
                "err": err, "ms": time_ms(fn, 20), "device_ms": mean(times["this"]),
                "device_ms_each": times["this"], "plain_ms": time_ms(plain, 5),
                "library_ms": time_ms(chain, 20), "library_device_ms": device_ms(chain, 10),
                "library_calls": len(keys),
                "other_device_ms_each": times.get("other"),
                "ops": 2 * px * macs16[name],
                "bytes": 4 * px * floats16[name] + sum(weights16[k] for k in keys)}
            m["bound_ms"], m["bound_by"] = bound(m["ops"], m["bytes"], PEAK_BF16)
            print(f"  {name} (bf16) bs {batch}: device {m['device_ms']:.4f} ms{beside(times)}"
                  f"; events {m['ms']:.4f}; bound {m['bound_ms']:.4f} ({m['bound_by']}); "
                  f"cuDNN bf16 channels-last chain of its {len(keys)} convs alone (the port "
                  f"never calls it) {m['library_ms']:.4f} events, "
                  f"{m['library_device_ms']:.4f} device", flush=True)
        steps = stage_ms(forms["update_2d"][0], 10)
        fast2d["update_2d"][batch]["steps_ms"] = [ms for _, ms in steps]
        print(f"  update_2d (bf16) bs {batch} device time by launch (profiler): " +
              ", ".join(f"{short_name(k)} {ms:.4f}" for k, ms in steps), flush=True)

    exact_ms = {"motion_encoder_2d": time_ms(lambda: update2d.motion_encoder_2d(
                    flow2d, corr, me), 20),
                "gru_flowhead_2d": time_ms(lambda: update2d.gru_flowhead_2d(
                    h, x2d, motion, gf), 20),
                "update_2d": time_ms(fused, 20)}
    for name, replaces in (("motion_encoder_2d", "camliflow_tpu/ops/pallas_update2d.py:461"),
                           ("gru_flowhead_2d", "camliflow_tpu/ops/pallas_update2d.py:235"),
                           ("gru_2d", "camliflow_tpu/ops/pallas_update2d.py:235"),
                           ("flow_head_2d", "camliflow_tpu/ops/pallas_update2d.py:235"),
                           ("update_2d", "camliflow_tpu/ops/pallas_update2d.py:514")):
        one, eight = fast2d[name][1], fast2d[name][BATCH]
        extra = {f"bs{BATCH}_{key}": value for key, value in eight.items()
                 if key not in ("err", "ops", "bytes")}
        if name in exact_ms:
            extra["exact_form_ms"] = exact_ms[name]
        record(f"{name} (bf16)", "camliflow_torch/csrc/conv_tile_bf16.cuh", replaces,
               max(one["err"], eight["err"]), one["ms"], one["plain_ms"], one["ops"],
               one["bytes"], bf16_cores=True, mma=WGMMA_BF16,
               entry=name not in ("gru_2d", "flow_head_2d"), wrapper=f"{name}_bf16",
               library_ms=one["library_ms"],
               library=f"cuDNN bf16 channels-last: the {one['library_calls']} convs alone "
                       "as that many F.conv2d calls (no epilogue, concat or rounding); "
                       "a yardstick the port never calls",
               device_ms=one["device_ms"], device_ms_each=one["device_ms_each"],
               library_device_ms=one["library_device_ms"],
               other_device_ms_each=one["other_device_ms_each"],
               **({"steps_ms": one["steps_ms"]} if "steps_ms" in one else {}), **extra)


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
    from camliflow_torch.ops.geometry import quantize_rows_int8
    from camliflow_torch.runtime.checkpoint import random_weights

    both = main_path_clouds(device)  # [2, 8192, 3]
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = []

    def record(name, source, replaces, err, ms, plain_ms, ops, nbytes, label=None,
               entry=True, wrapper=None, library_ms=None, tensor_cores=False,
               bf16_cores=False, **extra):
        """Print one measurement (as `label`); `entry` adds it to the kernels
        JSON line, whose launches are those of `wrapper` (default `name`).
        `library_ms`: one PyTorch call that computes the same function.
        `tensor_cores`: f32 work done on the tensor cores by the 3xTF32
        split, whose least time is 3 TF32 operations per f32 operation at
        the TF32 peak (bound_ms; the f32 bound outside the tensor cores
        beside it). `bf16_cores`: bf16 operands on the tensor cores, one
        pass, at the bf16 peak. `extra`: more keys of the entry."""
        bound_ms, bound_by = bound(ops, nbytes)
        if tensor_cores:
            extra = {"bound_f32_ms": bound_ms, "mma": TC_MMA, **extra}
            bound_ms, bound_by = bound(3 * ops, nbytes, PEAK_TF32)
        if bf16_cores:
            extra = {"bound_f32_ms": bound_ms, "mma": BF16_MMA, **extra}
            bound_ms, bound_by = bound(ops, nbytes, PEAK_BF16)
        if entry:
            results.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": 0, "max_abs_err": err,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms,
                            "wrapper": wrapper or name, **extra})
        library = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        f32 = f", f32 {extra['bound_f32_ms']:.4f} ms" if tensor_cores or bf16_cores else ""
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

    # its int8 form (the fast path's pyramid, a scale a query row), on the
    # random and the tied clouds: the f32 form's indices and the plain
    # version's, bit for bit, the selected int8 values as f32 exactly
    q8, q_scale = quantize_rows_int8(pyramid)
    for query, support in ((xyz1, xyz2_warp), (tied_1, tied_2)):
        got = corr3d.correlation3d_knn(query, support, q8, sizes, 16)
        ref = corr3d.correlation3d_knn_plain(query, support, q8, sizes, 16)
        full = corr3d.correlation3d_knn(query, support, pyramid, sizes, 16)[0]
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[0], full)
                and torch.equal(got[1], ref[1])):
            raise AssertionError("corr3d int8: indices or costs differ from the plain version "
                                 "or the f32 form's")
    cost8 = corr3d.correlation3d_knn(xyz1, xyz2_warp, q8, sizes, 16)[1]
    select8 = lambda: corr3d.correlation3d_knn(xyz1, xyz2_warp, q8, sizes, 16)  # noqa: E731
    dev8 = device_ms(select8, 20, only="corr3d_kernel")
    dev32 = device_ms(select, 20, only="corr3d_kernel")
    print(f"  corr3d int8: device {dev8:.4f} ms a call, the f32 form {dev32:.4f} ms", flush=True)
    record("correlation3d_knn (int8)", "camliflow_torch/csrc/corr3d.cu",
           "camliflow_tpu/ops/pallas_corr3d.py:440", 0.0, time_ms(select8, 50),
           time_ms(lambda: corr3d.correlation3d_knn_plain(
               xyz1, xyz2_warp, q8, sizes, 16), 20),
           m * m * 9,
           # the points, the selected int8 entries, indices and f32 costs out
           4 * 2 * m * 3 + n_sel * (1 + 4 + 4),
           wrapper="correlation3d_knn_int8", device_ms=dev8, f32_form_device_ms=dev32,
           f32_form_ms=time_ms(select, 50))

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

        fast_2d_forms(device, gen, (encoder, gru, head), (flow2d, corr, h, x2d, motion),
                      (me, gf, fused), other, record)

    # the 3D update chain at the loop's 2048 points, k=32 neighbours, and at
    # the eval CLI's batch of 8 frame pairs (16,384 points): each form of #6
    # and #7 (f32, the fast path's bf16, the gated int8) held to its plain
    # version, to itself on a rerun and, with another tree, to that tree's
    # same form bit for bit; profiler device time in turns with it (other,
    # this, this, other) and by launch
    blocks = nn.ModuleList([MotionEncoder3D(), GRU3D(), FlowHead3D()])
    random_weights(blocks, SEED + 8)
    encoder, gru, head = blocks.to(device)
    if other:  # its own module hoists #6's weights in its own layout
        other_encoder = other[3].MotionEncoder3D().to(device)
        other_encoder.load_state_dict(encoder.state_dict())
    n = N_SAMPLES[1]
    with torch.inference_mode():
        idx = knn.k_nearest_neighbor(xyz1, xyz1, 32)
        xyz8 = xyz1.repeat(8, 1, 1).contiguous()
        idx8 = knn.k_nearest_neighbor(xyz8, xyz8, 32)

        def rand3(channels, scale=1.0):
            return scale * torch.randn(1, n, channels, generator=gen, device=device)

        def linear_macs(params):
            return sum(p.cin * p.cout for p in params.values())

        def dw_floats(dw):
            return sum(w[0, 0].numel() for w in dw.values())

        def hoisted(xyz, knn_idx):
            """The hoisted weights, each tree's #6's in its own layout: (this
            tree's #6's, #7's, the other tree's #6's or None)."""
            return (encoder.precompute_weights(xyz, knn_idx),
                    {**gru.precompute_weights(xyz, knn_idx),
                     **head.precompute_weights(xyz, knn_idx)},
                    other_encoder.precompute_weights(xyz, knn_idx) if other else None)

        def outputs(out):
            return out if isinstance(out, tuple) else (out,)

        def differ(a, b):
            """Which outputs of two calls differ in their bits, each with the
            share of values that do."""
            return ", ".join(
                f"output {i}: {100 * float((x.view(torch.int32) != y.view(torch.int32)).float().mean()):.3f}%"
                for i, (x, y) in enumerate(zip(outputs(a), outputs(b)))
                if not torch.equal(x.view(torch.int32), y.view(torch.int32)))

        def drive(label, calls, plain, close, only, reps, split=True, flow=None):
            """One form at one size: this tree's output held to the plain
            version by `close`, to itself on a rerun and to the other tree's
            bit for bit, and (#6's) its last three columns to `flow` bit for
            bit; device time in turns and (`split`) by launch.
            Returns (max error, {tree: device ms each turn}, [(kernel, ms)])."""
            got = calls["this"]()
            if flow is not None and not torch.equal(got[..., -3:], flow):
                raise AssertionError(f"{label}: the flow columns differ")
            err = max(close(f"{label}{' ' + part if len(outputs(got)) > 1 else ''}", g, r)
                      for part, g, r in zip(("h'", "delta"), outputs(got), outputs(plain)))
            wrong = differ(calls["this"](), got)
            if wrong:
                raise AssertionError(f"{label}: two runs give different bits ({wrong})")
            wrong = differ(calls["other"](), got) if "other" in calls else ""
            if wrong:
                raise AssertionError(f"{label}: not the other tree's bits ({wrong})")
            times = in_turns(calls, reps, only)
            steps = stage_ms(calls["this"], reps) if split else []
            print(f"  {label}: device {mean(times['this']):.4f} ms a call{beside(times)}"
                  f"{'; the other tree bit for bit' if 'other' in calls else ''}"
                  + ("; by launch " if steps else "")
                  + ", ".join(f"{short_name(k)} {ms:.4f}" for k, ms in steps), flush=True)
            return err, times, steps

        def trees(this, theirs):
            return {"other": theirs, "this": this} if other else {"this": this}

        def measured(times, steps, bs):
            return {f"device_ms_bs{bs}": mean(times["this"]),
                    f"steps_ms_bs{bs}": [ms for _, ms in steps],
                    **({f"other_device_ms_bs{bs}": mean(times["other"])} if other else {})}

        flow3d, corr3 = rand3(3, 0.05), rand3(128)
        h3, x3 = torch.tanh(rand3(128)), torch.relu(rand3(128))
        me3 = update3d.prepare_motion_encoder_3d_params(encoder)
        gf3 = update3d.prepare_gru_flowhead_3d_params(gru, head)
        me_other = other[2].prepare_motion_encoder_3d_params(other_encoder) if other else None
        gf_other = other[2].prepare_gru_flowhead_3d_params(gru, head) if other else None
        me_weights = sum(size(me3[k]) for k in update3d.ME_CONVS)
        keys = ("zr", "q", "conv1", "conv2", "fc")  # #7's own layers
        gf_weights = sum(size(gf3[k]) for k in keys)
        dw_me, dw_gf, dw_me_other = hoisted(xyz1, idx)
        me_floats = sum(dw_me[k].shape[2] * me3[k].cout for k in update3d.ME_CONVS)  # 5,328
        gf_floats = dw_floats(dw_gf)  # 7,680
        me_ops = 2 * n * (linear_macs({k: me3[k] for k in update3d.ME_CONVS}) + me_floats)
        gf_ops = 2 * n * (sum(gf3[k].cin * gf3[k].cout for k in keys) + gf_floats)
        # bytes: points (inputs, neighbours as int32, outputs) and the MLPs
        # in f32, the hoisted weights (unpadded) at their dtype's size
        me_io, gf_io = 4 * n * (3 + 128 + 32 + 128), 4 * n * (3 * 128 + 32 + 128 + 3)

        # the exact forms (f32), at bs 1 and 8
        me_in = {1: (flow3d, corr3, idx), 8: (flow3d.repeat(8, 1, 1), corr3.repeat(8, 1, 1), idx8)}
        motion3 = update3d.motion_encoder_3d(*me_in[1], dw_me, me3)
        if not torch.equal(motion3[..., -3:], flow3d):
            raise AssertionError("motion_encoder_3d: the flow columns differ")
        gf_in = {1: (h3, x3, motion3, idx),
                 8: (h3.repeat(8, 1, 1), x3.repeat(8, 1, 1), motion3.repeat(8, 1, 1), idx8)}
        dws = {1: (dw_me, dw_gf, dw_me_other), 8: hoisted(xyz8, idx8)}
        forms = {}  # (form, bs) -> (err, times, steps)

        def run_forms(form, convert, me_p, gf_p, me_o, gf_o, close, sizes):
            """#6's and #7's `form` at each of `sizes`, its hoisted weights
            made by `convert(tree)` of the f32 ones."""
            for bs in sizes:
                d_me, d_gf, d_other = dws[bs]
                d_me, d_gf = convert(update3d)(d_me), convert(update3d)(d_gf)
                d_other = convert(other[2])(d_other) if other else None
                me_calls = trees(lambda: update3d.motion_encoder_3d(*me_in[bs], d_me, me_p),
                                 lambda: other[2].motion_encoder_3d(*me_in[bs], d_other, me_o))
                forms[("me", form, bs)] = drive(
                    f"motion_encoder_3d{form} bs={bs}", me_calls,
                    update3d.motion_encoder_3d_plain(*me_in[bs], d_me, me_p), close,
                    "motion_encoder_3d", 20 if bs == 1 else 10, flow=me_in[bs][0])
                gf_calls = trees(lambda: update3d.gru_flowhead_3d(*gf_in[bs], d_gf, gf_p),
                                 lambda: other[2].gru_flowhead_3d(*gf_in[bs], d_gf, gf_o))
                forms[("gf", form, bs)] = drive(
                    f"gru_flowhead_3d{form} bs={bs}", gf_calls,
                    update3d.gru_flowhead_3d_plain(*gf_in[bs], d_gf, gf_p), close,
                    "gru_flowhead_3d", 20 if bs == 1 else 10)
            return me_calls, gf_calls  # the last size's

        me_call, gf_call = (c["this"] for c in run_forms(
            "", lambda tree: lambda d: d, me3, gf3, me_other, gf_other, check, (8, 1)))
        me_host = host_ms(me_call, 20)
        gf_host = host_ms(gf_call, 20)
        print(f"  host: motion_encoder_3d {me_host:.4f}, gru_flowhead_3d {gf_host:.4f} ms a call")
        err, times, steps = forms[("me", "", 1)]
        record("motion_encoder_3d", "camliflow_torch/csrc/update3d.cu",
               "camliflow_tpu/ops/pallas_update3d.py:248", err, time_ms(me_call, 50),
               time_ms(lambda: update3d.motion_encoder_3d_plain(*me_in[1], dw_me, me3), 20),
               # the MLPs' multiply-adds, a multiply and a max per gathered value
               me_ops, me_io + 4 * (n * me_floats + me_weights),
               host_ms=me_host, **measured(times, steps, 1),
               **measured(*forms[("me", "", 8)][1:], 8))
        err, times, steps = forms[("gf", "", 1)]
        record("gru_flowhead_3d", "camliflow_torch/csrc/update3d.cu",
               "camliflow_tpu/ops/pallas_update3d.py:372", err, time_ms(gf_call, 50),
               time_ms(lambda: update3d.gru_flowhead_3d_plain(*gf_in[1], dw_gf, gf3), 20),
               gf_ops, gf_io + 4 * (n * gf_floats + gf_weights), host_ms=gf_host,
               **measured(times, steps, 1), **measured(*forms[("gf", "", 8)][1:], 8))

        # the fast path's forms of #6 and #7: the hoisted weights in bf16
        # (`to_bf16`), the tables bf16 (FAST_TOL against the plain version);
        # beside the exact forms at bs 1 and 8
        me16_call, gf16_call = (c["this"] for c in run_forms(
            " (bf16)", lambda tree: tree.to_bf16, me3, gf3, me_other, gf_other, fast_close,
            (8, 1)))
        dw16_me, dw16_gf = update3d.to_bf16(dw_me), update3d.to_bf16(dw_gf)
        # bytes a batch item (points, bf16 hoisted weights) and once a call
        # (the MLPs, read once whatever the batch)
        for key, name, call, plain, ops, item_bytes, call_bytes, replaces in (
                ("me", "motion_encoder_3d", me16_call,
                 lambda: update3d.motion_encoder_3d_plain(*me_in[1], dw16_me, me3), me_ops,
                 me_io + 2 * n * me_floats, 4 * me_weights, 248),
                ("gf", "gru_flowhead_3d", gf16_call,
                 lambda: update3d.gru_flowhead_3d_plain(*gf_in[1], dw16_gf, gf3), gf_ops,
                 gf_io + 2 * n * gf_floats, 4 * gf_weights, 372)):
            err, times, steps = forms[(key, " (bf16)", 1)]
            exact = {f"exact_form_device_ms_bs{bs}": mean(forms[(key, "", bs)][1]["this"])
                     for bs in (1, 8)}
            bs8 = forms[(key, " (bf16)", 8)]
            print(f"  {name} (bf16): device {mean(times['this']):.4f} ms bs 1, "
                  f"{mean(bs8[1]['this']):.4f} ms bs 8; the exact form "
                  f"{exact['exact_form_device_ms_bs1']:.4f}, "
                  f"{exact['exact_form_device_ms_bs8']:.4f} ms", flush=True)
            record(f"{name} (bf16)", "camliflow_torch/csrc/update3d.cu",
                   f"camliflow_tpu/ops/pallas_update3d.py:{replaces}", err, time_ms(call, 50),
                   time_ms(plain, 20), ops, item_bytes + call_bytes, wrapper=f"{name}_bf16",
                   device_ms=mean(times["this"]), **measured(times, steps, 1),
                   **measured(*bs8[1:], 8),
                   bound_ms_bs8=bound(8 * ops, 8 * item_bytes + call_bytes)[0],
                   **exact)

        # the gated int8 forms of #6 and #7 (CAMLIFLOW_UPDATE3D=1, at most
        # 4096 loop points; at the eval CLI's batch of 8 too, where the
        # scales are the batch's): the bf16 hoisted weights quantised to int8
        # with their scales folded into the MLPs, every dense layer on bf16
        # operands (prepare_int8), each against its plain version within one
        # bf16 step (GATED_TOL), with another tree bit for bit its same form,
        # timed in turns with it and by launch; bytes with the hoisted
        # weights at 1 byte, operations at the bf16 peak
        def int8_operands(tree, enc, d_me, d_gf):
            return tree.prepare_int8(tree.to_bf16({
                "motion_encoder": d_me, "gru": {k: d_gf[k] for k in ("conv_zr", "conv_q")},
                "flow_head": {k: d_gf[k] for k in ("conv1", "conv2")}}), enc, gru, head)

        int8 = {}  # bs -> #6's and #7's calls, their plain versions, their packings
        for bs in (8, 1):
            d_me, d_gf, d_other = dws[bs]
            dw8, me8, gf8 = int8_operands(update3d, encoder, d_me, d_gf)
            gf8_dw = {**dw8["gru"], **dw8["flow_head"]}
            if other:
                dw8_o, me8_o, gf8_o = int8_operands(other[2], other_encoder, d_other, d_gf)
                gf8_dw_o = {**dw8_o["gru"], **dw8_o["flow_head"]}
            me_calls = trees(
                lambda: update3d.motion_encoder_3d(*me_in[bs], dw8["motion_encoder"], me8),
                lambda: other[2].motion_encoder_3d(*me_in[bs], dw8_o["motion_encoder"], me8_o))
            gf_calls = trees(lambda: update3d.gru_flowhead_3d(*gf_in[bs], gf8_dw, gf8),
                             lambda: other[2].gru_flowhead_3d(*gf_in[bs], gf8_dw_o, gf8_o))
            me_plain = (lambda: update3d.motion_encoder_3d_plain(  # noqa: E731
                *me_in[bs], dw8["motion_encoder"], me8))
            gf_plain = lambda: update3d.gru_flowhead_3d_plain(  # noqa: E731
                *gf_in[bs], gf8_dw, gf8)
            reps = 20 if bs == 1 else 10
            forms[("me", " (int8)", bs)] = drive(
                f"motion_encoder_3d (int8) bs={bs}", me_calls, me_plain(), gated_close,
                "motion_encoder_3d", reps, flow=me_in[bs][0])
            forms[("gf", " (int8)", bs)] = drive(
                f"gru_flowhead_3d (int8) bs={bs}", gf_calls, gf_plain(), gated_close,
                "gru_flowhead_3d", reps)
            int8[bs] = (me_calls["this"], gf_calls["this"], me_plain, gf_plain, me8, gf8)
        me8_call, gf8_call, me8_plain, gf8_plain, me8, gf8 = int8[1]
        # bytes a batch item (points, int8 hoisted weights) and once a call
        # (the MLPs)
        for key, name, call, plain, ops, item_bytes, call_bytes, replaces in (
                ("me", "motion_encoder_3d", me8_call, me8_plain,
                 2 * n * (linear_macs({k: me8[k] for k in update3d.ME_CONVS}) + me_floats),
                 me_io + n * me_floats, 4 * sum(size(me8[k]) for k in update3d.ME_CONVS), 248),
                ("gf", "gru_flowhead_3d", gf8_call, gf8_plain,
                 2 * n * (sum(gf8[k].cin * gf8[k].cout for k in keys) + gf_floats),
                 gf_io + n * gf_floats, 4 * sum(size(gf8[k]) for k in keys), 372)):
            err, times, steps = forms[(key, " (int8)", 1)]
            bs8 = forms[(key, " (int8)", 8)]
            bf16 = {f"bf16_form_device_ms_bs{bs}": mean(forms[(key, " (bf16)", bs)][1]["this"])
                    for bs in (1, 8)}
            print(f"  {name} (int8): device {mean(times['this']):.4f} ms bs 1, "
                  f"{mean(bs8[1]['this']):.4f} ms bs 8; the bf16 form "
                  f"{bf16['bf16_form_device_ms_bs1']:.4f}, "
                  f"{bf16['bf16_form_device_ms_bs8']:.4f} ms", flush=True)
            record(f"{name} (int8)", "camliflow_torch/csrc/update3d.cu",
                   f"camliflow_tpu/ops/pallas_update3d.py:{replaces}", err,
                   time_ms(call, 50), time_ms(plain, 20), ops, item_bytes + call_bytes,
                   bf16_cores=True, wrapper=f"{name}_int8", device_ms=mean(times["this"]),
                   **measured(times, steps, 1), **measured(*bs8[1:], 8),
                   bound_ms_bs8=bound(8 * ops, 8 * item_bytes + call_bytes, PEAK_BF16)[0],
                   bf16_form_device_ms=bf16["bf16_form_device_ms_bs1"], **bf16)
        dw_gf8 = dws[8][1]  # #13's bs-8 weights, below
        del int8, dws, me_in[8], gf_in[8]

        # the PointConvDW tail alone (#13), at the fuse_hidden path's four
        # shapes: GRU3D's z|r and q (k=4), FlowHead3D's conv1 and conv2
        # (k=32); f32 and the fast path's bf16 (bf16 weights, the table
        # rounded to bf16 as it is read, bf16 products: on packed words, 8
        # channels a lane, where the rows allow); bit for bit the plain
        # version and, with another tree, its tail; in turns with it; at bs 1
        # and at the eval CLI's batch of 8 (16,384 points)
        exact_dev = exact_dev8 = {}
        for form, dws_13, dws_13_8 in (("", dw_gf, dw_gf8),
                                       (" (bf16)", dw16_gf, update3d.to_bf16(dw_gf8))):
            # by shape, filled as they run
            tail_dev, tail_other, tail_bound = {}, {}, {}
            tail_dev8, tail_other8, tail_bound8 = {}, {}, {}
            for key, channels in (("conv_zr", 256), ("conv_q", 128), ("conv1", 128),
                                  ("conv2", 64)):
                for bs, knn_idx, w, dev, dev_other, bounds in (
                        (1, idx, dws_13[key], tail_dev, tail_other, tail_bound),
                        (8, idx8, dws_13_8[key], tail_dev8, tail_other8, tail_bound8)):
                    table = torch.randn(bs, n, channels, generator=gen, device=device)
                    ref = update3d.dw_max_plain(table, knn_idx, w)
                    tails = trees(update3d.dw_max, other[2].dw_max if other else None)
                    k = w.shape[2]  # the kernel reads the first k of idx's 32 columns
                    for tree, wrapper in tails.items():
                        for _ in range(2):
                            if not torch.equal(wrapper(table, knn_idx, w), ref):
                                raise AssertionError(f"{tree} tree's dw_max{form} {key} bs={bs}: "
                                                     "not bit-identical to the plain version")
                    calls = {tree: lambda fn=wrapper: fn(table, knn_idx, w)
                             for tree, wrapper in tails.items()}
                    times = in_turns(calls, 20, "dw_max_")  # dw_max_tail, dw_max_words
                    dev[key] = mean(times["this"])
                    if other:
                        dev_other[key] = mean(times["other"])
                    nbytes = (4 * bs * (2 * n * channels + n * k)
                              + w.element_size() * bs * n * k * channels)
                    ops = 2 * bs * n * k * channels  # a multiply and a max per gathered value
                    bounds[key] = bound(ops, nbytes)[0]
                    if bs == 8:
                        print(f"  dw_max{form} {key} bs=8 (k={k}, C={channels}): device "
                              f"{dev[key]:.4f} ms{beside(times)}; bound {bounds[key]:.4f} ms",
                              flush=True)
                        continue
                    host = host_ms(calls["this"], 20)
                    print(f"  dw_max{form} {key} (k={k}, C={channels}): device "
                          f"{dev[key]:.4f} ms{beside(times)}; host {host:.4f} ms a call",
                          flush=True)
                    record(f"dw_max{form}", "camliflow_torch/csrc/update3d.cu",
                           "camliflow_tpu/ops/pallas_ohg.py:177", 0.0, time_ms(calls["this"], 50),
                           time_ms(lambda: update3d.dw_max_plain(table, knn_idx, w), 20), ops,
                           nbytes, label=f"dw_max{form} {key} (k={k}, C={channels}, by events)",
                           entry=key == "conv1", wrapper="dw_max_bf16" if form else "dw_max",
                           device_ms=dev[key], host_ms=host, device_ms_by_shape=tail_dev,
                           bound_ms_by_shape=tail_bound, device_ms_bs8_by_shape=tail_dev8,
                           bound_ms_bs8_by_shape=tail_bound8,
                           **({"other_device_ms_by_shape": tail_other,
                               "other_device_ms_bs8_by_shape": tail_other8} if other else {}),
                           **({"exact_form_device_ms_by_shape": exact_dev,
                               "exact_form_device_ms_bs8_by_shape": exact_dev8} if form else {}))
            exact_dev, exact_dev8 = tail_dev, tail_dev8
        del dw_gf8

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
        # its fast form: the int8 costs of the selection above times their
        # rows' scales before the cost MLP (f32 both sides)
        args8 = (xyz1, xyz2_warp, idx_sel, cost8, tail, len(sizes), 16, q_scale)
        got = corr3d.corr3d_tail(*args8)
        err = check("corr3d_tail (scaled)", got, corr3d.corr3d_tail_plain(*args8))
        if not torch.equal(corr3d.corr3d_tail(*args8), got):
            raise AssertionError("corr3d_tail (scaled): two runs give different bits")
        scaled_dev = device_ms(lambda: corr3d.corr3d_tail(*args8), 20)
        print(f"  corr3d_tail (scaled): device {scaled_dev:.4f} ms, the exact form "
              f"{tail_dev:.4f} ms a call", flush=True)
        record("corr3d_tail (scaled)", "camliflow_torch/csrc/corr3d_tail.cu",
               "camliflow_tpu/ops/pallas_corr3d.py:729", err,
               time_ms(lambda: corr3d.corr3d_tail(*args8), 50),
               time_ms(lambda: corr3d.corr3d_tail_plain(*args8), 20),
               2 * m * (n_sel // m * (4 * c1 + c1 * c1) + len(sizes) * c1 * 128) + n_sel,
               4 * (2 * m * 3 + 2 * n_sel + sum(t.numel() for t in tail) + m * 128 + m),
               wrapper="corr3d_tail_scaled", device_ms=scaled_dev, exact_form_device_ms=tail_dev)

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
            sk_close(f"clfm_fused (C2 {c2}, C3 {c3})", clfm.sk_state(*inputs, params),
                     clfm.sk_state_plain(*inputs, params))
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
            if other:  # the other tree's exact form: the same bits, timed in turns
                other32 = other[6].prepare_clfm_params(block)
                theirs = other[6].clfm_fused(*inputs, other32)
                if not (torch.equal(theirs[0], got_2d) and torch.equal(theirs[1], got_3d)):
                    raise AssertionError("clfm_fused: not the other tree's bits")
                times = in_turns(trees(lambda: clfm.clfm_fused(*inputs, params),
                                       lambda: other[6].clfm_fused(*inputs, other32)), 20, "")
                print(f"  clfm_fused (C2 {c2}, C3 {c3}): device {mean(times['this']):.4f} ms a "
                      f"call{beside(times)}; the other tree bit for bit", flush=True)
            # its gated bf16 form (CAMLIFLOW_CLFM=1): a bf16 score gate and
            # packings, bf16 tables, products and dense operands, within one
            # bf16 step of its plain version (GATED_TOL), rerun bit for bit,
            # at bs 1 and at the eval CLI's batch of 8; timed in turns with
            # the other tree's bf16 form and by launch (both trees); bytes
            # with the gate, the dense kernels and the SK heads at 2 bytes
            # and the biases at 4, operations at the bf16 peak
            biases = sum(params[key].cout for key in clfm.DENSE)
            params16 = clfm.prepare_clfm_params(block, bf16=True)
            other16 = other[6].prepare_clfm_params(block, bf16=True) if other else None
            inputs16 = (*inputs[:2], clfm.hoist_interp_score(block.interp, cache[1], True),
                        *inputs[3:])
            cases16 = {1: inputs16, 8: (
                distinct_items(torch.randn(8, feat_h, feat_w, c2, generator=gen, device=device)),
                distinct_items(torch.randn(8, m, c3, generator=gen, device=device)),
                *(x.repeat(8, 1, 1).contiguous() for x in inputs16[2:]))}
            by_bs = {}
            for bs in (8, 1):
                args16 = cases16[bs]
                label16 = f"clfm_fused (bf16, C2 {c2}, C3 {c3}) bs={bs}"
                got_2d, got_3d = clfm.clfm_fused(*args16, params16)
                ref_2d, ref_3d = clfm.clfm_fused_plain(*args16, params16)
                err = max(gated_close(f"{label16} out_2d", got_2d, ref_2d),
                          gated_close(f"{label16} out_3d", got_3d, ref_3d))
                again = clfm.clfm_fused(*args16, params16)
                if not (torch.equal(again[0], got_2d) and torch.equal(again[1], got_3d)):
                    raise AssertionError(f"{label16}: two runs give different bits")
                sk_close(label16, clfm.sk_state(*args16, params16),
                         clfm.sk_state_plain(*args16, params16))
                calls = trees(lambda a=args16: clfm.clfm_fused(*a, params16),
                              lambda a=args16: other[6].clfm_fused(*a, other16))
                reps = 20 if bs == 1 else 10
                times = in_turns(calls, reps, "")
                splits = {tree: stage_ms(call, reps) for tree, call in calls.items()}
                print(f"  {label16}: device {mean(times['this']):.4f} ms a call"
                      f"{beside(times)}; by launch " + "; ".join(
                          f"{tree} " + ", ".join(f"{short_name(k)} {ms:.4f}" for k, ms in steps)
                          for tree, steps in splits.items()), flush=True)
                by_bs[bs] = (err, times, splits)
            err, times, splits = by_bs[1]
            call16 = lambda: clfm.clfm_fused(*inputs16, params16)  # noqa: E731
            dev16, dev32 = mean(times["this"]), device_ms(lambda: clfm.clfm_fused(*inputs, params),
                                                          20)
            print(f"  clfm_fused (bf16, C2 {c2}, C3 {c3}): device {dev16:.4f} ms a call bs 1, "
                  f"{mean(by_bs[8][1]['this']):.4f} ms bs 8, the exact form {dev32:.4f} ms bs 1",
                  flush=True)
            item_bytes = 4 * (2 * hw * c2 + 2 * m * c3 + hw + 8 * m) + 2 * hw * c3
            call_bytes = 4 * biases + 2 * (weights - biases)
            record("clfm_fused (bf16)", "camliflow_torch/csrc/clfm.cu",
                   "camliflow_tpu/ops/pallas_clfm.py:200", max(by_bs[bs][0] for bs in by_bs),
                   time_ms(call16, 20),
                   time_ms(lambda: clfm.clfm_fused_plain(*inputs16, params16), 20), 2 * macs,
                   item_bytes + call_bytes,
                   label=f"clfm_fused (bf16, C2 {c2}, C3 {c3})", entry=c2 == 324,
                   bf16_cores=True, wrapper="clfm_fused_bf16", device_ms=dev16,
                   exact_form_device_ms=dev32,
                   **{f"{key}_bs{bs}": value for bs, (_, t, sp) in by_bs.items()
                      for key, value in (
                          ("device_ms", mean(t["this"])),
                          ("steps_ms", [ms for _, ms in sp["this"]]),
                          *((("other_device_ms", mean(t["other"])),
                             ("other_steps_ms", [ms for _, ms in sp["other"]])) if other
                            else ()))},
                   bound_ms_bs8=bound(8 * 2 * macs, 8 * item_bytes + call_bytes, PEAK_BF16)[0])

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


class FastForm:
    """A wrapper's fast-form launches (its `fast_launches`: the int8, scaled
    or bf16 form; or another `counter`, the int8 3D chain's
    `int8_launches`), under the `launches` name every other counter has."""

    def __init__(self, wrapper, counter: str = "fast_launches"):
        self.wrapper = wrapper
        self.counter = counter

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.counter)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.wrapper, self.counter, value)


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name, each with its `launches`
    counter (a process's own: phase 10's ranks build theirs), and each fast
    form's counter under FAST_FORMS' names (#8's halves' as *_bf16)."""
    from camliflow_torch.ops import clfm, corr3d, fps, gather, interp, knn, update2d, update3d

    wrappers = {"k_nearest_neighbor": knn.k_nearest_neighbor,
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
    for exact, fast in (*FAST_FORMS.items(), ("gru_2d", "gru_2d_bf16"),
                        ("flow_head_2d", "flow_head_2d_bf16")):
        wrappers[fast] = FastForm(wrappers[exact])
    for gated, (exact, counter) in GATED_FORMS.items():
        wrappers[gated] = FastForm(wrappers[exact], counter)
    return wrappers


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
        result["ops"] = sorted({e.name() for e in prof.profiler.kineto_results.events()
                                if e.name() in NONDETERMINISTIC_OPS})
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


# phase 11: the fast path
FAST_PATHS = ("CamLiRAFT-L", "CamLiRAFT", "CamLiRAFT fuse_hidden", "RAFT")


def fast_per_request(exact: dict) -> dict:
    """A path's launches a request with fast_inference=on, derived from its
    exact path's: each kernel with a fast form launches that form instead
    (the 3D pyramid int8, the hoisted weights and the 2D chain's packings
    bf16); #8's halves stay exact (fuse_hidden runs GRU2D and FlowHead2D
    exact, as the JAX fast path does)."""
    fast = dict(exact)
    for key, form in FAST_FORMS.items():
        fast[form] = exact.get(key, 0)
        fast[key] = 0
    return fast


def bf16_packed_convs(model) -> list:
    """The Conv2d modules whose weights the fast path packs to bf16: the 2D
    update chain's, #9's and, unless fuse_hidden runs GRU2D and FlowHead2D
    exact, #8's (RAFT: #10's). CamLiRAFT-L packs none (its dense layers stay
    f32; its hoisted point-conv weights are activations)."""
    from torch import nn

    core = getattr(model, "core", None)
    branch = getattr(core, "branch_2d", core)
    if not hasattr(branch, "motion_encoder") or not hasattr(branch, "flow_head") or not \
            isinstance(getattr(branch.motion_encoder, "conv_c1", None), nn.Conv2d):
        return []
    blocks = [branch.motion_encoder]
    if not getattr(core, "fuse", {}).get("hidden", False):
        blocks += [branch.gru, branch.flow_head]
    return [m for block in blocks for m in block.modules() if isinstance(m, nn.Conv2d)]


@contextlib.contextmanager
def bf16_weights(convs):
    """The convs' weights rounded to bf16 (the values the fast path
    multiplies by) inside the block, restored after it."""
    import torch

    saved = [conv.weight.detach().clone() for conv in convs]
    try:
        with torch.no_grad():
            for conv in convs:
                conv.weight.copy_(conv.weight.to(torch.bfloat16).float())
        yield
    finally:
        with torch.no_grad():
            for conv, weight in zip(convs, saved):
                conv.weight.copy_(weight)


def compare_flows(label: str, got: dict, ref: dict, tols: dict) -> dict:
    """max |got - ref| on each flow both have, each within its tolerance
    ({key: (tol, unit)}); prints them beside the flows' scale."""
    deltas = {}
    for key, (tol, unit) in tols.items():
        if key not in ref:
            continue
        deltas[key] = float(np.abs(got[key] - ref[key]).max())
        print(f"  {label}: max |d{key}| {deltas[key]:.3e} {unit} (bound {tol}), |{key}| up to "
              f"{np.abs(ref[key]).max():.3f} {unit}", flush=True)
        if not deltas[key] <= tol:
            raise AssertionError(f"{label}: max |d{key}| {deltas[key]} > {tol}")
    return deltas


def fast_phase(device, wrappers, card, paths) -> dict:
    """Phase 11: each RAFT-family path at full width with
    fast_inference=on, phase 4's weights (seed SEED) and inputs: 1 warm-up
    and 3 requests through run_things (launches held to fast_per_request),
    each request alone; the same weights and input on the exact path
    (fast_inference off, the model's attribute switched): on the weights
    the fast path multiplies by within the JAX package's gate (FAST_2D_TOL,
    FAST_3D_TOL), on the f32 weights within its fast-vs-exact test bound
    (see FAST_TOL's note); a batch of 8 on both paths (request time, over
    BATCH_TURNS requests each in turns too, peak memory, the fast request's
    launches and device busy share, fast against exact both ways); the CPU's plain fast versions on the same
    input within phase 5's envelope. Then the eval CLI once with
    'model.fast_inference="on"'. Returns the launches of the held runs."""
    import torch

    from camliflow_torch.runtime.checkpoint import random_weights
    from camliflow_torch.runtime.evaluator import Evaluator

    gate = {"flow_3d": (FAST_3D_TOL, "m"), "flow_2d": (FAST_2D_TOL, "px")}
    envelope = {"flow_3d": (FLOW_3D_TOL, "m"), "flow_2d": (FLOW_2D_TOL, "px")}

    def f32_bound(exact):  # the JAX package's fast-vs-exact test bound on this output
        return {key: (max(floor, FAST_SHARE * float(np.abs(exact[key]).max())), unit)
                for key, floor, unit in (("flow_3d", FAST_3D_FLOOR, "m"),
                                         ("flow_2d", FAST_2D_FLOOR, "px")) if key in exact}

    total = dict.fromkeys(wrappers, 0)
    flagship_fast = None
    for label, cls, cfgs, images, exact_request in paths:
        if label not in FAST_PATHS:
            continue
        want = fast_per_request(exact_request)
        if label == "CamLiRAFT":
            flagship_fast = want
        print(f"  {label}, fast_inference=on:", flush=True)
        fast_cfgs = {**cfgs, "fast_inference": "on"}
        model = cls(fast_cfgs)
        random_weights(model, SEED)
        cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
        evaluator = Evaluator(model, device)
        batches = [frame_pair(SEED + 1 + i, i, images) for i in range(4)]
        launches = drive(f"{label} fast", evaluator, batches, wrappers, card)
        for key, count in launches.items():
            total[key] += count
        got = {k: launches[k] / 3 for k in want}
        if got != want:
            raise AssertionError(f"{label} fast: launches per request {got}, expected {want}")
        convs = bf16_packed_convs(model)
        fast = evaluator.forward(batches[0])
        model.fast_inference = "off"
        exact = evaluator.forward(batches[0])
        with bf16_weights(convs):
            exact16 = evaluator.forward(batches[0])
        model.fast_inference = "on"
        for key in ("flow_3d", "flow_2d"):
            if key in exact:
                check_output(fast, key, exact[key].shape)
        print(f"  {label}: {len(convs)} convs packed to bf16", flush=True)
        compare_flows(f"{label} fast vs exact on the bf16 weights, bs=1", fast, exact16, gate)
        compare_flows(f"{label} fast vs exact, bs=1", fast, exact, f32_bound(exact))

        # the eval CLI's batch of 8 on both paths, the fast one first; then
        # BATCH_TURNS - 1 more requests each in turns (exact, fast), for the
        # two paths' spread within this process
        batch = stack([frame_pair(SEED + 20 + i, i, images) for i in range(BATCH)])
        outs, line, request_ms = {}, [], {"on": [], "off": []}

        def timed(mode):
            model.fast_inference = mode
            start = time.perf_counter()
            out = evaluator.forward(batch)
            torch.cuda.synchronize()
            request_ms[mode].append(1e3 * (time.perf_counter() - start))
            return out

        for mode in ("on", "off"):
            model.fast_inference = mode
            evaluator.forward(batch)  # warm-up at this batch's shapes
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 2**20  # what earlier phases left alive
            for fn in wrappers.values():
                fn.launches = 0
            outs[mode] = timed(mode)
            ms = request_ms[mode][0]
            launches = {key: fn.launches for key, fn in wrappers.items()}
            peak = torch.cuda.max_memory_allocated() / 2**20
            line.append(f"{'fast' if mode == 'on' else 'exact'} {ms:.3f} ms "
                        f"({ms / BATCH:.3f} a frame pair), peak {peak:.1f} MiB "
                        f"({peak - base:.1f} above the {base:.1f} allocated before it)")
            if mode == "on":
                got = {k: launches[k] for k in want}
                if got != want:
                    raise AssertionError(f"{label} fast bs={BATCH}: launches {got}, expected "
                                         f"{want}")
                for key, count in launches.items():
                    total[key] += count
                wall, busy, count = profile_request(evaluator, batch, top=5)
                line.append(f"fast profiled {wall:.3f} ms wall, device busy {busy:.3f} ms "
                            f"({100 * busy / wall:.1f}%), {count} kernel launches")
        for _ in range(BATCH_TURNS - 1):
            for mode in ("off", "on"):
                timed(mode)
        line.append(f"{BATCH_TURNS} requests each in turns, ms: " + "; ".join(
            f"{'fast' if mode == 'on' else 'exact'} mean {sum(request_ms[mode]) / BATCH_TURNS:.3f} "
            f"({min(request_ms[mode]):.3f}-{max(request_ms[mode]):.3f}: "
            + ", ".join(f"{ms:.3f}" for ms in request_ms[mode]) + ")"
            for mode in ("on", "off")))
        model.fast_inference = "off"  # the turns end on the fast path
        with bf16_weights(convs):
            exact16 = evaluator.forward(batch)
        model.fast_inference = "on"
        print(f"  {label} bs={BATCH}: " + "; ".join(line) + f" | {card}", flush=True)
        compare_flows(f"{label} fast vs exact on the bf16 weights, bs={BATCH}", outs["on"],
                      exact16, gate)
        compare_flows(f"{label} fast vs exact, bs={BATCH}", outs["on"], outs["off"],
                      f32_bound(outs["off"]))
        del outs, batch, exact16

        # the CPU's plain fast versions on the same weights and input
        cpu_model = cls(fast_cfgs)
        cpu_model.load_state_dict(cpu_state)
        start = time.perf_counter()
        ref = Evaluator(cpu_model, "cpu").forward(batches[0])
        print(f"  {label} fast on the CPU: {time.perf_counter() - start:.1f} s", flush=True)
        compare_flows(f"{label} fast, CUDA vs CPU", fast, ref, envelope)
        del evaluator, model, cpu_model
        torch.cuda.empty_cache()
    fast_eval_cli(device, wrappers, card, flagship_fast, total)
    return total


def fast_eval_cli(device, wrappers, card, want: dict, total: dict) -> None:
    """`python -m camliflow_torch.eval protocol=things
    testset=flyingthings3d_subset model=camliraft 'model.fast_inference="on"'`
    in this process, on phase 9's synthetic validation split (4 pairs at
    960x540: one batch) with random weights saved as a trainer checkpoint;
    finite metrics, and the launches held to one fast flagship request."""
    import os

    import torch

    from camliflow_torch import eval as eval_cli
    from camliflow_torch.models.factory import model_factory
    from camliflow_torch.runtime.checkpoint import random_weights
    from camliflow_torch.utils.config import compose

    root = os.path.join(WORK, "train", "data")
    if not os.path.isdir(os.path.join(root, "val")):
        write_things_split(root, "val", 4, SEED + 71)
    cfgs = compose(eval_cli.CONF_DIR, model="camliraft", testset="flyingthings3d_subset",
                   overrides=[])
    model = model_factory(cfgs.model)(cfgs.model.to_dict())
    random_weights(model, SEED)
    ckpt = os.path.join(WORK, "fast_cli.pt")
    torch.save({"model": model.state_dict()}, ckpt)
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    metrics = eval_cli.main(["protocol=things", "testset=flyingthings3d_subset",
                             "model=camliraft", f"ckpt.path={ckpt}",
                             f"testset.root_dir={root}", 'model.fast_inference="on"'])
    seconds = time.perf_counter() - start
    launches = {key: fn.launches for key, fn in wrappers.items()}
    for key, count in launches.items():
        total[key] += count
    shown = {k: round(float(v), 6) for k, v in metrics.items() if k.startswith("EPE")}
    print(f"  eval CLI, fast_inference=on: {shown} in {seconds:.1f} s | {card}", flush=True)
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"eval CLI fast: metrics not finite: {metrics}")
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"eval CLI fast: launches {got}, expected one fast request's {want}")


# phase 13: the JAX package's gated operand forms, each path with the
# switches it engages (the port reads them at each fast forward's encode)
GATED_PATHS = {"CamLiRAFT-L": {"CAMLIFLOW_UPDATE3D": "1"},
               "CamLiRAFT": {"CAMLIFLOW_UPDATE3D": "1", "CAMLIFLOW_CLFM": "1"},
               "CamLiRAFT fuse_hidden": {"CAMLIFLOW_CLFM": "1"}}
SWITCHES_ENV = ("CAMLIFLOW_UPDATE3D", "CAMLIFLOW_CLFM")
GATED_PAIR = 2  # the int8 paths' second comparison with the CPU: a batch whose scales are shared
# each sample of a bs-8 int8 request against the same sample alone (its own
# int8 scales): about twice the 9.606e-3 m and four times the 1.277e-3 px
# measured on an NVIDIA H100 80GB HBM3 (700.00 W)
GATED_ALONE = {"flow_3d": (0.02, "m"), "flow_2d": (5e-3, "px")}


@contextlib.contextmanager
def gated_switches(values: dict):
    """The two switches set in this process inside the block ("0" where
    `values` has none), each restored (or unset) after it."""
    import os

    saved = {name: os.environ.get(name) for name in SWITCHES_ENV}
    try:
        for name in SWITCHES_ENV:
            os.environ[name] = values.get(name, "0")
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def gated_per_request(fast: dict, values: dict) -> dict:
    """A path's launches a request with the switches `values`, from its
    fast path's (fast_per_request): CAMLIFLOW_UPDATE3D=1 moves #6's and #7's
    bf16 forms to their int8 forms; CAMLIFLOW_CLFM=1 moves the corr and
    motion fusions (2 a loop iteration) to #11's bf16 form, the hidden
    fusion staying exact."""
    want = dict(fast)
    if values.get("CAMLIFLOW_UPDATE3D") == "1":
        for key in ("motion_encoder_3d", "gru_flowhead_3d"):
            want[f"{key}_int8"], want[f"{key}_bf16"] = want[f"{key}_bf16"], 0
    if values.get("CAMLIFLOW_CLFM") == "1":
        want["clfm_fused_bf16"] = 2 * N_ITERS
        want["clfm_fused"] -= 2 * N_ITERS
    return want


def timed_request(evaluator, batch, wrappers) -> tuple[dict, float, float, dict]:
    """One request after a warm-up at its shapes: (outputs, ms on the host
    clock to a synchronisation, peak MiB allocated, launches)."""
    import torch

    evaluator.forward(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    out = evaluator.forward(batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - start)
    return (out, ms, torch.cuda.max_memory_allocated() / 2**20,
            {key: fn.launches for key, fn in wrappers.items()})


def gated_phase(device, wrappers, card, paths) -> dict:
    """Phase 13: CamLiRAFT-L with CAMLIFLOW_UPDATE3D=1, the flagship with
    both switches and the flagship with fuse_hidden and CAMLIFLOW_CLFM=1,
    fast_inference=on, at full width with phase 4's weights and inputs: 1
    warm-up and 3 requests through run_things (launches held to
    gated_per_request), then (a) the CPU's plain version of the same form at
    bs=1 within phase 5's envelope, and on the int8 paths at bs=GATED_PAIR
    too, where the batch's int8 scales are shared; (b) the fast form
    (switches off) on the same input, reported and held to the JAX
    package's fast-vs-exact test bound, at bs=1 and bs=8; at bs=8 the gated
    request's launches held, its ms, peak memory and device busy share
    beside the fast form's, and each sample against the same sample alone:
    within phase 5's envelope where nothing is quantised over the batch
    (CAMLIFLOW_CLFM alone), within GATED_ALONE on the int8 paths (alone, a
    sample's int8 scales are its own, in the batch the batch's). Returns the
    launches of the held runs."""
    import torch

    from camliflow_torch.runtime.checkpoint import random_weights
    from camliflow_torch.runtime.evaluator import Evaluator

    envelope = {"flow_3d": (FLOW_3D_TOL, "m"), "flow_2d": (FLOW_2D_TOL, "px")}

    def f32_bound(ref):  # the JAX package's fast-vs-exact test bound on this output
        return {key: (max(floor, FAST_SHARE * float(np.abs(ref[key]).max())), unit)
                for key, floor, unit in (("flow_3d", FAST_3D_FLOOR, "m"),
                                         ("flow_2d", FAST_2D_FLOOR, "px")) if key in ref}

    total = dict.fromkeys(wrappers, 0)
    for label, cls, cfgs, images, exact_request in paths:
        if label not in GATED_PATHS:
            continue
        values = GATED_PATHS[label]
        shown = " ".join(f"{k}={v}" for k, v in values.items())
        int8 = values.get("CAMLIFLOW_UPDATE3D") == "1"
        want = gated_per_request(fast_per_request(exact_request), values)
        fast_cfgs = {**cfgs, "fast_inference": "on"}
        model = cls(fast_cfgs)
        random_weights(model, SEED)
        cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
        evaluator = Evaluator(model, device)
        batches = [frame_pair(SEED + 1 + i, i, images) for i in range(4)]
        with gated_switches(values):
            launches = drive(f"{label} {shown}", evaluator, batches, wrappers, card)
            got = {k: launches[k] / 3 for k in want}
            if got != want:
                raise AssertionError(f"{label} {shown}: launches per request {got}, expected "
                                     f"{want}")
            for key, count in launches.items():
                total[key] += count
            gated = evaluator.forward(batches[0])
        with gated_switches({}):
            fast = evaluator.forward(batches[0])
        for key in ("flow_3d", "flow_2d"):
            if key in fast:
                check_output(gated, key, fast[key].shape)
        compare_flows(f"{label} gated vs the fast form, bs=1", gated, fast, f32_bound(fast))

        # the eval CLI's batch of 8: the gated request (launches held, its
        # device busy share), the fast form's beside it
        samples = [frame_pair(SEED + 20 + i, i, images) for i in range(BATCH)]
        batch = stack(samples)
        with gated_switches(values):
            alone = stack([evaluator.forward(sample) for sample in samples])
            pair = stack(samples[:GATED_PAIR])
            gated_pair = evaluator.forward(pair) if int8 else None
            outs = {"gated": timed_request(evaluator, batch, wrappers)}
            got = {k: outs["gated"][3][k] for k in want}
            if got != want:
                raise AssertionError(f"{label} {shown} bs={BATCH}: launches {got}, expected "
                                     f"{want}")
            for key, count in outs["gated"][3].items():
                total[key] += count
            wall, busy, count = profile_request(evaluator, batch, top=5)
        with gated_switches({}):
            outs["fast"] = timed_request(evaluator, batch, wrappers)
        print(f"  {label} bs={BATCH}: " + "; ".join(
            f"{mode} {ms:.3f} ms ({ms / BATCH:.3f} a frame pair), peak {peak:.1f} MiB"
            for mode, (_, ms, peak, _) in outs.items()) + f"; gated profiled {wall:.3f} ms "
            f"wall, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), {count} kernel "
            f"launches | {card}", flush=True)
        gated8 = outs["gated"][0]
        compare_flows(f"{label} gated vs the fast form, bs={BATCH}", gated8, outs["fast"][0],
                      f32_bound(outs["fast"][0]))
        # a sample alone is quantised with its own int8 scales, in the batch
        # with the batch's: two roundings of the chain's weights
        compare_flows(f"{label} gated bs={BATCH}, each sample vs alone", gated8, alone,
                      GATED_ALONE if int8 else envelope)
        del outs, alone

        # the CPU's plain version of the same form at bs=1 and, where the
        # scales are the batch's, at bs=GATED_PAIR (at bs=8 it takes 95 s
        # for CamLiRAFT-L alone on the card's host)
        cpu_model = cls(fast_cfgs)
        cpu_model.load_state_dict(cpu_state)
        cpu = Evaluator(cpu_model, "cpu")
        for size, got, data in ((1, gated, batches[0]), (GATED_PAIR, gated_pair, pair)):
            if got is None:
                continue
            start = time.perf_counter()
            with gated_switches(values):
                ref = cpu.forward(data)
            print(f"  {label} gated bs={size} on the CPU: {time.perf_counter() - start:.1f} s",
                  flush=True)
            compare_flows(f"{label} gated bs={size}, CUDA vs CPU", got, ref, envelope)
        del evaluator, model, cpu_model, cpu, batch, pair, gated_pair
        torch.cuda.empty_cache()
    return total


# phase 12: the last modules
PREP_FRAMES = {"train": 9, "val": 3}  # raw frames a split: 8 and 2 frame pairs
PREP_DEPTH = (5.0, 40.0)  # m, the raw disparities' depths (35 m is the cut)
SWITCHES = (("stacked", {}), ("loss_in_scan", {"loss_in_scan": True}),
            ("remat_scan", {"remat_scan": True}),
            ("both", {"loss_in_scan": True, "remat_scan": True}))
SWITCH_BATCHES = (TRAIN_BATCH, 8)  # 8: conf/model/camliraft.yaml's batch_size
SWITCH_TIMED = 2  # timed steps a setting, after the compared first
SWITCH_LOSS_TOL = 1e-5  # relative, each setting's loss against the stacked path's
# (batch, amp) where only the remat settings fit on the card: the stacked f32
# step at batch 8 ran out of an NVIDIA H100 80GB HBM3's memory (700.00 W;
# 68.9 GB allocated and 9.4 GB reserved, asking 2 GB more; 19.1 GB at batch
# 2). There `both` is held to `remat_scan`.
REMAT_ONLY = {(8, False)}
BLOCK_POINTS, BLOCK_SAMPLES = 8192, 4096  # PointNet2: 8192 -> 4096 points
CLFM_H, CLFM_W, CLFM_C = 144, 240, 32  # CamLiPWC's level-1 CLFM (576x960 images / 4)
NORM_SHAPE = (1, 68, 120, 128)  # the flagship's 1/8 feature map


def write_raw_things(root, seed: int) -> None:
    """A raw FlyingThings3D subset (the layout the preprocessing script
    reads) at 960 x 540, written with the port's writers: PREP_FRAMES
    frames a split, disparities of PREP_DEPTH (f 1050, baseline 1) with a
    few NaNs, disparity changes, .flo flows with a few beyond 500 px,
    occlusion maps (8-bit grey PNGs) and images."""
    import os

    from camliflow_torch.data.io import save_flow, save_pfm
    from camliflow_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    f = INTRINSICS[0]
    ramp = (np.arange(IMAGE_W)[None, :, None] + np.arange(IMAGE_H)[:, None, None]) % 200
    for split, frames in PREP_FRAMES.items():
        dirs = {key: os.path.join(root, split, *sub) for key, sub in (
            ("disp", ("disparity", "left")),
            ("change", ("disparity_change", "left", "into_future")),
            ("flow", ("flow", "left", "into_future")),
            ("occ", ("flow_occlusions", "left", "into_future")),
            ("image", ("image_clean", "left")))}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for i in range(frames):
            name = "%07d" % i
            disp = (f / rng.uniform(*PREP_DEPTH, (IMAGE_H, IMAGE_W))).astype(np.float32)
            disp[rng.rand(IMAGE_H, IMAGE_W) < 1e-3] = np.nan
            save_pfm(os.path.join(dirs["disp"], name + ".pfm"), -disp)
            image = rng.randint(0, 55, (IMAGE_H, IMAGE_W, 3)) + (ramp + 5 * i) % 200
            write_png(os.path.join(dirs["image"], name + ".png"), image.astype(np.uint8))
            if i == frames - 1:
                continue  # the last frame begins no pair
            save_pfm(os.path.join(dirs["change"], name + ".pfm"),
                     rng.uniform(-1.0, 1.0, (IMAGE_H, IMAGE_W)).astype(np.float32))
            flow = (3 * rng.randn(IMAGE_H, IMAGE_W, 2)).astype(np.float32)
            flow[rng.rand(IMAGE_H, IMAGE_W) < 1e-3] = 600.0
            save_flow(os.path.join(dirs["flow"], name + ".flo"), flow)
            occ = (rng.rand(IMAGE_H, IMAGE_W) < 0.1).astype(np.uint8) * 255
            write_png(os.path.join(dirs["occ"], name + ".png"), occ)


def check_prep(out: str, remove: bool, n_points: tuple, max_depth: float) -> int:
    """The `-prep` files of both splits: n_points finite points a cloud
    nearer than max_depth (f32), a finite flow_3d of the same length, the
    packed occlusion mask (none with remove_occluded_points), the 16-bit
    flow PNG at 540x960x3, the images and occlusion maps copied. Returns
    the frame pairs checked."""
    import os

    from camliflow_torch.data.png import read_png

    pairs = 0
    for (split, frames), n in zip(PREP_FRAMES.items(), n_points):
        names = sorted(os.path.splitext(fn)[0] for fn in os.listdir(os.path.join(out, split,
                                                                                   "pc")))
        if names != ["%07d" % i for i in range(frames - 1)]:
            raise AssertionError(f"{out}/{split}: frames {names}")
        for sub in ("image_clean", "occ_mask_2d"):
            if len(os.listdir(os.path.join(out, split, sub))) != (
                    frames if sub == "image_clean" else frames - 1):
                raise AssertionError(f"{out}/{split}/{sub} was not copied whole")
        for name in names:
            pcs = np.load(os.path.join(out, split, "pc", name + ".npz"))
            flow_3d = np.load(os.path.join(out, split, "flow_3d", name + ".npy"))
            occ = np.unpackbits(np.load(os.path.join(out, split, "occ_mask_3d", name + ".npy")),
                                count=n)
            flow_2d = read_png(os.path.join(out, split, "flow_2d", name + ".png"))
            for pc in (pcs["pc1"], pcs["pc2"]):
                if not (pc.shape == (n, 3) and pc.dtype == np.float32 and np.isfinite(pc).all()
                        and (pc[:, 2] < max_depth).all() and (pc[:, 2] > 0).all()):
                    raise AssertionError(f"{out}/{split}/{name}: a cloud {pc.shape} {pc.dtype}")
            if not (flow_3d.shape == (n, 3) and np.isfinite(flow_3d).all()):
                raise AssertionError(f"{out}/{split}/{name}: flow_3d {flow_3d.shape}")
            if remove and occ.any():
                raise AssertionError(f"{out}/{split}/{name}: occluded points kept")
            if flow_2d.shape != (IMAGE_H, IMAGE_W, 3) or flow_2d.dtype != np.uint16:
                raise AssertionError(f"{out}/{split}/{name}: flow_2d {flow_2d.shape}")
            pairs += 1
    return pairs


def preprocess_step(root: str, card) -> str:
    """Phase 12 (a): the raw subset, then `python -m
    camliflow_torch.preprocess_flyingthings3d_subset` in both modes (its
    defaults: 32768 and 8192 points, 35 m, 8 workers); the default mode's
    output is (b)'s training set. Returns its directory."""
    import os
    import shutil

    from camliflow_torch import preprocess_flyingthings3d_subset as prep

    shutil.rmtree(root, ignore_errors=True)
    start = time.perf_counter()
    write_raw_things(os.path.join(root, "raw"), SEED + 120)
    frames = sum(PREP_FRAMES.values())
    print(f"  wrote the raw subset ({frames} frames at {IMAGE_W}x{IMAGE_H}) in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for mode, flags in (("default", []), ("remove_occluded_points", ["--remove_occluded_points"])):
        out = os.path.join(root, mode)
        args = prep.parse_args(["--input_dir", os.path.join(root, "raw"), "--output_dir", out,
                                *flags])
        start = time.perf_counter()
        prep.main(args)
        seconds = time.perf_counter() - start
        pairs = check_prep(out, bool(flags), tuple(args.n_points), args.max_depth)
        print(f"  preprocessing ({mode}, {args.n_workers} workers): {pairs} frame pairs in "
              f"{seconds:.2f} s, {seconds / pairs:.3f} s a pair (the host's, on the card's "
              f"machine); n_points {args.n_points}, depth < {args.max_depth} m, no NaN, "
              f"files and copies complete", flush=True)
    return os.path.join(root, "default")


def switch_step(cfgs, device, wrappers, state, timed: bool) -> dict:
    """One setting's first train step through its Trainer (from `state`,
    the same batch), then, with `timed`, SWITCH_TIMED more steps for ms a
    step (their mean); every counter zeroed just before and read after.
    Returns the loss, the gradients, BatchNorm buffers (on the host),
    launches a step, ms and peak memory."""
    import gc

    import torch

    from camliflow_torch.data.datasets import collate
    from camliflow_torch.runtime.train_state import train_step
    from camliflow_torch.runtime.trainer import Trainer, device_batch

    trainer = Trainer(cfgs, device)
    trainer.model.load_state_dict(state)
    batch = device_batch(collate([trainer.train_set[i] for i in range(cfgs.model.batch_size)]),
                         device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device) / 2**20
    torch.cuda.reset_peak_memory_stats(device)
    for fn in wrappers.values():
        fn.launches = 0
    loss = float(train_step(trainer.model, trainer.optimizer, batch, trainer.loss_fn,
                            trainer.cfgs.model, 0)[0])
    # copies: the timed step below updates the buffers in place
    grads = {k: p.grad.detach().to("cpu", copy=True) for k, p in trainer.model.named_parameters()}
    buffers = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.named_buffers()}
    ms = None
    steps = 1 + SWITCH_TIMED * timed
    if timed:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for index in range(1, steps):
            train_step(trainer.model, trainer.optimizer, batch, trainer.loss_fn,
                       trainer.cfgs.model, index)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start) / SWITCH_TIMED
    launches = {key: fn.launches / steps for key, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "grads": grads, "buffers": buffers, "launches": launches, "ms": ms,
            "peak": peak, "base": base, "steps": steps}


def compare_steps(got: dict, want: dict) -> dict:
    """One step against another from the same weights and batch: loss
    relative, the worst gradient's share of GRAD_TOL (1 + max|g|), the
    worst BatchNorm statistic's share of BUFFER_TOL (1 + |b|), and whether
    all three are bit for bit."""
    import torch

    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    grad_ratio = max(float((got["grads"][k] - g).abs().max()) / (GRAD_TOL * (1 + float(
        g.abs().max()))) for k, g in want["grads"].items())
    buffer_ratio = max((float(((got["buffers"][k] - b).abs() / (BUFFER_TOL * (1 + b.abs())))
                              .max()) for k, b in want["buffers"].items()
                        if b.is_floating_point()), default=0.0)
    identical = (got["loss"] == want["loss"]
                 and all(torch.equal(got["grads"][k], g) for k, g in want["grads"].items())
                 and all(torch.equal(got["buffers"][k], b) for k, b in want["buffers"].items()))
    return {"loss_rel": loss_rel, "grad_ratio": grad_ratio, "buffer_ratio": buffer_ratio,
            "identical": identical}


def switches_step(device, wrappers, card, data_root: str) -> dict:
    """Phase 12 (b): the flagship's train step at full width through the
    Trainer (`python -m camliflow_torch.train trainset=flyingthings3d_subset
    valset=flyingthings3d_subset model=camliraft`'s config, augmentation
    off, 8192 of the preprocessed points) on (a)'s training set, at batch 2
    and 8, in f32 and in amp: the four settings (stacked, loss_in_scan,
    remat_scan, both) in turns, then stacked again, each from the same
    weights on the same batch (in REMAT_ONLY remat_scan and both, then
    remat_scan again). Each held to stacked (to remat_scan in REMAT_ONLY):
    loss within SWITCH_LOSS_TOL relative, every gradient within GRAD_TOL
    (1 + max|g|), BatchNorm statistics within BUFFER_TOL (1 + |b|); each
    remat setting to its setting without remat bit for bit where the card
    repeats the stacked step, else within the same bounds; launches a step
    held (#1 8, #2 1, #3 and #4 index-only an iteration, the rest 0).
    Returns the launches of every step."""
    from camliflow_torch.models.camliraft import CamLiRAFT
    from camliflow_torch.runtime.checkpoint import random_weights
    from camliflow_torch.utils.config import compose

    total = dict.fromkeys(wrappers, 0)
    want = {**dict.fromkeys(wrappers, 0), "k_nearest_neighbor": 8,
            "furthest_point_sampling": 1, "knn_interpolation": TRAIN_ITERS,
            "correlation3d_knn_index": TRAIN_ITERS}
    model = None
    for batch_size in SWITCH_BATCHES:
        for amp in (False, True):
            def cfgs(label, switches):
                return compose("conf", trainset="flyingthings3d_subset",
                               valset="flyingthings3d_subset", model="camliraft",
                               base="trainer.yaml", overrides=[
                                   f"trainset.root_dir={data_root}",
                                   f"valset.root_dir={data_root}",
                                   f"model.batch_size={batch_size}",
                                   "trainset.augmentation.enabled=false",
                                   f"training.amp={str(amp).lower()}",
                                   "trainset.n_workers=0", "valset.n_workers=0",
                                   "log.tensorboard=false", f"log.dir={WORK}/switches/{label}",
                                   *(f"model.{k}={str(v).lower()}" for k, v in switches.items())])

            base = cfgs("stacked", {})
            if not (base.model.n_iters_train == TRAIN_ITERS and base.trainset.n_points == N_POINTS
                    and base.model.backbone.depth == 50):
                raise AssertionError("the composed config is not the flagship's training config")
            if model is None:  # one set of weights for every setting
                model = CamLiRAFT(base.model.to_dict())
                random_weights(model, SEED + 121)
                state = {k: v.clone() for k, v in model.state_dict().items()}
            precision = "amp" if amp else "f32"
            settings = [(label, switches) for label, switches in SWITCHES
                        if switches.get("remat_scan") or (batch_size, amp) not in REMAT_ONLY]
            ref = settings[0][0]  # stacked, or where it does not fit remat_scan
            runs = {}
            for label, switches in (*settings, (ref + " again", settings[0][1])):
                run = switch_step(cfgs(label.replace(" ", "_"), switches), device, wrappers,
                                  state, timed=not label.endswith("again"))
                if run["launches"] != want:
                    raise AssertionError(f"{label} at batch {batch_size} ({precision}): launches "
                                         f"a step {run['launches']}, expected {want}")
                for key, count in run["launches"].items():
                    total[key] += count * run["steps"]
                runs[label] = run
            repeats = compare_steps(runs.pop(ref + " again"), runs[ref])["identical"]
            unfit = "" if ref == "stacked" else (" (without remat the step needs more memory "
                                                 "than the card has)")
            print(f"  batch {batch_size}, {precision}: the {ref} step repeated bit for bit: "
                  f"{repeats}{unfit} | {card}", flush=True)
            for label, run in runs.items():
                d = compare_steps(run, runs[ref])
                line = (f"    {label:13s} {run['ms']:8.1f} ms a step (the mean of "
                        f"{SWITCH_TIMED} after the first), peak {run['peak']:8.0f} MiB "
                        f"({run['peak'] - run['base']:.0f} above the {run['base']:.0f} alive "
                        f"before), loss {run['loss']:.6f}")
                if label != ref:
                    line += (f", against {ref}: loss relative {d['loss_rel']:.2e}, worst "
                             f"gradient {d['grad_ratio']:.3f} of its bound, BatchNorm "
                             f"statistics {d['buffer_ratio']:.3f} of theirs, bit for bit "
                             f"{d['identical']}")
                plain = {"remat_scan": "stacked", "both": "loss_in_scan"}.get(label)
                if plain in runs:
                    r = compare_steps(run, runs[plain])
                    line += f"; against no remat bit for bit {r['identical']}"
                    if repeats and not r["identical"]:
                        raise AssertionError(f"{label} at batch {batch_size} ({precision}) is "
                                             "not bit for bit its step without remat, on a "
                                             "card that repeats a step")
                    if not (r["loss_rel"] <= SWITCH_LOSS_TOL and r["grad_ratio"] <= 1.0
                            and r["buffer_ratio"] <= 1.0):
                        raise AssertionError(f"{label} against no remat: {r}")
                print(line, flush=True)
                if not (d["loss_rel"] <= SWITCH_LOSS_TOL and d["grad_ratio"] <= 1.0
                        and d["buffer_ratio"] <= 1.0):
                    raise AssertionError(f"{label} at batch {batch_size} ({precision}) against "
                                         f"{ref}: {d}")
            print(f"    launches a step, every setting: "
                  f"{ {k: v for k, v in want.items() if v} } (the fused kernels #5-#13: 0)",
                  flush=True)
    return total


def blocks_step(device, wrappers, card) -> dict:
    """Phase 12 (c): the building blocks no model uses, the card (eval
    mode, #1 selecting) against the CPU (the plain KNN) on the same
    weights and inputs, within CONV_TOL (1 + max|cpu|): PointNet2 at 8192
    -> 4096 points, k 16, widths (64, 64, 128); FusionAwareInterpCVPR, a
    FusionAwareInterp with k 3 and no cache, and CLFM with the add,
    concat and gated heads (each building its own cache) at CamLiPWC's
    level-1 shapes (144x240 pixels against 4096 points, 32 channels);
    InstanceNorm (affine) and LayerNorm at 68x120x128. #1's launches held
    (one a selecting block). Returns them."""
    import copy

    import torch

    from camliflow_torch.nn import clfm, layers, point_conv
    from camliflow_torch.runtime.checkpoint import random_weights

    rng = np.random.RandomState(SEED + 122)
    xyz = (rng.rand(1, BLOCK_POINTS, 3) * [40, 20, 30] + [-20, -10, 5]).astype(np.float32)
    feats = rng.randn(1, BLOCK_POINTS, 64).astype(np.float32)
    uv = (rng.rand(1, BLOCK_SAMPLES, 2) * [CLFM_W + 2, CLFM_H + 2] - 1).astype(np.float32)
    feat_2d = rng.randn(1, CLFM_H, CLFM_W, CLFM_C).astype(np.float32)
    feat_3d = rng.randn(1, BLOCK_SAMPLES, CLFM_C).astype(np.float32)
    norm_x = (2 * rng.randn(*NORM_SHAPE) + 0.5).astype(np.float32)
    blocks = {
        "PointNet2": (point_conv.PointNet2(64, (64, 64, 128), k=16),
                      (xyz, feats, xyz[:, :BLOCK_SAMPLES].copy()), 1),
        "FusionAwareInterpCVPR": (clfm.FusionAwareInterpCVPR(CLFM_C, CLFM_C),
                                  (uv, feat_2d, feat_3d), 1),
        "FusionAwareInterp k=3": (clfm.FusionAwareInterp(CLFM_C, k=3), (uv, feat_2d, feat_3d), 1),
        **{f"CLFM {fn}": (clfm.CLFM(CLFM_C, CLFM_C, fusion_fn=fn), (uv, feat_2d, feat_3d), 1)
           for fn in ("add", "concat", "gated")},
        "InstanceNorm affine": (layers.Norm("instance_norm_affine", 128), (norm_x,), 0),
        "LayerNorm": (layers.Norm("layer_norm", 128), (norm_x,), 0),
    }
    total = dict.fromkeys(wrappers, 0)
    gen = torch.Generator().manual_seed(SEED + 123)
    for label, (module, inputs, knn_launches) in blocks.items():
        with torch.no_grad():
            if isinstance(module, (layers.InstanceNorm, layers.LayerNorm)):
                module.weight.copy_(1 + 0.2 * torch.randn(module.weight.shape, generator=gen))
                module.bias.copy_(0.1 * torch.randn(module.bias.shape, generator=gen))
            else:
                random_weights(module, SEED + 123)
            module.eval()
            card_module = copy.deepcopy(module).to(device)
            cpu_inputs = [torch.from_numpy(a) for a in inputs]
            card_inputs = [a.to(device) for a in cpu_inputs]
            for fn in wrappers.values():
                fn.launches = 0
            out = card_module(*card_inputs)
            torch.cuda.synchronize()
            launches = {key: fn.launches for key, fn in wrappers.items()}
            ms = time_ms(lambda: card_module(*card_inputs), 3)
            ref = module(*cpu_inputs)
        out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
        expected = {**dict.fromkeys(wrappers, 0), "k_nearest_neighbor": knn_launches}
        if launches != expected:
            raise AssertionError(f"{label}: launches {launches}, expected {expected}")
        for key, count in launches.items():
            total[key] += count
        errs = []
        for got, want in zip(out, ref):
            if got.shape != want.shape:
                raise AssertionError(f"{label}: {tuple(got.shape)} against {tuple(want.shape)}")
            err = float((got.cpu() - want).abs().max())
            bound = CONV_TOL * (1 + float(want.abs().max()))
            errs.append(f"{err:.2e} (bound {bound:.2e})")
            if not err <= bound:
                raise AssertionError(f"{label}: card against CPU max|d| {err} > {bound}")
        print(f"  {label}: output {[tuple(o.shape) for o in out]}, card against CPU max|d| "
              f"{', '.join(errs)}; #1 launches {knn_launches}; {ms:.3f} ms a call (events, "
              f"after a warm-up) | {card}", flush=True)
    return total


def leftovers_phase(device, wrappers, card) -> dict:
    """Phase 12: (a) the preprocessing, (b) the training switches, (c) the
    building blocks. Returns (b)'s and (c)'s launches."""
    import os

    root = os.path.join(WORK, "prep")
    start = time.perf_counter()
    data_root = preprocess_step(root, card)
    print(f"  (a) {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    total = switches_step(device, wrappers, card, data_root)
    print(f"  (b) {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    for key, count in blocks_step(device, wrappers, card).items():
        total[key] += count
    print(f"  (c) {time.perf_counter() - start:.1f} s", flush=True)
    return total


def main_paths(wrappers) -> tuple:
    """The main paths, (label, model class, cfgs, takes images, each
    kernel's launches per request, 0 where it never launches), in the order
    phase 4 drives them."""
    from camliflow_torch.models.camliraft import CamLiRAFT
    from camliflow_torch.models.camliraft_l import CamLiRAFTL
    from camliflow_torch.models.camlipwc import CamLiPWC
    from camliflow_torch.models.camlipwc_l import CamLiPWCL
    from camliflow_torch.models.pwc import PWC
    from camliflow_torch.models.raft import RAFT

    # per path, each kernel's launches per request (0: never on this path).
    # The encoders' PointConvs gather twice each (xyz, [xyz, features]):
    # CamLiRAFT-L runs 3 encoder passes of 2 PointConvs, the flagship 2 (both
    # frames share fnet's) and 2 gathers in the final upsample.
    point = {"furthest_point_sampling": 1, "correlation3d_knn": N_ITERS,
             "corr3d_tail": N_ITERS, "correlation3d_knn_index": 0,
             # the exact path (fast_inference auto) launches no fast form
             **dict.fromkeys(FAST_FORMS.values(), 0), "gru_2d_bf16": 0,
             "flow_head_2d_bf16": 0, **dict.fromkeys(GATED_FORMS, 0)}
    flagship = {**point, "k_nearest_neighbor": 8, "knn_interpolation": N_ITERS,
                "gather_points_kmajor": 10, "motion_encoder_2d": N_ITERS,
                "motion_encoder_3d": N_ITERS, "update_2d": 0}
    # with fuse_hidden, #8's halves run on their own (CLFM between them)
    halves = {"gru_2d": N_ITERS, "flow_head_2d": N_ITERS, "gru_flowhead_2d": 0}
    pwc_point = {**dict.fromkeys(wrappers, 0), "k_nearest_neighbor": 20,
                 "furthest_point_sampling": 1, "knn_interpolation": 9,
                 "gather_points_kmajor": 40}
    return (
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


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Proof that the port runs on one CUDA card.")
    parser.add_argument("--other", metavar="TREE",
                        help="another checkout (a parent unpacked by git archive into an "
                             "ignored directory, say) whose #1, #3, #6, #7, #11, #12, #13 "
                             "and the 2D chain's bf16 forms phase 3 times beside this tree's")
    args = parser.parse_args()
    started = time.perf_counter()

    def header(*text, **kwargs):
        """A phase's header line, with the seconds since the start."""
        print(*text, f"(at {time.perf_counter() - started:.1f} s)", **kwargs)

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
    header("[1/13] device:", torch.cuda.get_device_name(0), "| torch",
          torch.__version__, "| CUDA", torch.version.cuda, flush=True)
    card = smi[0] if smi else "nvidia-smi gave no output"
    print(card, flush=True)

    # 2. build
    header("[2/13] build", flush=True)
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
    header("[3/13] kernels vs plain versions at main-path shapes (a plain version "
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
    paths = main_paths(wrappers)
    total = dict.fromkeys(wrappers, 0)
    for label, cls, cfgs, images, per_request in paths:
        # 4. end to end
        has_points = cls not in (RAFT, PWC)
        iterative = cls in (CamLiRAFTL, CamLiRAFT, RAFT)
        points = f"{N_POINTS} pts, " if has_points else ""
        header(f"[4/13] {label} eval: {points}"
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
        header(f"[5/13] {label}: same weights and input on the CPU (plain versions)",
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
    header("[6/13] the Evaluator's one-batch lookahead against a synchronous loop: the "
          f"flagship, 4 batches of {BATCH} frame pairs", flush=True)
    try:
        lookahead_phase(device, card)
    except Exception:
        traceback.print_exc()
        failures.append("lookahead")
    header(f"[7/13] KITTI submission: {KITTI_FRAMES} synthetic frames at {KITTI_W}x{KITTI_H}, "
          f"the flagship, bs={BATCH}, {N_POINTS} pts, densified by #3", flush=True)
    try:
        launches = submission_phase(device, wrappers, flagship_request, card, kernels)
        for key, count in launches.items():
            total[key] += count
    except Exception:
        traceback.print_exc()
        failures.append("submission")
    header(f"[8/13] demo: a synthetic {IMAGE_W}x{IMAGE_H} pair with PFM disparities, the "
          "flagship, on the card and on the CPU", flush=True)
    try:
        launches = demo_phase(device, wrappers, flagship_request, card)
        for key, count in launches.items():
            total[key] += count
    except Exception:
        traceback.print_exc()
        failures.append("demo")
    header(f"[9/13] training: the flagship's Trainer at full width ({IMAGE_W}x{IMAGE_H}, "
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
        header(f"[9/13] training {family}: its Trainer at full width (its own training config, "
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
        header(f"[9/13] KITTI fine-tune {family}: its Trainer on conf/training/kitti/{family}.yaml "
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

    header(f"[10/13] data-parallel: the flagship's Trainer at full width ({IMAGE_W}x{IMAGE_H}, "
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

    header("[11/13] the fast path (fast_inference=on) at full width: CamLiRAFT-L, the flagship, "
          f"fuse_hidden and RAFT at bs=1 and bs={BATCH} against the exact path and the CPU; "
          "the eval CLI", flush=True)
    try:
        start = time.perf_counter()
        launches = fast_phase(device, wrappers, card, paths)
        for key, count in launches.items():
            total[key] += count
        print(f"  fast path: {time.perf_counter() - start:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        failures.append("fast path")

    header("[12/13] the last modules: the FlyingThings3D preprocessing (both modes) on a raw "
          f"synthetic subset at {IMAGE_W}x{IMAGE_H}; the flagship's train step on its output, "
          f"stacked, loss_in_scan, remat_scan and both, at batch {SWITCH_BATCHES}, f32 and amp; "
          "PointNet2, the CVPR interpolation, the fusion heads and the norms against the CPU",
          flush=True)
    try:
        start = time.perf_counter()
        launches = leftovers_phase(device, wrappers, card)
        for key, count in launches.items():
            total[key] += count
        print(f"  last modules: {time.perf_counter() - start:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        failures.append("last modules")

    header(f"[13/13] the gated forms (fast_inference=on): CamLiRAFT-L with "
          "CAMLIFLOW_UPDATE3D=1, the flagship with CAMLIFLOW_UPDATE3D=1 and CAMLIFLOW_CLFM=1, "
          f"the flagship with fuse_hidden and CAMLIFLOW_CLFM=1, at bs=1 and bs={BATCH} against "
          "the fast form and the CPU", flush=True)
    try:
        start = time.perf_counter()
        launches = gated_phase(device, wrappers, card, paths)
        for key, count in launches.items():
            total[key] += count
        print(f"  gated forms: {time.perf_counter() - start:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        failures.append("gated forms")

    # each kernel's launches over the paths' measured requests
    for entry in kernels:
        entry["launches"] = total[entry.pop("wrapper")]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all", flush=True)
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
