"""CamLiRAFT: joint 2D optical flow + 3D scene flow with bidirectional
camera-LiDAR fusion (eval and training).

PyTorch counterpart of camliflow_tpu/models/camliraft.py. The refinement
`nn.scan` is a Python loop and eval is final-only: only the last
iteration's flows are upsampled. The exact path keeps the 2D volume and the
3D cost pyramid f32, with no bf16 casts. With `fast_inference: on` eval
takes the JAX package's fast path: the 2D volume in `lookup_storage`
(`auto`: int8, `ops.correlation.correlation_pyramid`), the 3D pyramid int8
with its row scales (#4's int8 form, #5 with the scale), the hoisted
PointConvDW weights bf16 (#6, #7 and #13 in their bf16 forms), and #9 and,
without `fuse_hidden`, #8 on the tile's bf16 mode. With `fuse_hidden` the
JAX fast path runs GRU2D and FlowHead2D exact, and so does the port (#8's
halves on exact packings). CLFM (#11), the selections, the gathers (#12)
and the upsamples keep their exact math. Two switches of the JAX package,
read at each fast forward's `encode` and applied where it applies them:
CAMLIFLOW_UPDATE3D=1, without `fuse_hidden` and with at most 4096 points in
the loop, makes the hoisted weights int8 (#6's and #7's int8 forms,
`ops.update3d.prepare_int8`); CAMLIFLOW_CLFM=1 runs the corr and motion
fusions in #11's bf16 form (a bf16 score gate, `ops.clfm`), the hidden
fusion staying exact. The 3D branch reuses the CamLiRAFT-L
classes; the 2D branch is the ResNet encoder, the all-pairs pyramid and the
RAFT update modules; CLFM fuses the two at fnet, cnet, corr and motion
(hidden off by default).

In the loop, on CUDA tensors, Correlation3D's tail runs as kernel #5
(ops/corr3d.py), each CLFM call as kernel #11 (ops/clfm.py, on the score
gate, bilinear taps and weights hoisted once per request), MotionEncoder2D
as kernel #9 and GRU2D + FlowHead2D as kernel #8 (ops/update2d.py),
MotionEncoder3D as kernel #6 and GRU3D + FlowHead3D as kernel #7
(ops/update3d.py), on weights packed once per request. The GRUs and flow
heads are contiguous only with `fuse_hidden` off; with it on, CLFM sits
between them, so GRU2D and FlowHead2D run as #8's two halves
(`update2d.gru_2d`, `update2d.flow_head_2d`), where the JAX package falls
back to the plain modules, and GRU3D and FlowHead3D as torch ops around
kernel #13, their PointConvDW tails (`update3d.gru_3d`,
`update3d.flow_head_3d`). The
point encoders' gathers and the final upsample's run as kernel #12
(ops/gather.py).

In train mode (`model.train()`) the model runs the JAX training path,
camliflow_tpu/models/camliraft.py with `train=True` (`CamLiRAFTCore.
forward_train`): fnet_3d per frame with BatchNorm batch statistics, the
flows detached at the top of every iteration, both flows upsampled in every
iteration, the modules' own differentiable forwards. It calls none of the
fused wrappers (#5-#13); the selections run as kernels #1-#4 (#4 in its
index-only form) on integer work, without a gradient. `loss_fn` and
`is_better` are the JAX ones. Two training switches, as in the JAX package:
`loss_in_scan` (with targets in the inputs) adds each iteration's
sequence-loss terms to running sums inside the loop and stacks no sequence
(the outputs carry `loss_2d` and `loss_3d`, which `loss_fn` takes);
`remat_scan` runs each iteration under `torch.utils.checkpoint`, its
selections hoisted before the checkpointed region.

Module names follow the reference state_dict (`core.branch_2d.fnet`,
`core.branch_3d.correlation`, `core.clfm_corr`, ...), so the weight bridge
names every key with runtime/names.py.
"""

from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
from torch import nn

from ..nn.clfm import CLFM, fusion_interp_cache
from ..nn.layers import BatchNorm, compute_precision, full_precision
from ..nn.resnet import ResNetEncoder2D
from ..ops import clfm, corr3d, update2d, update3d
from ..ops.correlation import (
    all_pairs_correlation_pyramid,
    corr_lookup_2d,
    correlation_pyramid,
    resolve_lookup_storage,
)
from ..ops.gather import gather_points_fast, knn_weighted_sum
from ..ops.geometry import (
    backwarp_3d,
    build_pc_pyramid,
    interpolation_weights,
    k_nearest_neighbor,
    quantize_rows_int8,
    resolve_fast_inference,
    weighted_sum,
)
from ..ops.ids import make_parallel_camera_info, paral2persp, persp2paral, project_pc2image
from ..ops.image import InputPadder, mesh_grid
from .camliraft_l import (
    DEFAULT_N_SAMPLES,
    Correlation3D,
    Encoder3D,
    FlowHead3D,
    GRU3D,
    MotionEncoder3D,
    build_cost_volume_pyramid_3d,
    encoder_knn_indices,
)
from .losses import InLoopSequenceLoss, calc_sequence_loss
from .metrics import compute_2d_metrics, compute_3d_metrics, merge_metrics, scalar_metric
from .raft import Correlation2D, ConvexUpsampler2D, FlowHead2D, GRU2D, MotionEncoder2D

# ImageNet statistics of the mmdet backbone
_IMAGENET_MEAN = (123.675, 116.280, 103.530)
_IMAGENET_STD = (58.395, 57.120, 57.375)
CORR_RADIUS = 4
CORR_LEVELS = 4
IN_LOOP = ("corr", "motion", "hidden")  # the fusions run in every iteration


class Branch2D(nn.Module):
    def __init__(self, backbone_depth: int):
        super().__init__()
        self.fnet = ResNetEncoder2D(depth=backbone_depth)
        self.cnet = ResNetEncoder2D(depth=backbone_depth)
        self.cnet_aligner = nn.Linear(128, 256)
        self.correlation = Correlation2D()
        self.motion_encoder = MotionEncoder2D(corr_channels=CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2)
        self.gru = GRU2D(hidden_dim=128, input_dim=256)
        self.flow_head = FlowHead2D()
        self.convex_upsampler = ConvexUpsampler2D()


class Branch3D(nn.Module):
    def __init__(self, n_levels: int):
        super().__init__()
        self.fnet = Encoder3D()
        self.cnet = Encoder3D()
        self.cnet_aligner = nn.Linear(128, 256)
        self.correlation = Correlation3D(n_levels=n_levels, out_channels=128, k=16)
        self.motion_encoder = MotionEncoder3D(corr_dim=128)
        self.gru = GRU3D(hidden_dim=128, input_dim=256)
        self.flow_head = FlowHead3D()


class CamLiRAFTCore(nn.Module):
    """Fused two-branch RAFT core: eval (final-only) through `forward`, training
    through `forward_train`."""

    def __init__(self, n_iters: int = 20, backbone_depth: int = 50, fuse_fnet=True,
                 fuse_cnet=True, fuse_corr=True, fuse_motion=True, fuse_hidden=False,
                 n_samples_list=DEFAULT_N_SAMPLES):
        super().__init__()
        self.n_iters = n_iters
        self.n_samples_list = tuple(n_samples_list)
        self.fuse = {"fnet": fuse_fnet, "cnet": fuse_cnet, "corr": fuse_corr,
                     "motion": fuse_motion, "hidden": fuse_hidden}
        self.branch_2d = Branch2D(backbone_depth)
        self.branch_3d = Branch3D(n_levels=len(self.n_samples_list) - 1)
        for point, channels_2d in (("fnet", 128), ("cnet", 128), ("corr", 324),
                                   ("motion", 128), ("hidden", 128)):
            if self.fuse[point]:
                norm = "batch_norm" if point in ("fnet", "cnet") else None
                self.add_module(f"clfm_{point}", CLFM(channels_2d, 128, norm=norm))

    def fuse_encoders(self, xyz1, xyz2, camera_info, feat1_2d, feat2_2d, featc_2d, feat1_3d,
                      feat2_3d, featc_3d):
        """The points in 1/8-resolution feature-map pixel coordinates, the
        pixel grid's nearest points (both frames in one KNN; uv1's cache is
        reused by every later fusion) and the fnet and cnet fusions. Returns
        (uv1, uv1's cache, the six features fused)."""
        batch = xyz1.shape[0]
        feat_h, feat_w = feat1_2d.shape[1:3]
        scale = torch.tensor([(feat_w - 1) / (camera_info["sensor_w"] - 1),
                              (feat_h - 1) / (camera_info["sensor_h"] - 1)],
                             dtype=torch.float32).to(xyz1.device, non_blocking=True)
        uv1 = project_pc2image(xyz1, camera_info) * scale
        uv2 = project_pc2image(xyz2, camera_info) * scale
        cache_idx, cache_off = fusion_interp_cache(torch.cat([uv1, uv2], dim=0),
                                                   feat_h, feat_w)
        cache1 = (cache_idx[:batch], cache_off[:batch])
        cache2 = (cache_idx[batch:], cache_off[batch:])
        if self.fuse["fnet"]:  # one CLFM shared by both frames
            feat1_2d, feat1_3d = self.clfm_fnet(uv1, feat1_2d, feat1_3d, cache1)
            feat2_2d, feat2_3d = self.clfm_fnet(uv2, feat2_2d, feat2_3d, cache2)
        if self.fuse["cnet"]:
            featc_2d, featc_3d = self.clfm_cnet(uv1, featc_2d, featc_3d, cache1)
        return uv1, cache1, (feat1_2d, feat2_2d, featc_2d, feat1_3d, feat2_3d, featc_3d)

    def encode(self, image1, image2, pc1, pc2, camera_info, fast: bool = False,
               storage: str = "split"):
        """Everything before the loop: features, fusion, volumes, caches and
        the weights the loop reads (hoisted once); `fast`: the fast path's
        storages and packings, `storage`: the 2D volume's."""
        b2d, b3d = self.branch_2d, self.branch_3d
        xyzs1, xyzs2, _, _ = build_pc_pyramid(pc1, pc2, list(self.n_samples_list))
        batch = image1.shape[0]

        # both frames share one fnet call (its BatchNorms use running stats)
        fmaps = b2d.fnet(torch.cat([image1, image2], dim=0))
        feat1_2d, feat2_2d = fmaps[:batch], fmaps[batch:]
        featc_2d = b2d.cnet(image1)

        # one two-frame KNN per level serves fnet and cnet; eval stacks fnet
        stacked = [torch.cat([a, b], dim=0) for a, b in zip(xyzs1[:3], xyzs2[:3])]
        knn_both = encoder_knn_indices(stacked)
        feats = b3d.fnet(stacked, knn_indices=knn_both)[2]
        feat1_3d, feat2_3d = feats[:batch], feats[batch:]
        featc_3d = b3d.cnet(xyzs1[:3], knn_indices=[idx[:batch] for idx in knn_both])[2]

        xyzs2 = xyzs2[2:]
        xyz1 = xyzs1[2]

        feat_h, feat_w = feat1_2d.shape[1:3]
        uv1, cache1, (feat1_2d, feat2_2d, featc_2d, feat1_3d, feat2_3d, featc_3d) = (
            self.fuse_encoders(xyz1, xyzs2[0], camera_info, feat1_2d, feat2_2d, featc_2d,
                               feat1_3d, feat2_3d, featc_3d))

        h_2d, x_2d = torch.chunk(b2d.cnet_aligner(featc_2d), 2, dim=-1)
        h_3d, x_3d = torch.chunk(b3d.cnet_aligner(featc_3d), 2, dim=-1)
        aligner = b2d.correlation.fnet_aligner
        knn_indices = k_nearest_neighbor(xyz1, xyz1, 32)
        # the JAX package's switches, read per request: its int8 3D chain
        # (not with fuse_hidden, at most 4096 points) and its bf16 CLFM (the
        # corr and motion fusions)
        int8 = update3d.int8_form(fast, xyz1.shape[1], self.fuse["hidden"])
        clfm16 = fast and clfm.bf16_enabled()
        store = update3d.to_bf16 if fast else (lambda dw: dw)
        state = {"h_2d": torch.tanh(h_2d).contiguous(), "h_3d": torch.tanh(h_3d),
                 "flow_2d": feat1_2d.new_zeros(batch, feat_h, feat_w, 2),
                 "flow_3d": torch.zeros_like(xyz1)}
        consts = {
            "xyz1": xyz1, "xyzs2": xyzs2, "cache1": cache1,
            "grid": mesh_grid(batch, feat_h, feat_w, device=pc1.device),
            "x_2d": torch.relu(x_2d).contiguous(), "x_3d": torch.relu(x_3d),
            "pyramid_2d": correlation_pyramid(aligner(feat1_2d), aligner(feat2_2d),
                                              CORR_LEVELS, storage),
            "pyramid_3d": torch.cat(build_cost_volume_pyramid_3d(feat1_3d, feat2_3d, xyzs2),
                                    dim=-1),
            "knn_indices": knn_indices,
            # after the volumes: the peak of their build holds no hoisted
            # weights; bf16 on the fast path, a module's at a time (int8:
            # the bf16 weights quantised below, as the JAX package does)
            "dw": {name: store(getattr(b3d, name).precompute_weights(xyz1, knn_indices))
                   for name in ("motion_encoder", "gru", "flow_head")},
            "tail_params": corr3d.prepare_corr3d_tail_params(b3d.correlation),
            "me_params": update2d.prepare_motion_encoder_params(b2d.motion_encoder, bf16=fast),
            # each in-loop fusion's score gate and packed weights, and the
            # bilinear taps at uv1 they share
            "clfm": {point: (clfm.hoist_interp_score(getattr(self, f"clfm_{point}").interp,
                                                     cache1[1], clfm16 and point != "hidden"),
                             clfm.prepare_clfm_params(getattr(self, f"clfm_{point}"),
                                                      clfm16 and point != "hidden"))
                     for point in IN_LOOP if self.fuse[point]},
            "taps": clfm.grid_sample_cache(uv1, feat_h, feat_w),
        }
        if fast:  # int8, a scale a query row
            consts["pyramid_3d"], consts["pyramid_3d_scale"] = quantize_rows_int8(
                consts["pyramid_3d"])
        if int8:
            consts["dw"], consts["me3d_params"], consts["gf3d_params"] = (
                update3d.prepare_int8(consts["dw"], b3d.motion_encoder, b3d.gru,
                                      b3d.flow_head))
        else:
            consts["me3d_params"] = update3d.prepare_motion_encoder_3d_params(b3d.motion_encoder)
        if self.fuse["hidden"]:
            # the JAX fast path runs GRU2D and FlowHead2D exact here
            consts["gru2d_params"] = update2d.prepare_gru_params(b2d.gru)
            consts["head2d_params"] = update2d.prepare_flow_head_params(b2d.flow_head)
            consts["gru3d_params"] = update3d.prepare_gru_3d_params(b3d.gru)
            consts["head3d_params"] = update3d.prepare_flow_head_3d_params(b3d.flow_head)
        else:
            consts["gf_params"] = update2d.prepare_gru_flowhead_params(b2d.gru, b2d.flow_head,
                                                                        bf16=fast)
            if not int8:
                consts["gf3d_params"] = update3d.prepare_gru_flowhead_3d_params(b3d.gru,
                                                                               b3d.flow_head)
            consts["gf3d_dw"] = {**consts["dw"]["gru"], **consts["dw"]["flow_head"]}
        return state, consts

    def iterate(self, state, consts):
        """One refinement iteration over both branches."""
        b2d, b3d = self.branch_2d, self.branch_3d
        h_2d, h_3d, flow_2d, flow_3d = (state[k] for k in ("h_2d", "h_3d", "flow_2d", "flow_3d"))
        xyz1, nn_idx = consts["xyz1"], consts["cache1"][0]
        knn_indices, dw = consts["knn_indices"], consts["dw"]
        xyzs2 = consts["xyzs2"]

        def fuse(point, feat_2d, feat_3d):
            score, params = consts["clfm"][point]
            return clfm.clfm_fused(feat_2d.contiguous(), feat_3d.contiguous(), score, nn_idx,
                                   *consts["taps"], params)

        # one backwarp at the finest level serves every prefix-nested level
        xyz2_warp_full = backwarp_3d(xyz1, xyzs2[0], flow_3d)
        corr_2d = corr_lookup_2d(consts["pyramid_2d"], consts["grid"] + flow_2d,
                                 radius=CORR_RADIUS)
        corr_3d = b3d.correlation(xyz1, xyz2_warp_full, tuple(x.shape[1] for x in xyzs2),
                                  consts["pyramid_3d"], consts["tail_params"],
                                  consts.get("pyramid_3d_scale"))
        if self.fuse["corr"]:
            corr_2d, corr_3d = fuse("corr", corr_2d, corr_3d)

        motion_2d = update2d.motion_encoder_2d(flow_2d, corr_2d, consts["me_params"])
        motion_3d = update3d.motion_encoder_3d(flow_3d, corr_3d.contiguous(), knn_indices,
                                               dw["motion_encoder"], consts["me3d_params"])
        if self.fuse["motion"]:
            motion_2d, motion_3d = fuse("motion", motion_2d, motion_3d)

        if self.fuse["hidden"]:
            h_2d = update2d.gru_2d(h_2d, consts["x_2d"], motion_2d, consts["gru2d_params"])
            h_3d = update3d.gru_3d(h_3d, torch.cat([consts["x_3d"], motion_3d], dim=-1),
                                   knn_indices, dw["gru"], consts["gru3d_params"])
            h_2d, h_3d = fuse("hidden", h_2d, h_3d)
            delta_2d = update2d.flow_head_2d(h_2d, consts["head2d_params"])
            delta_3d = update3d.flow_head_3d(h_3d, knn_indices, dw["flow_head"],
                                             consts["head3d_params"])
        else:
            h_2d, delta_2d = update2d.gru_flowhead_2d(h_2d, consts["x_2d"], motion_2d,
                                                      consts["gf_params"])
            h_3d, delta_3d = update3d.gru_flowhead_3d(h_3d, consts["x_3d"],
                                                      motion_3d.contiguous(), knn_indices,
                                                      consts["gf3d_dw"], consts["gf3d_params"])
        return {"h_2d": h_2d, "h_3d": h_3d, "flow_2d": flow_2d + delta_2d,
                "flow_3d": flow_3d + delta_3d}

    def forward(self, image1, image2, pc1, pc2, camera_info, fast: bool = False,
                storage: str = "split"):
        """Padded, normalised images [B, H, W, 3] and IDS clouds [B, N, 3] ->
        (flow_2d [B, H, W, 2], flow_3d [B, N, 3]) after the last iteration;
        `fast` and `storage` as `encode` takes them."""
        state, consts = self.encode(image1, image2, pc1, pc2, camera_info, fast, storage)
        for _ in range(self.n_iters):
            state = self.iterate(state, consts)
        flow_2d = self.branch_2d.convex_upsampler(state["h_2d"], state["flow_2d"])
        # 2048 -> full cloud: inverse-distance weights of the 3 nearest
        xyz1 = consts["xyz1"]
        up_idx = k_nearest_neighbor(xyz1, pc1, 3)
        dists = torch.linalg.vector_norm(gather_points_fast(xyz1, up_idx) - pc1[:, :, None, :],
                                         dim=-1)
        weights = 1.0 / torch.clamp(dists, min=1e-8)
        weights = weights / weights.sum(dim=-1, keepdim=True)
        return flow_2d, knn_weighted_sum(state["flow_3d"], up_idx, weights)

    def in_loop_modules(self) -> list[nn.Module]:
        """The modules an iteration of `forward_train` runs."""
        b2d, b3d = self.branch_2d, self.branch_3d
        return [b2d.motion_encoder, b2d.gru, b2d.flow_head, b2d.convex_upsampler,
                b3d.correlation, b3d.motion_encoder, b3d.gru, b3d.flow_head,
                *(getattr(self, f"clfm_{point}") for point in IN_LOOP if self.fuse[point])]

    def forward_train(self, image1, image2, pc1, pc2, camera_info, n_iters: int,
                      loss=None, remat: bool = False):
        """The training forward: (flow_2d_seq [T, B, H, W, 2], flow_3d_seq
        [T, B, N, 3]), both flows upsampled in every iteration. Under a bf16
        `compute_precision` the cost volumes stay f32 (`full_precision`),
        as the JAX einsums do, and the selections take f32 inputs.

        `loss` (loss_in_scan): a `losses.InLoopSequenceLoss` and the map of
        an upsampled 3D flow to the target's frame; each iteration adds its
        terms to the running sums and no sequence is stacked: returns
        (flow_2d, flow_3d of the last iteration, loss_2d, loss_3d).
        `remat` (remat_scan): each iteration runs under
        `torch.utils.checkpoint` (non-reentrant), so the backward recomputes
        its activations instead of keeping them; losses and gradients are
        unchanged. The iteration's selections (the backwarp's #3 and #4's
        index-only form, both on the detached flow) run before the
        checkpointed region, once: the recompute launches no kernel."""
        b2d, b3d = self.branch_2d, self.branch_3d
        device_type = image1.device.type
        xyzs1, xyzs2, _, _ = build_pc_pyramid(pc1, pc2, list(self.n_samples_list))
        batch = image1.shape[0]

        # the backbone's BatchNorms use running statistics: both frames share
        # one fnet call, as at eval
        fmaps = b2d.fnet(torch.cat([image1, image2], dim=0))
        feat1_2d, feat2_2d = fmaps[:batch], fmaps[batch:]
        featc_2d = b2d.cnet(image1)

        # fnet_3d per frame (its BatchNorms take per-frame batch statistics);
        # one two-frame KNN per level serves fnet and cnet
        stacked = [torch.cat([a, b], dim=0) for a, b in zip(xyzs1[:3], xyzs2[:3])]
        knn_both = encoder_knn_indices(stacked)
        knn_f1 = [idx[:batch] for idx in knn_both]
        feat1_3d = b3d.fnet(xyzs1[:3], knn_indices=knn_f1)[2]
        feat2_3d = b3d.fnet(xyzs2[:3], knn_indices=[idx[batch:] for idx in knn_both])[2]
        featc_3d = b3d.cnet(xyzs1[:3], knn_indices=knn_f1)[2]

        xyzs2 = xyzs2[2:]
        xyz1 = xyzs1[2]
        feat_h, feat_w = feat1_2d.shape[1:3]
        uv1, cache1, (feat1_2d, feat2_2d, featc_2d, feat1_3d, feat2_3d, featc_3d) = (
            self.fuse_encoders(xyz1, xyzs2[0], camera_info, feat1_2d, feat2_2d, featc_2d,
                               feat1_3d, feat2_3d, featc_3d))

        h_2d, x_2d = torch.chunk(b2d.cnet_aligner(featc_2d), 2, dim=-1)
        h_3d, x_3d = torch.chunk(b3d.cnet_aligner(featc_3d), 2, dim=-1)
        h_2d, x_2d = torch.tanh(h_2d.float()), torch.relu(x_2d.float())
        h_3d, x_3d = torch.tanh(h_3d.float()), torch.relu(x_3d.float())
        aligner = b2d.correlation.fnet_aligner
        align1, align2 = aligner(feat1_2d.float()), aligner(feat2_2d.float())
        with full_precision(device_type):
            pyramid_2d = all_pairs_correlation_pyramid(align1.float(), align2.float(),
                                                       CORR_LEVELS)
            pyramid_3d = torch.cat(build_cost_volume_pyramid_3d(
                feat1_3d.float(), feat2_3d.float(), xyzs2), dim=-1)
        knn_indices = k_nearest_neighbor(xyz1, xyz1, 32)
        # the 3D upsample's neighbours and weights (2048 -> full cloud), once
        up_idx, up_weights = interpolation_weights(xyz1, pc1, 3)
        grid = mesh_grid(batch, feat_h, feat_w, device=pc1.device)
        level_sizes = tuple(x.shape[1] for x in xyzs2)
        # the loop-invariant PointConvDW weights, in the graph
        dw = {name: getattr(b3d, name).precompute_weights(xyz1, knn_indices)
              for name in ("motion_encoder", "gru", "flow_head")}

        def iteration(h_2d, h_3d, flow_2d, flow_3d, xyz2_warp_full, corr_idx, *accs):
            corr_2d = corr_lookup_2d(pyramid_2d, grid + flow_2d, radius=CORR_RADIUS)
            corr_3d = b3d.correlation.forward_train(xyz1, xyz2_warp_full, level_sizes,
                                                    pyramid_3d, corr_idx)
            if self.fuse["corr"]:
                corr_2d, corr_3d = self.clfm_corr(uv1, corr_2d, corr_3d, cache1)
            motion_2d = b2d.motion_encoder(flow_2d, corr_2d)
            motion_3d = b3d.motion_encoder(xyz1, flow_3d, corr_3d, knn_indices,
                                           dw["motion_encoder"])
            if self.fuse["motion"]:
                motion_2d, motion_3d = self.clfm_motion(uv1, motion_2d, motion_3d, cache1)
            h_2d = b2d.gru(h_2d, torch.cat([x_2d, motion_2d], dim=-1))
            h_3d = b3d.gru(xyz1, h_3d, torch.cat([x_3d, motion_3d], dim=-1), knn_indices,
                           dw["gru"])
            if self.fuse["hidden"]:
                h_2d, h_3d = self.clfm_hidden(uv1, h_2d, h_3d, cache1)
            flow_2d = flow_2d + b2d.flow_head(h_2d)
            flow_3d = flow_3d + b3d.flow_head(xyz1, h_3d, knn_indices, dw["flow_head"]).float()
            up_2d = b2d.convex_upsampler(h_2d, flow_2d)
            up_3d = weighted_sum(flow_3d, up_idx, up_weights)
            if loss is not None:
                terms, to_target_3d = loss
                with full_precision(device_type):  # as the stacked loss, outside autocast
                    accs = terms.accumulate(*accs, up_2d, to_target_3d(up_3d))
            return (h_2d, h_3d, flow_2d, flow_3d, up_2d, up_3d, *accs)

        if remat:
            body = functools.partial(torch.utils.checkpoint.checkpoint, iteration,
                                     use_reentrant=False)
        else:
            body = iteration
        flow_2d = feat1_2d.new_zeros(batch, feat_h, feat_w, 2, dtype=torch.float32)
        flow_3d = torch.zeros_like(xyz1)
        accs = (flow_3d.new_zeros(()), flow_3d.new_zeros(())) if loss is not None else ()
        seq_2d, seq_3d = [], []
        for _ in range(n_iters):
            flow_2d, flow_3d = flow_2d.detach(), flow_3d.detach()
            xyz2_warp_full = backwarp_3d(xyz1, xyzs2[0], flow_3d)
            corr_idx = b3d.correlation.select_train(xyz1, xyz2_warp_full, level_sizes)
            h_2d, h_3d, flow_2d, flow_3d, up_2d, up_3d, *accs = body(
                h_2d, h_3d, flow_2d, flow_3d, xyz2_warp_full, corr_idx, *accs)
            if loss is None:
                seq_2d.append(up_2d)
                seq_3d.append(up_3d)
        if loss is not None:
            return up_2d, up_3d, *accs
        return torch.stack(seq_2d), torch.stack(seq_3d)


class CamLiRAFT(nn.Module):
    """Model wrapper: ImageNet normalisation, padding, IDS and the core. In
    train mode it runs `CamLiRAFTCore.forward_train` for `n_iters_train`
    iterations under `compute_dtype` (bf16 autocast or f32); eval stays
    f32, or takes the fast path with `fast_inference: on`. `freeze_bn`
    keeps every BatchNorm on its running statistics in train mode.
    `loss_in_scan` and `remat_scan` act in train mode only (see
    `CamLiRAFTCore.forward_train`)."""

    def __init__(self, cfgs: dict):
        super().__init__()
        self.fast_inference = str(cfgs.get("fast_inference", "auto"))
        self.lookup_storage = str(cfgs.get("lookup_storage", "auto"))
        resolve_fast_inference(self.fast_inference, False)  # raise on unknown modes
        resolve_lookup_storage(self.lookup_storage)
        self.loss_in_scan = bool(cfgs.get("loss_in_scan", False))
        self.remat_scan = bool(cfgs.get("remat_scan", False))
        self.loss_cfgs = (cfgs.get("loss2d"), cfgs.get("loss3d"))
        self.n_iters_train = int(cfgs.get("n_iters_train", cfgs["n_iters_eval"]))
        self.freeze_bn = bool(cfgs.get("freeze_bn", False))
        self.compute_dtype = cfgs.get("compute_dtype")
        compute_precision(self.compute_dtype, "cpu")  # raises on a dtype it does not know
        self.core = CamLiRAFTCore(
            n_iters=int(cfgs["n_iters_eval"]),
            backbone_depth=int(cfgs["backbone"]["depth"]),
            fuse_fnet=bool(cfgs["fuse_fnet"]),
            fuse_cnet=bool(cfgs["fuse_cnet"]),
            fuse_corr=bool(cfgs["fuse_corr"]),
            fuse_motion=bool(cfgs["fuse_motion"]),
            fuse_hidden=bool(cfgs["fuse_hidden"]),
            n_samples_list=tuple(cfgs.get("n_samples_list", DEFAULT_N_SAMPLES)),
        )
        if self.remat_scan and any(isinstance(m, BatchNorm) for module in
                                   self.core.in_loop_modules() for m in module.modules()):
            # a recomputed iteration would move the running statistics twice
            raise ValueError("remat_scan: an iteration's modules hold a BatchNorm")
        # on the model's device with it, so no forward copies them from the
        # host (which would make the host wait for the card); not weights
        self.register_buffer("image_mean", torch.tensor(_IMAGENET_MEAN), persistent=False)
        self.register_buffer("image_std", torch.tensor(_IMAGENET_STD), persistent=False)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.freeze_bn:
            for module in self.modules():
                if isinstance(module, BatchNorm):
                    module.eval()
        return self

    def forward(self, inputs: dict) -> dict:
        images = inputs["images"].float()
        pcs = inputs["pcs"].float()
        intrinsics = inputs["intrinsics"].float()
        padder = InputPadder(images.shape, x=8)
        image1, image2 = padder.pad(images[..., :3], images[..., 3:])
        image1 = ((image1 - self.image_mean) / self.image_std).contiguous()
        image2 = ((image2 - self.image_mean) / self.image_std).contiguous()

        persp_cam = {
            "projection_mode": "perspective",
            "sensor_h": image1.shape[1],
            "sensor_w": image1.shape[2],
            "f": intrinsics[:, 0],
            "cx": intrinsics[:, 1],
            "cy": intrinsics[:, 2],
        }
        paral_cam = make_parallel_camera_info(image1.shape[1], image1.shape[2])
        pc1 = persp2paral(pcs[..., :3], persp_cam, paral_cam)
        pc2 = persp2paral(pcs[..., 3:], persp_cam, paral_cam)

        base = paral2persp(pc1, persp_cam, paral_cam)
        if self.training and self.loss_in_scan and "flow_2d" in inputs and "flow_3d" in inputs:
            # the 2D target zero-padded as the images are (validity 0 there)
            left, right, top, bottom = padder._pad
            target_2d = inputs["flow_2d"].float()
            if target_2d.shape[-1] == 2:
                target_2d = torch.cat([target_2d, torch.ones_like(target_2d[..., :1])], dim=-1)
            target_2d = torch.nn.functional.pad(target_2d, (0, 0, left, right, top, bottom))
            terms = InLoopSequenceLoss(target_2d, inputs["flow_3d"], *self.loss_cfgs)

            def to_target_3d(flow):  # IDS back to the perspective camera
                return paral2persp(pc1 + flow, persp_cam, paral_cam) - base

            with compute_precision(self.compute_dtype, image1.device.type):
                flow_2d, flow_3d, loss_2d, loss_3d = self.core.forward_train(
                    image1, image2, pc1, pc2, paral_cam, self.n_iters_train,
                    (terms, to_target_3d), self.remat_scan)
            return {"flow_2d": padder.unpad(flow_2d), "flow_3d": to_target_3d(flow_3d.float()),
                    "loss_2d": loss_2d, "loss_3d": loss_3d}
        if self.training:
            with compute_precision(self.compute_dtype, image1.device.type):
                seq_2d, seq_3d = self.core.forward_train(image1, image2, pc1, pc2, paral_cam,
                                                         self.n_iters_train,
                                                         remat=self.remat_scan)
            seq_2d = padder.unpad(seq_2d.flatten(0, 1)).unflatten(0, seq_2d.shape[:2])
            seq_3d = paral2persp(pc1 + seq_3d.float(), persp_cam, paral_cam) - base
            return {"flow_2d": seq_2d[-1], "flow_3d": seq_3d[-1],
                    "flow_2d_seq": seq_2d, "flow_3d_seq": seq_3d}
        fast = resolve_fast_inference(self.fast_inference, True)
        flow_2d, flow_3d = self.core(image1, image2, pc1, pc2, paral_cam, fast,
                                     resolve_lookup_storage(self.lookup_storage, fast))
        flow_2d = padder.unpad(flow_2d)
        flow_3d = paral2persp(pc1 + flow_3d, persp_cam, paral_cam) - base
        return {"flow_2d": flow_2d, "flow_3d": flow_3d,
                "flow_2d_seq": flow_2d[None], "flow_3d_seq": flow_3d[None]}


def loss_fn(outputs: dict, inputs: dict, cfgs) -> tuple[torch.Tensor, dict]:
    """Joint sequence losses and metrics (the JAX `loss_fn`): (loss, (sum,
    count) metrics)."""
    target_2d, target_3d = inputs["flow_2d"], inputs["flow_3d"]
    if "loss_2d" in outputs:  # loss_in_scan: accumulated inside the loop
        loss_2d, loss_3d = outputs["loss_2d"], outputs["loss_3d"]
    else:
        loss_2d = calc_sequence_loss(outputs["flow_2d_seq"], target_2d,
                                     gamma=cfgs["loss2d"]["gamma"], order=cfgs["loss2d"]["order"])
        loss_3d = calc_sequence_loss(outputs["flow_3d_seq"], target_3d,
                                     gamma=cfgs["loss3d"]["gamma"], order=cfgs["loss3d"]["order"])
    loss = loss_2d + loss_3d
    metrics = merge_metrics(
        {"loss": scalar_metric(loss), "loss2d": scalar_metric(loss_2d),
         "loss3d": scalar_metric(loss_3d)},
        compute_2d_metrics(outputs["flow_2d"], target_2d),
        compute_3d_metrics(outputs["flow_3d"], target_3d),
    )
    if "occ_mask_3d" in inputs:
        metrics = merge_metrics(metrics, compute_3d_metrics(
            outputs["flow_3d"], target_3d, occ_mask=inputs["occ_mask_3d"]))
    return loss, metrics


def is_better(curr: dict, best: dict | None) -> bool:
    return best is None or curr["epe2d"] < best["epe2d"]
