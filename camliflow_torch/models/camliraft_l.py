"""CamLiRAFT-L: LiDAR-only iterative scene flow (point-space RAFT), eval
and training.

PyTorch counterpart of camliflow_tpu/models/camliraft_l.py. The
refinement `nn.scan` is a Python loop, and eval is final-only: only the last
iteration's flow is upsampled to the full cloud. The exact path keeps the
cost pyramid and the hoisted PointConvDW weights f32. With
`fast_inference: on` eval takes the JAX package's fast path
(`ops.geometry.resolve_fast_inference`): the cost pyramid stored int8 with
a scale per query row (#4 reads it, #5 dequantises the selected costs
before the cost MLP) and the hoisted weights stored bf16 (#6 and #7 take
their bf16 forms: bf16 gathers and products, f32 dense layers). With
CAMLIFLOW_UPDATE3D=1 as well, read at each fast forward, and at most 4096
points in the loop (the JAX package's own conditions), the hoisted weights
are int8 with their scales folded into the MLPs and #6 and #7 take their
int8 forms (bf16 operands in every dense layer too), as the JAX package's
Pallas chain computes them (`ops.update3d.prepare_int8`).

Module names follow the reference PyTorch state_dict (`core.fnet`,
`core.correlation`, ...), so the weight bridge (runtime/checkpoint.py) names
every key with runtime/names.py. The selections run through the kernel
wrappers in ops/: FPS and KNN once per frame, the encoders' k-major gathers
(kernel #12, ops/gather.py), KNN interpolation and Correlation3D every
iteration (the selection as kernel #4, its tail as kernel #5,
ops/corr3d.py). In the loop, MotionEncoder3D runs as kernel #6 and GRU3D +
FlowHead3D as kernel #7 (ops/update3d.py), on weights packed once per
request.

The modules' own `forward`s are the differentiable chains the flagship
trains through (camliflow_tpu's exact path with `train=True`): in train
mode Correlation3D selects with #4's index-only form under `no_grad`, then
gathers the costs and the neighbours' coordinates with `torch.gather`;
MotionEncoder3D, GRU3D and FlowHead3D run their PointConvDWs as torch ops
on the hoisted weights, which stay in the graph.

In train mode (`model.train()`) CamLiRAFT-L runs that path
(`CamLiRAFTLCore.forward_train`, camliflow_tpu's core with `train=True`):
the encoders' BatchNorms on batch statistics, per frame, the flow detached
at the top of every iteration (the backwarp's interpolation, #3, sees it
detached) and every iteration's flow upsampled to the full cloud through
one shared k=3 selection (#1). `loss_fn` and `is_better` are the JAX ones.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ..nn.layers import MLP, DenseNormAct, compute_precision, full_precision
from ..nn.point_conv import PointConv, PointConvDW, paired_dw_conv
from ..ops import corr3d, update3d
from ..ops.geometry import (
    backwarp_3d,
    build_pc_pyramid,
    gather_points,
    interpolation_weights,
    k_nearest_neighbor,
    knn_interpolation,
    quantize_rows_int8,
    resolve_fast_inference,
    weighted_sum,
)
from ..ops.ids import make_parallel_camera_info, paral2persp, persp2paral
from .losses import calc_sequence_loss
from .metrics import compute_3d_metrics, merge_metrics, scalar_metric

DEFAULT_N_SAMPLES = (4096, 2048, 1024, 512, 256)


class Encoder3D(nn.Module):
    """3-level point feature encoder."""

    def __init__(self, n_channels=(64, 96, 128), norm="batch_norm", k: int = 16):
        super().__init__()
        c = n_channels
        self.level0_mlp = MLP(3, [c[0], c[0]])
        self.mlps = nn.ModuleList(
            MLP(c[i], [c[i], c[i + 1]]) for i in range(len(c) - 1)
        )
        self.convs = nn.ModuleList(
            PointConv(c[i + 1], c[i + 1], norm=norm, k=k) for i in range(len(c) - 1)
        )

    def forward(self, xyzs, knn_indices=None):
        feats = [self.level0_mlp(xyzs[0])]
        for i, (mlp, conv) in enumerate(zip(self.mlps, self.convs)):
            feat = mlp(feats[-1])
            feats.append(conv(
                xyzs[i], feat, xyzs[i + 1],
                knn_indices=None if knn_indices is None else knn_indices[i],
            ))
        return feats


def encoder_knn_indices(xyzs, k: int = 16):
    """Level-to-level KNN indices shared by the feature and context encoders."""
    return [k_nearest_neighbor(xyzs[i], xyzs[i + 1], k) for i in range(len(xyzs) - 1)]


def build_cost_volume_pyramid_3d(feat1, feat2, xyzs2, k: int = 3):
    """All-pairs cost [B, N, M0] then KNN-average pooling down the frame-2
    levels: a list of [B, N, M_i] volumes."""
    dim = feat1.shape[-1]
    pyramid = [torch.matmul(feat1.float(), feat2.float().transpose(1, 2)) / dim]
    for i in range(1, len(xyzs2)):
        idx = k_nearest_neighbor(xyzs2[i - 1], xyzs2[i], k)  # [B, M_i, k]
        prev = pyramid[-1]
        batch, n = prev.shape[:2]
        cols = idx.reshape(batch, 1, -1).long().expand(batch, n, -1)
        pooled = torch.gather(prev, 2, cols).reshape(batch, n, idx.shape[1], k)
        pyramid.append(pooled.mean(dim=-1))
    return pyramid


@functools.lru_cache(maxsize=16)
def _level_columns(level_sizes: tuple[int, ...], k: int, device: torch.device) -> torch.Tensor:
    """[L*k] pyramid column offset of each selected entry, made once per
    (levels, device): a tensor built from host data mid-loop would make the
    host wait for the card."""
    return corr3d.level_offsets(level_sizes, k, device)


class Correlation3D(nn.Module):
    """Multi-scale correlation lookup over prefix-nested frame-2 levels."""

    def __init__(self, n_levels: int = 4, out_channels: int = 128, k: int = 16):
        super().__init__()
        self.k = k
        self.cost_mlp = MLP(4, [out_channels // 4, out_channels // 4], act="relu")
        self.merge = DenseNormAct(n_levels * (out_channels // 4), out_channels)

    def select_train(self, xyz1, xyz2_warp_full, level_sizes) -> torch.Tensor:
        """The training path's selection: #4's index-only form, without a
        gradient (the indices are integers), [B, N, L*k] int32."""
        with torch.no_grad():
            idx, _ = corr3d.correlation3d_knn(xyz1.float(), xyz2_warp_full.float(), None,
                                              tuple(int(m) for m in level_sizes), k=self.k,
                                              with_cost=False)
        return idx

    def forward_train(self, xyz1, xyz2_warp_full, level_sizes, pyramid_cat, idx):
        """The training path (camliflow_tpu Correlation3D, exact, with the
        train selection): on `select_train`'s indices, the costs and the
        neighbours' coordinates gathered differentiably; the cost MLP, the
        per-level sum and the merge as torch ops."""
        level_sizes = tuple(int(m) for m in level_sizes)
        columns = idx.long() + _level_columns(level_sizes, self.k, idx.device)
        knn_cost = torch.gather(pyramid_cat, 2, columns)  # [B, N, L*k]
        rel = gather_points(xyz2_warp_full, idx) - xyz1[:, :, None, :]
        cost = self.cost_mlp(torch.cat([rel, knn_cost[..., None]], dim=-1))
        batch, n = xyz1.shape[:2]
        levels = cost.reshape(batch, n, len(level_sizes), self.k, -1).sum(dim=3)
        return self.merge(levels.reshape(batch, n, -1))

    def forward(self, xyz1, xyz2_warp_full, level_sizes, pyramid_cat, params=None,
                scale=None):
        """The eval path (kernels #4 and #5). pyramid_cat: [B, N,
        sum(level_sizes)], concatenated once outside the refinement loop,
        f32 or (the fast path) int8 with its row scales `scale` [B, N, 1];
        params: `corr3d.prepare_corr3d_tail_params` of this module (packed
        here when not given)."""
        idx, knn_cost = corr3d.correlation3d_knn(
            xyz1, xyz2_warp_full, pyramid_cat, level_sizes, k=self.k
        )  # [B, N, L*k] each
        if params is None:
            params = corr3d.prepare_corr3d_tail_params(self)
        return corr3d.corr3d_tail(xyz1, xyz2_warp_full, idx, knn_cost, params,
                                  len(level_sizes), self.k, scale)


class MotionEncoder3D(nn.Module):
    """corr + flow -> motion features."""

    NAMES = ("conv_c1", "conv_f1", "conv_f2", "conv")

    def __init__(self, corr_dim: int = 128):
        super().__init__()
        self.conv_c1 = PointConvDW(corr_dim, corr_dim, k=16)
        self.conv_f1 = PointConvDW(3, 32, k=32)
        self.conv_f2 = PointConvDW(32, 16, k=16)
        self.conv = PointConvDW(corr_dim + 16, 128 - 3, k=16)

    def precompute_weights(self, xyz, knn_indices):
        """Each conv's hoisted weights [B, N, k, C], with rows a multiple of 4
        floats apart (the merge conv's 125 channels in rows of 128), as
        kernel #6 reads them."""
        return {
            name: update3d.padded_rows(
                getattr(self, name).compute_weights(xyz, knn_indices=knn_indices))
            for name in self.NAMES
        }

    def forward(self, xyz, flow, corr, knn_indices, dw):
        """The differentiable chain on the hoisted weights `dw`."""
        def conv(name, features):
            return getattr(self, name)(xyz, features, knn_indices=knn_indices, weights=dw[name])

        corr_feat = conv("conv_c1", corr)
        flow_feat = conv("conv_f2", conv("conv_f1", flow))
        out = conv("conv", torch.cat([corr_feat, flow_feat], dim=-1))
        return torch.cat([out, flow], dim=-1)


class GRU3D(nn.Module):
    """Point-conv gated recurrent unit."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        in_dim = hidden_dim + input_dim
        self.conv_z = PointConvDW(in_dim, hidden_dim, act=None, k=4)
        self.conv_r = PointConvDW(in_dim, hidden_dim, act=None, k=4)
        self.conv_q = PointConvDW(in_dim, hidden_dim, act=None, k=4)

    def precompute_weights(self, xyz, knn_indices):
        # z and r share (input, knn): their weights are pre-concatenated for
        # the one gather of the stacked z|r conv (ops/update3d.py)
        wz, wr, wq = (
            conv.compute_weights(xyz, knn_indices=knn_indices)
            for conv in (self.conv_z, self.conv_r, self.conv_q)
        )
        return {"conv_zr": torch.cat([wz, wr], dim=-1), "conv_q": wq}

    def forward(self, xyz, h, x, knn_indices, dw):
        """The differentiable GRU on the hoisted weights `dw` (z's and r's
        stacked in conv_zr)."""
        hx = torch.cat([h, x], dim=-1)
        z, r = paired_dw_conv(self.conv_z, self.conv_r, xyz, hx, knn_indices, dw["conv_zr"])
        z, r = torch.sigmoid(z), torch.sigmoid(r)
        q = torch.tanh(self.conv_q(xyz, torch.cat([r * h, x], dim=-1), knn_indices=knn_indices,
                                   weights=dw["conv_q"]))
        return (1.0 - z) * h + z * q


class FlowHead3D(nn.Module):
    """Hidden state -> delta flow."""

    NAMES = ("conv1", "conv2")

    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.conv1 = PointConvDW(hidden_dim, 128, k=32)
        self.conv2 = PointConvDW(128, 64, k=32)
        self.fc = nn.Linear(64, 3)

    def precompute_weights(self, xyz, knn_indices):
        return {
            name: getattr(self, name).compute_weights(xyz, knn_indices=knn_indices)
            for name in self.NAMES
        }

    def forward(self, xyz, features, knn_indices, dw):
        """The differentiable head on the hoisted weights `dw`."""
        for name in self.NAMES:
            features = getattr(self, name)(xyz, features, knn_indices=knn_indices,
                                           weights=dw[name])
        return self.fc(features)


class UpdateBlock3D(nn.Module):
    """One refinement iteration: backwarp, correlation (kernels #4 and #5),
    then kernels #6 (motion encoder) and #7 (GRU + flow head). `precompute`
    hoists the loop-invariant PointConvDW weights (their inputs, xyz1 and
    the k=32 neighbours, never change); `pack` the dense weights of #5, #6
    and #7."""

    def __init__(self, n_levels: int = 4):
        super().__init__()
        self.correlation = Correlation3D(n_levels=n_levels, out_channels=128, k=16)
        self.motion_encoder = MotionEncoder3D(corr_dim=128)
        self.gru = GRU3D(hidden_dim=128, input_dim=256)
        self.flow_head = FlowHead3D()

    def precompute(self, xyz1, knn_indices, fast: bool = False):
        """The hoisted weights, stored bf16 on the fast path (a module's at a
        time, so that its f32 copy is the largest temporary)."""
        store = update3d.to_bf16 if fast else (lambda dw: dw)
        return {name: store(getattr(self, name).precompute_weights(xyz1, knn_indices))
                for name in ("motion_encoder", "gru", "flow_head")}

    def pack(self):
        return {"tail": corr3d.prepare_corr3d_tail_params(self.correlation),
                "me": update3d.prepare_motion_encoder_3d_params(self.motion_encoder),
                "gf": update3d.prepare_gru_flowhead_3d_params(self.gru, self.flow_head)}

    def hoist(self, xyz1, knn_indices, fast: bool = False):
        """The loop's hoisted weights and packings, (dw, packed). On the fast
        path with CAMLIFLOW_UPDATE3D=1 (read here, at each request) and at
        most 4096 points, the int8 form's (`update3d.prepare_int8`)."""
        if not update3d.int8_form(fast, xyz1.shape[1]):
            return self.precompute(xyz1, knn_indices, fast), self.pack()
        # quantised from the bf16 weights, as the JAX package's models do
        dw, me, gf = update3d.prepare_int8(self.precompute(xyz1, knn_indices, fast=True),
                                           self.motion_encoder, self.gru, self.flow_head)
        return dw, {"tail": corr3d.prepare_corr3d_tail_params(self.correlation), "me": me,
                    "gf": gf}

    def forward(self, h, flow, consts):
        xyz1, xyzs2 = consts["xyz1"], consts["xyzs2"]
        knn_indices, dw = consts["knn_indices"], consts["dw"]
        # one backwarp serves every level: the levels are prefixes of the
        # finest and backwarp_3d is pointwise in its queries
        xyz2_warp_full = backwarp_3d(xyz1, xyzs2[0], flow)
        level_sizes = tuple(x.shape[1] for x in xyzs2)
        packed = consts["packed"]
        corr = self.correlation(xyz1, xyz2_warp_full, level_sizes, consts["pyramid"],
                                packed["tail"], consts.get("pyramid_scale"))
        motion = update3d.motion_encoder_3d(flow, corr, knn_indices, dw["motion_encoder"],
                                            packed["me"])
        h, delta = update3d.gru_flowhead_3d(h, consts["x"], motion, knn_indices,
                                            {**dw["gru"], **dw["flow_head"]}, packed["gf"])
        return h, flow + delta


class CamLiRAFTLCore(nn.Module):
    """Point-space RAFT core: eval (final-only) through `forward`, training
    through `forward_train`."""

    def __init__(self, n_iters: int = 20, n_samples_list=DEFAULT_N_SAMPLES):
        super().__init__()
        self.n_iters = n_iters
        self.n_samples_list = tuple(n_samples_list)
        self.fnet = Encoder3D()
        self.cnet = Encoder3D()
        self.cnet_aligner = nn.Linear(128, 256)
        update = UpdateBlock3D(n_levels=len(self.n_samples_list) - 1)
        # The update's submodules are registered on the core under the
        # reference state_dict names (core.correlation, core.gru, ...); the
        # block itself is kept outside the module tree so its parameters are
        # not registered a second time under core.update.
        self.correlation = update.correlation
        self.motion_encoder = update.motion_encoder
        self.gru = update.gru
        self.flow_head = update.flow_head
        self.__dict__["update"] = update

    def encode(self, pc1, pc2):
        """The FPS pyramids, both encoders (fnet per frame) and the context:
        (xyz1 [B, 2048, 3] at full width, the frame-2 levels, feat1, feat2,
        featc)."""
        xyzs1, xyzs2, _, _ = build_pc_pyramid(pc1, pc2, list(self.n_samples_list))
        # one KNN per level serves both frames (batched) and both encoders
        batch = pc1.shape[0]
        knn_both = encoder_knn_indices(
            [torch.cat([a, b], dim=0) for a, b in zip(xyzs1[:3], xyzs2[:3])]
        )
        knn_f1 = [idx[:batch] for idx in knn_both]
        knn_f2 = [idx[batch:] for idx in knn_both]

        feat1 = self.fnet(xyzs1[:3], knn_indices=knn_f1)[2]
        feat2 = self.fnet(xyzs2[:3], knn_indices=knn_f2)[2]
        featc = self.cnet_aligner(self.cnet(xyzs1[:3], knn_indices=knn_f1)[2])
        return xyzs1[2], xyzs2[2:], feat1, feat2, featc

    def forward(self, pc1, pc2, fast: bool = False):
        """pc1/pc2 [B, N, 3] -> final flow [B, N, 3]; `fast`: the fast path."""
        xyz1, xyzs2, feat1, feat2, featc = self.encode(pc1, pc2)
        pyramid = build_cost_volume_pyramid_3d(feat1, feat2, xyzs2)
        h, x = torch.chunk(featc, 2, dim=-1)
        h, x = torch.tanh(h), torch.relu(x)
        knn_indices = k_nearest_neighbor(xyz1, xyz1, 32)
        consts = {
            "xyz1": xyz1,
            "xyzs2": xyzs2,
            "knn_indices": knn_indices,
            "x": x,
            "pyramid": torch.cat(pyramid, dim=-1),  # once, outside the loop
        }
        consts["dw"], consts["packed"] = self.update.hoist(xyz1, knn_indices, fast)
        if fast:  # int8, a scale a query row
            consts["pyramid"], consts["pyramid_scale"] = quantize_rows_int8(consts["pyramid"])
        flow = torch.zeros_like(xyz1)
        for _ in range(self.n_iters):
            h, flow = self.update(h, flow, consts)
        return knn_interpolation(xyz1, flow, pc1, k=3)

    def forward_train(self, pc1, pc2, n_iters: int):
        """The training forward: flow_seq [T, B, N, 3], every iteration's
        flow upsampled. Under a bf16 `compute_precision` the cost pyramid
        stays f32 (`full_precision`), as the JAX einsum does, and the flow
        and the selections' inputs stay f32."""
        xyz1, xyzs2, feat1, feat2, featc = self.encode(pc1, pc2)
        with full_precision(pc1.device.type):
            pyramid = torch.cat(build_cost_volume_pyramid_3d(feat1.float(), feat2.float(),
                                                             xyzs2), dim=-1)
        h, x = torch.chunk(featc, 2, dim=-1)
        h, x = torch.tanh(h.float()), torch.relu(x.float())
        knn_indices = k_nearest_neighbor(xyz1, xyz1, 32)
        # the upsample's neighbours and weights (2048 -> full cloud), once
        up_idx, up_weights = interpolation_weights(xyz1, pc1, 3)
        level_sizes = tuple(x.shape[1] for x in xyzs2)
        # the loop-invariant PointConvDW weights, in the graph
        dw = self.update.precompute(xyz1, knn_indices)
        flow = torch.zeros_like(xyz1)
        seq = []
        for _ in range(n_iters):
            flow = flow.detach()
            xyz2_warp_full = backwarp_3d(xyz1, xyzs2[0], flow)
            idx = self.correlation.select_train(xyz1, xyz2_warp_full, level_sizes)
            corr = self.correlation.forward_train(xyz1, xyz2_warp_full, level_sizes, pyramid, idx)
            motion = self.motion_encoder(xyz1, flow, corr, knn_indices, dw["motion_encoder"])
            h = self.gru(xyz1, h, torch.cat([x, motion], dim=-1), knn_indices, dw["gru"])
            flow = flow + self.flow_head(xyz1, h, knn_indices, dw["flow_head"]).float()
            seq.append(weighted_sum(flow, up_idx, up_weights))
        return torch.stack(seq)


class CamLiRAFTL(nn.Module):
    """Model wrapper: IDS, domain alignment and the core. In train mode it
    runs `CamLiRAFTLCore.forward_train` for `n_iters_train` iterations
    under `compute_dtype` (bf16 autocast or f32); eval stays f32, or takes
    the fast path with `fast_inference: on`."""

    def __init__(self, cfgs: dict):
        super().__init__()
        self.fast_inference = str(cfgs.get("fast_inference", "auto"))
        resolve_fast_inference(self.fast_inference, False)  # raises on an unknown mode
        self.ids_enabled = bool(cfgs["ids"]["enabled"])
        self.n_iters_train = int(cfgs.get("n_iters_train", cfgs["n_iters_eval"]))
        self.compute_dtype = cfgs.get("compute_dtype")
        compute_precision(self.compute_dtype, "cpu")  # raises on a dtype it does not know
        self.core = CamLiRAFTLCore(
            n_iters=int(cfgs["n_iters_eval"]),
            n_samples_list=tuple(cfgs.get("n_samples_list", DEFAULT_N_SAMPLES)),
        )

    def forward(self, inputs: dict) -> dict:
        pcs = inputs["pcs"].float()
        pc1, pc2 = pcs[..., :3].contiguous(), pcs[..., 3:].contiguous()
        intrinsics = inputs["intrinsics"].float()
        persp_cam = {
            "projection_mode": "perspective",
            "sensor_h": 540,
            "sensor_w": 960,
            "f": intrinsics[:, 0],
            "cx": intrinsics[:, 1],
            "cy": intrinsics[:, 2],
        }
        if self.ids_enabled:
            paral_cam = make_parallel_camera_info(540, 960)
            pc1 = persp2paral(pc1, persp_cam, paral_cam)
            pc2 = persp2paral(pc2, persp_cam, paral_cam)

        # domain alignment for Things->KITTI transfer
        has_da = "src_mean" in inputs and "dst_mean" in inputs
        if has_da:
            src_mean = inputs["src_mean"][:, None, :]
            dst_mean = inputs["dst_mean"][:, None, :]
            src_std = inputs["src_std"][:, None, :]
            dst_std = inputs["dst_std"][:, None, :]
            pc1 = ((pc1 - src_mean) / src_std) * dst_std + dst_mean
            pc2 = ((pc2 - src_mean) / src_std) * dst_std + dst_mean

        if self.training:  # [T, B, N, 3]; the maps below broadcast over T
            with compute_precision(self.compute_dtype, pc1.device.type):
                flow = self.core.forward_train(pc1, pc2, self.n_iters_train)
        else:
            flow = self.core(pc1, pc2, resolve_fast_inference(self.fast_inference, True))

        if has_da:
            pcw = pc1 + flow
            flow = (((pcw - dst_mean) / dst_std) * src_std + src_mean) - (
                ((pc1 - dst_mean) / dst_std) * src_std + src_mean
            )
            pc1 = ((pc1 - dst_mean) / dst_std) * src_std + src_mean

        if self.ids_enabled:
            base = paral2persp(pc1, persp_cam, paral_cam)
            flow = paral2persp(pc1 + flow, persp_cam, paral_cam) - base

        if self.training:
            return {"flow_3d": flow[-1], "flow_3d_seq": flow}
        return {"flow_3d": flow, "flow_3d_seq": flow[None]}


def loss_fn(outputs: dict, inputs: dict, cfgs) -> tuple[torch.Tensor, dict]:
    """Sequence loss and metrics (the JAX `loss_fn`)."""
    target_3d = inputs["flow_3d"][..., :3]
    loss = calc_sequence_loss(outputs["flow_3d_seq"], target_3d, gamma=cfgs["loss"]["gamma"],
                              order=cfgs["loss"]["order"])
    return loss, merge_metrics({"loss3d": scalar_metric(loss)},
                               compute_3d_metrics(outputs["flow_3d"], target_3d))


def is_better(curr: dict, best: dict | None) -> bool:
    return best is None or curr["epe3d"] < best["epe3d"]
