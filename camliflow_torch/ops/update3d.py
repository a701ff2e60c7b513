"""The 3D update chain: CUDA kernels, plain versions, wrappers.

Replaces camliflow_tpu/ops/pallas_update3d.py::motion_encoder_3d_pallas and
::gru_flowhead_3d_pallas with `csrc/update3d.cu` (see the source's note for
the design and the bound). Both compute the exact path in f32: the hoisted
PointConvDW weights stay f32 in their [B, N, k, C] layout (the TPU fast
path's bf16/int8 storage and k-major relayout are not ported).

Each PointConvDW's MLP (one Linear) is packed once per request by
`prepare_motion_encoder_3d_params` / `prepare_gru_flowhead_3d_params` into a
`PackedConv` (1x1, weight [K_pad, N_pad]); z and r stack into one
[384, 256] matmul, as the JAX packing does. The layers that run on the
tensor-core tile also carry its tf32 planes: #7's first two dense steps,
and #6's c1 (128 -> 128) and merge (144 -> 125). The plain versions run the
exact chain of models/camliraft_l.py on the same packed weights.

    motion_encoder_3d(flow, corr, knn_idx, dw, me)      -> [B, N, 125 + 3]
    gru_flowhead_3d(h, x3d, motion, knn_idx, dw, gf)    -> (h' [B, N, 128],
                                                           delta [B, N, 3])

`dw_max` replaces camliflow_tpu/ops/pallas_ohg.py::dw_conv_ohg: one
PointConvDW tail (gather, multiply, max over k) as `camli_dw_max`, one
launch of the tail that #6 and #7 also run on, without the TPU's one-hot
selection. `gru_3d` and `flow_head_3d` run GRU3D and
FlowHead3D as torch ops around it, where CLFM sits between them
(`fuse_hidden`) and #7 cannot take both.

`dw` holds the hoisted weights by conv name: conv_c1, conv_f1, conv_f2 and
conv for the motion encoder; conv_zr, conv_q (GRU3D) and conv1, conv2
(FlowHead3D) for the second.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import _cuda
from .geometry import gather_points
from .update2d import (
    K_ALIGN,
    N_ALIGN,
    PackedConv,
    _check_params,
    _check_tc,
    _planes,
    _round_up,
    split_tf32,
)

ME_CONVS = ("conv_c1", "conv_f1", "conv_f2", "conv")
GF_DW = ("conv_zr", "conv_q", "conv1", "conv2")
GF_DENSE = ("zrq", "q_h")  # #7's dense steps on the tensor-core tile
GF_PARAMS = ("zr", "q") + GF_DENSE + ("conv1", "conv2", "fc")
CHECKED = "_checked"  # the params' entry that remembers their last check
ME_DENSE = ("conv_c1", "conv")  # #6's dense steps on the tensor-core tile
# csrc/update3d.cu: #7's widest tails (z|r, q, conv1, conv2), their most
# neighbours (kGruK, kHeadK) and fc outputs (kMaxFc)
GF_WIDTHS = (256, 128, 128, 64)
GF_KS = (8, 8, 32, 32)
GF_MAX_FC = 4
# csrc/update3d.cu: a fused dense layer's most input channels (kMaxRow) and
# outputs (kGfThreads); the 16-byte loads' alignment (kTailAlign)
MAX_ROW = 128
MAX_FUSED_OUT = 128
TAIL_ALIGN = 16


def pack_matrix(weight: torch.Tensor, bias: torch.Tensor, planes: bool = False) -> PackedConv:
    """A dense layer (weight [cout, cin], bias [cout]) as a packed 1x1 conv,
    weight [K_pad, N_pad] zero-padded; with `planes`, also the tensor-core
    tile's tf32 planes ([N_pad, K_pad], K-major)."""
    weight, bias = weight.detach().float(), bias.detach().float()
    cout, cin = weight.shape
    packed = weight.new_zeros(_round_up(cin, K_ALIGN), _round_up(cout, N_ALIGN))
    packed[:cin, :cout] = weight.t()
    padded_bias = bias.new_zeros(packed.shape[1])
    padded_bias[:cout] = bias
    hi = lo = None
    if planes:
        hi, lo = split_tf32(packed.t().contiguous())
    return PackedConv(packed, padded_bias, 1, 1, cin, cout, hi, lo)


def pack_linears(*linears: nn.Linear, planes: bool = False) -> PackedConv:
    """One packed 1x1 conv from Linears sharing their input: their output
    channels are stacked in order (z and r)."""
    return pack_matrix(torch.cat([lin.weight for lin in linears], dim=0),
                       torch.cat([lin.bias for lin in linears], dim=0), planes)


def _mlp(conv: nn.Module) -> nn.Linear:
    """The Linear of a PointConvDW's one-layer MLP."""
    return conv.mlp.convs[0].conv_fn


def linear_plain(x: torch.Tensor, conv: PackedConv) -> torch.Tensor:
    return F.linear(x, conv.weight[: conv.cin, : conv.cout].t(), conv.bias[: conv.cout])


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def dw_max_plain(table: torch.Tensor, knn_idx: torch.Tensor, weights: torch.Tensor):
    """max_j table[idx[:, :, j]] * weights[:, :, j] over the weights' k."""
    k = weights.shape[2]
    return torch.amax(gather_points(table, knn_idx[:, :, :k]) * weights, dim=2)


def _check_dw(name: str, dw: dict, keys, batch: int, n: int, device,
              padded=()) -> list[int]:
    """The hoisted weights [B, N, k, C], contiguous, or for the `padded`
    keys with rows round_up(C, 4) floats apart (`padded_rows`); returns
    their k."""
    ks = []
    for key in keys:
        w = dw[key]
        if key in padded:
            if w.dtype != torch.float32:
                raise TypeError(f"{name}: dw[{key!r}] must be {torch.float32}, got {w.dtype}")
        else:
            _cuda.check(name, torch.float32, **{key: w})
        if w.device != device:
            raise ValueError(f"{name}: dw[{key!r}] lies on {w.device}, not {device}")
        _cuda.check_shape(name, f"dw[{key!r}]", w, (batch, n, None, None))
        ld = _round_up(w.shape[3], 4)
        if key in padded and w.stride() != (n * w.shape[2] * ld, w.shape[2] * ld, ld, 1):
            raise ValueError(f"{name}: dw[{key!r}] must hold its rows {ld} floats apart "
                             "(padded_rows; MotionEncoder3D.precompute_weights hoists them so)")
        ks.append(w.shape[2])
    return ks


def _check_idx(name: str, knn_idx: torch.Tensor, batch: int, n: int, k: int, device):
    _cuda.check(name, torch.int32, knn_idx=knn_idx)
    if knn_idx.device != device:
        raise ValueError(f"{name}: knn_idx lies on {knn_idx.device}, not {device}")
    _cuda.check_shape(name, "knn_idx", knn_idx, (batch, n, None))
    if knn_idx.shape[2] < k:
        raise ValueError(f"{name}: knn_idx has {knn_idx.shape[2]} neighbours, the "
                         f"weights want {k}")


# --- MotionEncoder3D (kernel #6) ------------------------------------------


def prepare_motion_encoder_3d_params(encoder: nn.Module) -> dict:
    """Packed MLPs of a `models.camliraft_l.MotionEncoder3D`; c1's and the
    merge conv's (#6's dense steps) also carry tf32 planes."""
    _cuda.forward_only_modules("prepare_motion_encoder_3d_params", encoder)
    return {name: pack_linears(_mlp(getattr(encoder, name)), planes=name in ME_DENSE)
            for name in ME_CONVS}


def padded_rows(weights: torch.Tensor) -> torch.Tensor:
    """Hoisted weights [B, N, k, C] as #6 reads them: the same values, with
    rows round_up(C, 4) floats apart (16-byte rows: the merge conv's 125
    channels in rows of 128), as a view of a zero-padded buffer; unchanged
    where C is a multiple of 4."""
    channels = weights.shape[-1]
    if channels % 4 == 0:
        return weights
    return F.pad(weights, (0, _round_up(channels, 4) - channels))[..., :channels]


def motion_encoder_3d_plain(flow, corr, knn_idx, dw: dict, params: dict):
    corr_feat = dw_max_plain(_leaky(linear_plain(corr, params["conv_c1"])), knn_idx,
                             dw["conv_c1"])
    flow_feat = dw_max_plain(_leaky(linear_plain(flow, params["conv_f1"])), knn_idx,
                             dw["conv_f1"])
    flow_feat = dw_max_plain(_leaky(linear_plain(flow_feat, params["conv_f2"])), knn_idx,
                             dw["conv_f2"])
    out = dw_max_plain(_leaky(linear_plain(torch.cat([corr_feat, flow_feat], dim=-1),
                                           params["conv"])), knn_idx, dw["conv"])
    return torch.cat([out, flow], dim=-1)


def _remembered(params: dict, state: tuple, read: tuple, check):
    """check()'s result, computed once and remembered in `params` beside
    `state` and the objects `read`, as `ops/clfm.py` does; a call with the
    same state and the same objects returns it unchecked (the refinement
    loop makes 20 calls a request, and requests are paced by the host)."""
    checked = params.get(CHECKED)
    if (checked is not None and checked[0] == state
            and all(a is b for a, b in zip(checked[1], read))):
        return checked[2]
    args = check()
    params[CHECKED] = (state, read, args)
    return args


def _me_checked(name: str, params: dict, dw: dict, shape: tuple, device) -> tuple:
    """What #6 assumes of its packed MLPs and hoisted weights, for inputs of
    `shape` (B, N, C_flow, C_corr), checked once (`_remembered`). Returns
    the kernel's arguments that follow from them."""
    read = tuple(params[k] for k in ME_CONVS) + tuple(dw[k] for k in ME_CONVS)
    return _remembered(params, (device, shape), read,
                       lambda: _me_check(name, params, dw, shape, device))


def _me_check(name: str, params: dict, dw: dict, shape: tuple, device) -> tuple:
    batch, n, c_flow, c_corr = shape
    ks = _check_dw(name, dw, ME_CONVS, batch, n, device, padded=("conv",))
    packed = {k: params[k] for k in ME_CONVS}
    _check_params(name, packed, device)
    c1, f1, f2, merge = (params[k] for k in ME_CONVS)
    if ((c1.cin, f1.cin, f2.cin, merge.cin) != (c_corr, c_flow, f1.cout, c1.cout + f2.cout)
            or [dw[k].shape[3] for k in ME_CONVS] != [p.cout for p in (c1, f1, f2, merge)]):
        raise ValueError(f"{name}: the packed MLPs and weights do not fit the inputs")
    widths = (c1.cout, f1.cout, f2.cout)
    if (any(w % 4 for w in widths) or f1.cout > MAX_ROW or f2.cout > MAX_FUSED_OUT
            or min(ks) < 1):
        raise ValueError(f"{name}: the kernel takes c1, f1 and f2 widths that are multiples "
                         f"of 4, f1 up to {MAX_ROW} and f2 up to {MAX_FUSED_OUT} channels, "
                         f"and at least one neighbour, got {widths}, {tuple(ks)}")
    misaligned = [k for k in ("conv_c1", "conv") if dw[k].data_ptr() % TAIL_ALIGN]
    if misaligned:  # the c1 and merge tails read the weights in 16-byte loads
        raise ValueError(f"{name}: dw{misaligned} must be {TAIL_ALIGN}-byte aligned")
    _check_tc(name, packed, ME_DENSE)
    # the scratch a point: c1's table, f1's, corr_feat, f2's table, flow_feat
    # and the merge table, its rows padded to 4 channels
    per_point = 2 * c1.cout + f1.cout + 2 * f2.cout + _round_up(merge.cout, 4)
    return (tuple(dw[k].data_ptr() for k in ME_CONVS), _planes(packed, ME_DENSE),
            tuple(t.data_ptr() for c in (f1, f2) for t in (c.weight, c.bias)),
            (c1.cout, f1.cout, f2.cout, merge.cout), tuple(ks),
            (f1.weight.shape[1], f2.weight.shape[1]), per_point)


def motion_encoder_3d(flow: torch.Tensor, corr: torch.Tensor, knn_idx: torch.Tensor,
                      dw: dict, params: dict):
    """flow [B, N, 3], corr [B, N, C], knn_idx [B, N, >=32] int32, `dw` the
    hoisted weights as MotionEncoder3D.precompute_weights gives them (the
    merge conv's rows 128 floats apart, `padded_rows`) -> [B, N, 125 + 3]
    (the merge conv's output, then the flow). CPU tensors take the plain
    version; CUDA tensors the kernel."""
    _cuda.forward_only("motion_encoder_3d", flow, corr, *dw.values())
    if _cuda.on_cpu(flow, corr, knn_idx):
        return motion_encoder_3d_plain(flow, corr, knn_idx, dw, params)
    name = "motion_encoder_3d"
    _cuda.check(name, torch.float32, flow=flow, corr=corr)
    if flow.dim() != 3 or corr.dim() != 3 or corr.shape[:2] != flow.shape[:2]:
        _cuda.check_shape(name, "flow", flow, (None, None, None))
        _cuda.check_shape(name, "corr", corr, (flow.shape[0], flow.shape[1], None))
    batch, n, c_flow = flow.shape
    c_corr = corr.shape[-1]
    if c_corr % 4 or corr.data_ptr() % 16:  # corr feeds the tensor-core tile
        _check_tc(name, {}, (), corr=corr)
    dws, planes, weights, (c1, f1, f2, c_m), ks, npads, per_point = _me_checked(
        name, params, dw, (batch, n, c_flow, c_corr), flow.device)
    if (knn_idx.dtype != torch.int32 or knn_idx.device != flow.device or knn_idx.dim() != 3
            or knn_idx.shape[:2] != (batch, n) or knn_idx.shape[2] < max(ks)
            or not knn_idx.is_contiguous()):
        _check_idx(name, knn_idx, batch, n, max(ks), flow.device)
    scratch = flow.new_empty(batch * n * per_point)
    out = flow.new_empty(batch, n, c_m + c_flow)
    from ..csrc.build import launch

    launch("camli_motion_encoder_3d", flow.data_ptr(), corr.data_ptr(), knn_idx.data_ptr(),
           *dws, planes, *weights, scratch.data_ptr(), out.data_ptr(), batch, n,
           knn_idx.shape[2], c_flow, c_corr, c1, f1, f2, c_m, *ks, *npads, per_point)
    motion_encoder_3d.launches += 1
    return out


motion_encoder_3d.launches = 0


# --- GRU3D + FlowHead3D (kernel #7) ---------------------------------------


def prepare_gru_3d_params(gru: nn.Module) -> dict:
    """Packed MLPs of a `models.camliraft_l.GRU3D`: z|r stacked, and q (the
    plain versions' and #13's path). For #7, q split by its input
    [r*h, x3d, motion]: "zrq" stacks z|r and q's x3d/motion part (its r*h
    rows zero, its bias) over [h, x3d, motion], "q_h" is q's r*h part
    (bias zero); their sum is q's product. Both carry tf32 planes."""
    _cuda.forward_only_modules("prepare_gru_3d_params", gru)
    z, r, q = _mlp(gru.conv_z), _mlp(gru.conv_r), _mlp(gru.conv_q)
    hidden = z.weight.shape[0]
    q_xm = q.weight.detach().clone()
    q_xm[:, :hidden] = 0.0
    zrq = pack_matrix(torch.cat([z.weight, r.weight, q_xm], dim=0),
                      torch.cat([z.bias, r.bias, q.bias], dim=0), planes=True)
    q_h = pack_matrix(q.weight[:, :hidden], torch.zeros_like(q.bias), planes=True)
    return {"zr": pack_linears(z, r), "q": pack_linears(q), "zrq": zrq, "q_h": q_h}


def prepare_flow_head_3d_params(head: nn.Module) -> dict:
    _cuda.forward_only_modules("prepare_flow_head_3d_params", head)
    return {"conv1": pack_linears(_mlp(head.conv1)), "conv2": pack_linears(_mlp(head.conv2)),
            "fc": pack_linears(head.fc)}


def prepare_gru_flowhead_3d_params(gru: nn.Module, head: nn.Module) -> dict:
    return {**prepare_gru_3d_params(gru), **prepare_flow_head_3d_params(head)}


def _gru_3d(h, x, knn_idx, dw: dict, params: dict, tail):
    """Point-conv GRU: z and r from one k=4 conv, then q; no nan_to_num.
    `tail` is the PointConvDW tail (gather, multiply, max over k)."""
    hidden = h.shape[-1]
    zr = tail(linear_plain(torch.cat([h, x], dim=-1), params["zr"]), knn_idx, dw["conv_zr"])
    z, r = torch.sigmoid(zr[..., :hidden]), torch.sigmoid(zr[..., hidden:])
    q = torch.tanh(tail(linear_plain(torch.cat([r * h, x], dim=-1), params["q"]), knn_idx,
                        dw["conv_q"]))
    return (1.0 - z) * h + z * q


def _flow_head_3d(h, knn_idx, dw: dict, params: dict, tail):
    feat = tail(_leaky(linear_plain(h, params["conv1"])), knn_idx, dw["conv1"])
    feat = tail(_leaky(linear_plain(feat, params["conv2"])), knn_idx, dw["conv2"])
    return linear_plain(feat, params["fc"])


def gru_3d_plain(h, x, knn_idx, dw: dict, params: dict):
    return _gru_3d(h, x, knn_idx, dw, params, dw_max_plain)


def flow_head_3d_plain(h, knn_idx, dw: dict, params: dict):
    return _flow_head_3d(h, knn_idx, dw, params, dw_max_plain)


def gru_flowhead_3d_plain(h, x3d, motion, knn_idx, dw: dict, params: dict):
    h = gru_3d_plain(h, torch.cat([x3d, motion], dim=-1), knn_idx, dw, params)
    return h, flow_head_3d_plain(h, knn_idx, dw, params)


def _gf_checked(name: str, params: dict, dw: dict, shape: tuple, device) -> tuple:
    """What #7 assumes of its packed MLPs and hoisted weights, for inputs of
    `shape` (B, N, Ch, Cx, Cm), checked once (`_remembered`). Returns the
    kernel's arguments that follow from them."""
    read = tuple(params[k] for k in GF_PARAMS) + tuple(dw[k] for k in GF_DW)
    return _remembered(params, (device, shape), read,
                       lambda: _gf_check(name, params, dw, shape, device))


def _gf_check(name: str, params: dict, dw: dict, shape: tuple, device) -> tuple:
    batch, n, ch, cx, cm = shape
    ks = _check_dw(name, dw, GF_DW, batch, n, device)
    packed = {k: params[k] for k in GF_PARAMS}
    _check_params(name, packed, device)
    zr, q, zrq, q_h, conv1, conv2, fc = (params[k] for k in GF_PARAMS)
    if ((zr.cin, zr.cout, q.cin, q.cout) != (ch + cx + cm, 2 * ch, ch + cx + cm, ch)
            or (zrq.cin, zrq.cout, q_h.cin, q_h.cout) != (ch + cx + cm, 3 * ch, ch, ch)
            or (conv1.cin, conv2.cin, fc.cin) != (ch, conv1.cout, conv2.cout)
            or [dw[k].shape[3] for k in GF_DW] != [2 * ch, ch, conv1.cout, conv2.cout]):
        raise ValueError(f"{name}: the packed MLPs and weights do not fit the inputs")
    widths = (2 * ch, ch, conv1.cout, conv2.cout)
    if (any(w > most for w, most in zip(widths, GF_WIDTHS)) or fc.cout > GF_MAX_FC
            or conv1.cout % 4 or conv2.cout % 4
            or any(k > most or k < 1 for k, most in zip(ks, GF_KS))):
        raise ValueError(f"{name}: the kernel takes tails of up to {GF_WIDTHS} channels, "
                         f"multiples of 4, {GF_KS} neighbours and up to {GF_MAX_FC} fc "
                         f"outputs, got {widths}, {tuple(ks)}, {fc.cout}")
    misaligned = [k for k in GF_DW if dw[k].data_ptr() % 16]
    if misaligned:  # the tails read the weights in 16-byte loads
        raise ValueError(f"{name}: dw{misaligned} must be 16-byte aligned")
    _check_tc(name, packed, GF_DENSE)
    per_point = 6 * ch + conv1.cout + conv2.cout  # the kernel's scratch
    args = (tuple(dw[k].data_ptr() for k in GF_DW), _planes(packed, GF_DENSE),
            tuple(t.data_ptr() for c in (conv1, conv2, fc) for t in (c.weight, c.bias)),
            (conv1.cout, conv2.cout, fc.cout), tuple(ks),
            tuple(w.weight.shape[1] for w in (conv1, conv2, fc)), per_point)
    return args


def gru_flowhead_3d(h: torch.Tensor, x3d: torch.Tensor, motion: torch.Tensor,
                    knn_idx: torch.Tensor, dw: dict, params: dict):
    """h [B, N, Ch], x3d [B, N, Cx], motion [B, N, Cm], knn_idx [B, N, >=32]
    int32 -> (h' [B, N, Ch], delta [B, N, 3]). CPU tensors take the plain
    version; CUDA tensors the kernel."""
    _cuda.forward_only("gru_flowhead_3d", h, x3d, motion, *dw.values())
    if _cuda.on_cpu(h, x3d, motion, knn_idx):
        return gru_flowhead_3d_plain(h, x3d, motion, knn_idx, dw, params)
    name = "gru_flowhead_3d"
    _cuda.check(name, torch.float32, h=h, x3d=x3d, motion=motion)
    batch, n, ch = h.shape
    cx, cm = x3d.shape[-1], motion.shape[-1]
    if x3d.dim() != 3 or motion.dim() != 3 or x3d.shape[:2] != (batch, n) \
            or motion.shape[:2] != (batch, n):
        _cuda.check_shape(name, "x3d", x3d, (batch, n, None))
        _cuda.check_shape(name, "motion", motion, (batch, n, None))
    if (ch | cx | cm) % 4 or (h.data_ptr() | x3d.data_ptr() | motion.data_ptr()) % 16:
        _check_tc(name, {}, (), h=h, x3d=x3d, motion=motion)
    dws, planes, weights, (c1, c2, c_out), ks, npads, per_point = _gf_checked(
        name, params, dw, (batch, n, ch, cx, cm), h.device)
    if (knn_idx.dtype != torch.int32 or knn_idx.device != h.device or knn_idx.dim() != 3
            or knn_idx.shape[:2] != (batch, n) or knn_idx.shape[2] < max(ks)
            or not knn_idx.is_contiguous()):
        _check_idx(name, knn_idx, batch, n, max(ks), h.device)
    scratch = h.new_empty(batch * n * per_point)
    h_out, delta = h.new_empty(batch, n, ch), h.new_empty(batch, n, c_out)
    from ..csrc.build import launch

    launch("camli_gru_flowhead_3d", h.data_ptr(), x3d.data_ptr(), motion.data_ptr(),
           knn_idx.data_ptr(), *dws, planes, *weights, scratch.data_ptr(), h_out.data_ptr(),
           delta.data_ptr(), batch, n, knn_idx.shape[2], ch, cx, cm, c1, c2, c_out, *ks,
           *npads)
    gru_flowhead_3d.launches += 1
    return h_out, delta


gru_flowhead_3d.launches = 0


# --- the PointConvDW tail alone (kernel #13) -------------------------------


def _dw_max_check(name: str, table, knn_idx, weights) -> None:
    """Every argument check of `dw_max`, each raising with its reason."""
    _cuda.check(name, torch.float32, table=table, weights=weights)
    _cuda.check_shape(name, "table", table, (None, None, None))
    batch, _, channels = table.shape
    _cuda.check_shape(name, "weights", weights, (batch, None, None, channels))
    m, k = weights.shape[1:3]
    _check_idx(name, knn_idx, batch, m, k, table.device)
    if k < 1:
        raise ValueError(f"{name}: the weights have no neighbours")


def dw_max(table: torch.Tensor, knn_idx: torch.Tensor, weights: torch.Tensor):
    """table [B, N, C], knn_idx [B, M, >=k] int32, weights [B, M, k, C] ->
    [B, M, C]: max_j table[idx[:, :, j]] * weights[:, :, j], bit-identical
    to `dw_max_plain`, for any k >= 1 and C. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    _cuda.forward_only("dw_max", table, weights)
    if _cuda.on_cpu(table, knn_idx, weights):
        return dw_max_plain(table, knn_idx, weights)
    name = "dw_max"
    # cheap conditions first (80 calls a fuse_hidden request), every check
    # with its reason only when one fails
    device = table.device
    if (table.dtype != torch.float32 or weights.dtype != torch.float32
            or knn_idx.dtype != torch.int32 or table.dim() != 3 or weights.dim() != 4
            or knn_idx.dim() != 3 or device.type != "cuda" or weights.device != device
            or knn_idx.device != device or device.index != torch.cuda.current_device()
            or weights.shape[0] != table.shape[0] or weights.shape[3] != table.shape[2]
            or knn_idx.shape[:2] != weights.shape[:2] or knn_idx.shape[2] < weights.shape[2]
            or weights.shape[2] < 1 or not table.is_contiguous()
            or not weights.is_contiguous() or not knn_idx.is_contiguous()):
        _dw_max_check(name, table, knn_idx, weights)
    batch, n_table, channels = table.shape
    m, k = weights.shape[1:3]
    out = table.new_empty(batch, m, channels)
    from ..csrc.build import launch

    launch("camli_dw_max", table.data_ptr(), weights.data_ptr(), knn_idx.data_ptr(),
           out.data_ptr(), batch, n_table, m, knn_idx.shape[2], k, channels)
    dw_max.launches += 1
    return out


dw_max.launches = 0


def gru_3d(h: torch.Tensor, x: torch.Tensor, knn_idx: torch.Tensor, dw: dict, params: dict):
    """GRU3D with each PointConvDW tail through `dw_max`; the MLP Linears
    (F.linear), the gates and the blend run as torch ops around it. The
    flagship's fuse_hidden path runs it, where CLFM sits between GRU3D and
    FlowHead3D."""
    _cuda.forward_only("gru_3d", h, x, *dw.values())
    return _gru_3d(h, x, knn_idx, dw, params, dw_max)


def flow_head_3d(h: torch.Tensor, knn_idx: torch.Tensor, dw: dict, params: dict):
    """FlowHead3D with its two PointConvDW tails through `dw_max`."""
    _cuda.forward_only("flow_head_3d", h, *dw.values())
    return _flow_head_3d(h, knn_idx, dw, params, dw_max)
