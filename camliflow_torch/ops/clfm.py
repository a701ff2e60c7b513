"""One in-loop CLFM call: CUDA kernel, plain version, wrapper.

Replaces camliflow_tpu/ops/pallas_clfm.py::clfm_fused_pallas with
`csrc/clfm.cu` (see the source's note for the design and the bound). In the
refinement loop, CLFM fuses the two branches' features at corr and motion
(and at the hidden state with `fuse_hidden`). Everything that does not change
across iterations is hoisted, once per request, as the JAX package does:

- `hoist_interp_score`: the interp score MLP, whose input is only the
  pixel -> nearest-point offsets, as a [B, HW, C3] f32 gate (the exact path
  has no bf16);
- `grid_sample_cache`: the 4 bilinear taps of the 2D -> 3D sample at uv;
- `prepare_clfm_params`: the dense layers, packed, with the tf32 weight
  planes of the tensor-core tile; the SK heads' layers, also transposed.

    clfm_fused(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params)
        -> (out_2d [B, H, W, C2], out_3d [B, N, C3])

The plain version is the exact f32 chain of `nn/clfm.py::CLFM.forward` on
the hoisted operands. The fusions at fnet and cnet keep the module: they
have batch norm and run once per request, and the JAX package never fuses
them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _cuda
from .geometry import gather_points
from .gridsample import bilinear_taps
from .update2d import PackedConv, _check_params, _check_tc, _planes, split_tf32
from .update3d import linear_plain, pack_linears

DENSE = ("out_conv", "align1_2d", "align2_2d", "mlps3d", "align1_3d", "align2_3d")
MAX_WIDTH = 1024  # csrc/clfm.cu kMaxC
CHUNK = 256  # csrc/clfm.cu kChunk: rows per partial column sum
CHECKED = "_checked"  # the params' entry that remembers their last check


class SKHead(NamedTuple):
    """An SK fusion's two bias-free layers, [in, out] f32, and the same
    transposed, [out, in], as the kernel reads them (a warp per row)."""

    mid: torch.Tensor  # [C, C // 2]
    out: torch.Tensor  # [C // 2, 2C]: columns 2c and 2c + 1 are channel c's pair
    mid_t: torch.Tensor  # [C // 2, C]
    out_t: torch.Tensor  # [2C, C // 2]


def hoist_interp_score(interp: nn.Module, knn_offset: torch.Tensor) -> torch.Tensor:
    """FusionAwareInterp's score gate ([B, HW, 1, 2] offsets -> [B, HW, C3]),
    computed as the module computes it, once per request."""
    norm = torch.linalg.vector_norm(knn_offset, dim=-1, keepdim=True)
    score = interp.score_net(torch.cat([knn_offset, norm], dim=-1).float())
    return score[:, :, 0, :].contiguous()


def grid_sample_cache(uv: torch.Tensor, height: int, width: int):
    """The 4 corner taps of `grid_sample_points(feat_2d, uv)` at loop-invariant
    uv: (flat indices [B, N, 4] int32, weights [B, N, 4] f32, out-of-map
    corners weighted 0)."""
    uv = uv.float()
    idx, weights = bilinear_taps(uv[..., 0], uv[..., 1], height, width)
    return idx.int().contiguous(), weights.contiguous()


def _sk(fusion: nn.Module) -> SKHead:
    mid, out = (layer[0].weight.detach().float() for layer in (fusion.fc_mid, fusion.fc_out))
    return SKHead(mid.t().contiguous(), out.t().contiguous(), mid.contiguous(),
                  out.contiguous())


def _pack_dense(linear: nn.Linear) -> PackedConv:
    """A Linear packed as a 1x1 conv with the tensor-core tile's tf32
    planes ([N_pad, K_pad], K-major)."""
    packed = pack_linears(linear)
    hi, lo = split_tf32(packed.weight.t().contiguous())
    return packed._replace(hi=hi, lo=lo)


def prepare_clfm_params(clfm: nn.Module) -> dict:
    """The dense layers of a `nn.clfm.CLFM` without norm (the in-loop ones),
    packed once per request: the six 1x1 layers as `PackedConv`s with their
    tf32 planes, and each SK head's fc_mid and fc_out."""
    _cuda.forward_only_modules("prepare_clfm_params", clfm)
    layers = {"out_conv": clfm.interp.out_conv, "align1_2d": clfm.fuse2d.align1,
              "align2_2d": clfm.fuse2d.align2, "mlps3d": clfm.mlps3d,
              "align1_3d": clfm.fuse3d.align1, "align2_3d": clfm.fuse3d.align2}
    for name, layer in layers.items():
        if not isinstance(layer.norm_fn, nn.Identity) or layer.act != "leaky_relu":
            raise ValueError(f"prepare_clfm_params: {name} must be a Linear + leaky ReLU")
    params = {name: _pack_dense(layer.conv_fn) for name, layer in layers.items()}
    params["sk_2d"], params["sk_3d"] = _sk(clfm.fuse2d), _sk(clfm.fuse3d)
    return params


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def _sk_fuse(a: torch.Tensor, b: torch.Tensor, head: SKHead) -> torch.Tensor:
    """SKFusion after its align layers: a, b [B, ..., C]."""
    batch, channels = a.shape[0], a.shape[-1]
    spatial = tuple(range(1, a.dim() - 1))
    weight = torch.sigmoid(F.relu(torch.mean(a + b, dim=spatial) @ head.mid) @ head.out)
    weight = torch.softmax(weight.reshape(batch, channels, 2), dim=-1)
    shape = (batch,) + (1,) * len(spatial) + (channels,)
    return a * weight[..., 0].reshape(shape) + b * weight[..., 1].reshape(shape)


def clfm_fused_plain(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params: dict):
    batch, height, width, c2 = feat_2d.shape
    # 3D -> 2D: the nearest point's features, gated, then out_conv
    gathered = gather_points(feat_3d, nn_idx)[:, :, 0]  # [B, HW, C3]
    interp = _leaky(linear_plain(score * gathered, params["out_conv"]))
    interp = interp.reshape(batch, height, width, -1)
    out_2d = _sk_fuse(_leaky(linear_plain(feat_2d, params["align1_2d"])),
                      _leaky(linear_plain(interp, params["align2_2d"])), params["sk_2d"])
    # 2D -> 3D: the bilinear sample (grid_sample_pixel's sum), then mlps3d
    flat = feat_2d.reshape(batch, height * width, c2)
    sampled = None
    for t in range(4):
        vals = gather_points(flat, tap_idx[..., t]) * tap_w[..., t : t + 1]
        sampled = vals if sampled is None else sampled + vals
    sampled = _leaky(linear_plain(sampled, params["mlps3d"]))
    out_3d = _sk_fuse(_leaky(linear_plain(sampled, params["align1_3d"])),
                      _leaky(linear_plain(feat_3d, params["align2_3d"])), params["sk_3d"])
    return out_2d, out_3d


def scratch_floats(batch: int, hw: int, n: int, c2: int, c3: int) -> int:
    """The kernel's scratch (csrc/clfm.cu::camli_clfm lists it)."""
    rows2, rows3 = batch * hw, batch * n
    chunks = batch * (-(-hw // CHUNK) * c2 + -(-n // CHUNK) * c3)
    return 2 * (rows2 + rows3) * (c2 + c3) + chunks + 2 * batch * (c2 + c3)


def _weights(name: str, params: dict, feat_2d: torch.Tensor, feat_3d: torch.Tensor):
    """The kernel's weight pointers: a C array of the dense layers' (hi, lo,
    bias), and the SK heads' (mid_t, out_t) of each side. What the kernel
    assumes of the params is checked once and remembered in `params` beside
    the objects it read; the next call with the same objects, device and
    widths skips the check (the refinement loop calls it 20 times per
    request, and the flagship's requests are paced by the host)."""
    device, c2, c3 = feat_2d.device, feat_2d.shape[-1], feat_3d.shape[-1]
    read = tuple(params[key] for key in (*DENSE, "sk_2d", "sk_3d"))
    checked = params.get(CHECKED)
    if (checked is not None and checked[0] == (device, c2, c3)
            and all(a is b for a, b in zip(checked[1], read))):
        return checked[2]
    dense = {key: params[key] for key in DENSE}
    _check_params(name, dense, device)
    fits = {"out_conv": (c3, c3), "align1_2d": (c2, c2), "align2_2d": (c3, c2),
            "mlps3d": (c2, c2), "align1_3d": (c2, c3), "align2_3d": (c3, c3)}
    if any((dense[k].cin, dense[k].cout) != v for k, v in fits.items()):
        raise ValueError(f"{name}: the packed layers do not fit C2={c2}, C3={c3}")
    _check_tc(name, dense, DENSE)
    heads = (params["sk_2d"], params["sk_3d"])
    for head, c in zip(heads, (c2, c3)):
        _cuda.check(name, torch.float32, mid_t=head.mid_t, out_t=head.out_t, feat_2d=feat_2d)
        if head.mid_t.shape[1] != c or head.out_t.shape != (2 * c, head.mid_t.shape[0]):
            raise ValueError(f"{name}: an SK head does not fit its {c} channels")
        if head.mid_t.shape[0] % 2 or head.mid_t.data_ptr() % 16 or head.out_t.data_ptr() % 8:
            raise ValueError(f"{name}: the kernel reads an SK head's rows 4 and 2 floats at a "
                             "time; prepare the heads with prepare_clfm_params")
    if max(c2, c3, heads[0].mid_t.shape[0], heads[1].mid_t.shape[0]) > MAX_WIDTH:
        raise ValueError(f"{name}: the kernel takes widths up to {MAX_WIDTH}")
    pointers = (_planes(dense, DENSE),
                tuple(t.data_ptr() for head in heads for t in (head.mid_t, head.out_t)))
    params[CHECKED] = ((device, c2, c3), read, pointers)
    return pointers


def clfm_fused(feat_2d: torch.Tensor, feat_3d: torch.Tensor, score: torch.Tensor,
               nn_idx: torch.Tensor, tap_idx: torch.Tensor, tap_w: torch.Tensor,
               params: dict):
    """feat_2d [B, H, W, C2], feat_3d [B, N, C3], score [B, HW, C3], nn_idx
    [B, HW, 1] int32 (the pixels' nearest points, `fusion_interp_cache`),
    tap_idx [B, N, 4] int32 and tap_w [B, N, 4] (`grid_sample_cache`) ->
    (out_2d, out_3d). CPU tensors take the plain version; CUDA tensors the
    kernel."""
    tensors = (feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w)
    _cuda.forward_only("clfm_fused", *tensors)
    if _cuda.on_cpu(*tensors):
        return clfm_fused_plain(*tensors, params)
    name = "clfm_fused"
    _cuda.check(name, torch.float32, feat_2d=feat_2d, feat_3d=feat_3d, score=score, tap_w=tap_w)
    _cuda.check(name, torch.int32, nn_idx=nn_idx, tap_idx=tap_idx)
    if nn_idx.device != feat_2d.device or tap_idx.device != feat_2d.device:
        raise ValueError(f"{name}: all inputs must lie on one CUDA device")
    _cuda.check_shape(name, "feat_2d", feat_2d, (None, None, None, None))
    batch, height, width, c2 = feat_2d.shape
    hw = height * width
    _cuda.check_shape(name, "feat_3d", feat_3d, (batch, None, None))
    n, c3 = feat_3d.shape[1:]
    _cuda.check_shape(name, "score", score, (batch, hw, c3))
    _cuda.check_shape(name, "nn_idx", nn_idx, (batch, hw, 1))
    _cuda.check_shape(name, "tap_idx", tap_idx, (batch, n, 4))
    _cuda.check_shape(name, "tap_w", tap_w, (batch, n, 4))
    _check_tc(name, params, (), feat_2d=feat_2d, feat_3d=feat_3d)
    planes, heads = _weights(name, params, feat_2d, feat_3d)
    scratch = feat_2d.new_empty(scratch_floats(batch, hw, n, c2, c3))
    out_2d, out_3d = torch.empty_like(feat_2d), torch.empty_like(feat_3d)
    from ..csrc.build import launch

    launch("camli_clfm", *(t.data_ptr() for t in tensors), planes, *heads,
           scratch.data_ptr(), out_2d.data_ptr(), out_3d.data_ptr(), batch, hw, n, c2, c3,
           params["sk_2d"].mid_t.shape[0], params["sk_3d"].mid_t.shape[0])
    clfm_fused.launches += 1
    return out_2d, out_3d


clfm_fused.launches = 0
