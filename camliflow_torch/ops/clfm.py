"""One in-loop CLFM call: CUDA kernel, plain version, wrapper.

Replaces camliflow_tpu/ops/pallas_clfm.py::clfm_fused_pallas with
`csrc/clfm.cu` (see the source's note for the design and the bound). In the
refinement loop, CLFM fuses the two branches' features at corr and motion
(and at the hidden state with `fuse_hidden`). Everything that does not change
across iterations is hoisted, once per request, as the JAX package does:

- `hoist_interp_score`: the interp score MLP, whose input is only the
  pixel -> nearest-point offsets, as a [B, HW, C3] f32 gate (the bf16
  form: rounded to bf16, a bf16 tensor);
- `grid_sample_cache`: the 4 bilinear taps of the 2D -> 3D sample at uv;
- `prepare_clfm_params`: the dense layers, packed, with the tf32 weight
  planes of the tensor-core tile (the bf16 form: rounded to bf16, one
  bf16 plane [N_pad, K_pad] a layer, K_pad a multiple of 64, which the
  chain's TMA reads 64 x 64 at a time); the SK heads' layers, also
  transposed.

    clfm_fused(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params)
        -> (out_2d [B, H, W, C2], out_3d [B, N, C3])
    sk_state(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params)
        -> each side's (SK mean [B, C], pair weights [B, C, 2]), a check
           of the one reduction across blocks

Two forms, by the params' packing. The exact form: the f32 chain of
`nn/clfm.py::CLFM.forward` on the hoisted operands. The bf16 form
(`fast_inference=on` with CAMLIFLOW_CLFM=1, `bf16_enabled`; the corr and
motion fusions, as the JAX package engages its kernel): the TPU kernel's
numerics, `_clfm_kernel` and `_sk_fuse` of camliflow_tpu/ops/pallas_clfm.py:
the feature tables rounded to bf16 before every gather, score * g a bf16
product, the bilinear sample bf16 rows times f32 tap weights summed in tap
order, every dense layer and SK head layer on bf16 operands with f32 sums,
the SK mean over a + b in f32, the pair weight sigmoid(s1 - s2) of the
even/odd logits, the blend a w1 + b (1 - w1) in f32. The fusions at fnet and
cnet keep the module: they have batch norm and run once per request, and
the JAX package never fuses them.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _cuda
from .geometry import gather_points
from .gridsample import bilinear_taps
from .update2d import (
    K_ALIGN_BF16,
    N_ALIGN,
    PackedConv,
    _check_params,
    _check_tc,
    _planes,
    _round_up,
    bf16_round,
    split_tf32,
)
from .update3d import linear_plain, pack_linears

DENSE = ("out_conv", "align1_2d", "align2_2d", "mlps3d", "align1_3d", "align2_3d")
MAX_WIDTH = 1024  # csrc/clfm.cu kMaxC
CHUNK = 256  # csrc/clfm.cu kChunk: rows per partial column sum (the exact form)
CHAIN_ROWS = 64  # csrc/clfm.cu kChainRows: rows a block of the bf16 form's chain
CHAIN_STAGES = 6  # csrc/clfm.cu kChainStages: its weight tiles in flight
MAX_SMEM = 232448  # the dynamic shared memory a block may take on an H100 (227 KB)
CHECKED = "_checked"  # the params' entry that remembers their last check


def bf16_enabled() -> bool:
    """The JAX package's switch of its fused CLFM kernel (camliflow_tpu/ops/
    pallas_clfm.py::clfm_pallas_enabled), read the same way: on unless
    CAMLIFLOW_CLFM is unset or "0". The flagship reads it at each fast
    forward's encode."""
    return os.environ.get("CAMLIFLOW_CLFM", "0") != "0"


class SKHead(NamedTuple):
    """An SK fusion's two bias-free layers, [in, out] f32 (the bf16 form:
    bf16 values), and the same transposed, [out, in], as the kernel reads
    them (a warp per row)."""

    mid: torch.Tensor  # [C, C // 2]
    out: torch.Tensor  # [C // 2, 2C]: columns 2c and 2c + 1 are channel c's pair
    mid_t: torch.Tensor  # [C // 2, C]
    out_t: torch.Tensor  # [2C, C // 2]


def hoist_interp_score(interp: nn.Module, knn_offset: torch.Tensor,
                       bf16: bool = False) -> torch.Tensor:
    """FusionAwareInterp's score gate ([B, HW, 1, 2] offsets -> [B, HW, C3]),
    computed as the module computes it, once per request; with `bf16` (the
    bf16 form) rounded to a bf16 tensor."""
    norm = torch.linalg.vector_norm(knn_offset, dim=-1, keepdim=True)
    score = interp.score_net(torch.cat([knn_offset, norm], dim=-1).float())
    score = score[:, :, 0, :].contiguous()
    return score.to(torch.bfloat16) if bf16 else score


def grid_sample_cache(uv: torch.Tensor, height: int, width: int):
    """The 4 corner taps of `grid_sample_points(feat_2d, uv)` at loop-invariant
    uv: (flat indices [B, N, 4] int32, weights [B, N, 4] f32, out-of-map
    corners weighted 0)."""
    uv = uv.float()
    idx, weights = bilinear_taps(uv[..., 0], uv[..., 1], height, width)
    return idx.int().contiguous(), weights.contiguous()


def _sk(fusion: nn.Module, bf16: bool = False) -> SKHead:
    mid, out = (layer[0].weight.detach().float() for layer in (fusion.fc_mid, fusion.fc_out))
    if bf16:
        mid, out = bf16_round(mid), bf16_round(out)
    return SKHead(mid.t().contiguous(), out.t().contiguous(), mid.contiguous(),
                  out.contiguous())


def _pack_dense(linear: nn.Linear, bf16: bool = False) -> PackedConv:
    """A Linear packed as a 1x1 conv with the tensor-core tile's tf32
    planes ([N_pad, K_pad], K-major); with `bf16`, its weights rounded to
    bf16 and, as the chain's one plane, their transpose in bf16 with K
    padded to a multiple of 64 (the weight stays f32: the plain version's)."""
    if bf16:
        rounded = pack_linears(linear, bf16=True)
        packed = rounded.weight.new_zeros(_round_up(rounded.cin, K_ALIGN_BF16),
                                          rounded.weight.shape[1])
        packed[: rounded.weight.shape[0]] = rounded.weight
        plane = packed.t().contiguous().to(torch.bfloat16)
        return rounded._replace(weight=packed, hi=plane)
    packed = pack_linears(linear)
    hi, lo = split_tf32(packed.weight.t().contiguous())
    return packed._replace(hi=hi, lo=lo)


def prepare_clfm_params(clfm: nn.Module, bf16: bool = False) -> dict:
    """The dense layers of a `nn.clfm.CLFM` without norm (the in-loop ones),
    packed once per request: the six 1x1 layers as `PackedConv`s with their
    tf32 planes, and each SK head's fc_mid and fc_out; with `bf16` (the bf16
    form, camliflow_tpu/ops/pallas_clfm.py::prepare_clfm_params) every
    weight rounded to bf16, the biases f32."""
    _cuda.forward_only_modules("prepare_clfm_params", clfm)
    if clfm.fusion_fn != "sk":
        raise ValueError(f"prepare_clfm_params: SK fusion heads only, not {clfm.fusion_fn!r}")
    layers = {"out_conv": clfm.interp.out_conv, "align1_2d": clfm.fuse2d.align1,
              "align2_2d": clfm.fuse2d.align2, "mlps3d": clfm.mlps3d,
              "align1_3d": clfm.fuse3d.align1, "align2_3d": clfm.fuse3d.align2}
    for name, layer in layers.items():
        if not isinstance(layer.norm_fn, nn.Identity) or layer.act != "leaky_relu":
            raise ValueError(f"prepare_clfm_params: {name} must be a Linear + leaky ReLU")
    params = {name: _pack_dense(layer.conv_fn, bf16) for name, layer in layers.items()}
    params["sk_2d"], params["sk_3d"] = _sk(clfm.fuse2d, bf16), _sk(clfm.fuse3d, bf16)
    return params


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def _sk_state(a: torch.Tensor, b: torch.Tensor, head: SKHead, bf16: bool = False):
    """SKFusion's mean of a + b [B, C] and pair weights [B, C, 2], of a and b
    [B, ..., C] after its align layers. The bf16 form: the layers on bf16
    operands, the pair (w1, 1 - w1), w1 = sigmoid(s1 - s2)."""
    batch, channels = a.shape[0], a.shape[-1]
    mean = torch.mean(a + b, dim=tuple(range(1, a.dim() - 1)))
    if bf16:
        mid = F.relu(bf16_round(mean) @ head.mid)
        logits = (bf16_round(mid) @ head.out).reshape(batch, channels, 2)
        s = torch.sigmoid(logits)
        w1 = torch.sigmoid(s[..., 0] - s[..., 1])
        return mean, torch.stack((w1, 1.0 - w1), dim=-1)
    weight = torch.sigmoid(F.relu(mean @ head.mid) @ head.out)
    return mean, torch.softmax(weight.reshape(batch, channels, 2), dim=-1)


def _sk_fuse(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """a w1 + b w2 with `_sk_state`' pair of each batch item and channel."""
    shape = (a.shape[0],) + (1,) * (a.dim() - 2) + (a.shape[-1],)
    return a * weights[..., 0].reshape(shape) + b * weights[..., 1].reshape(shape)


def _plain(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params: dict):
    """The plain version: (out_2d, out_3d, (the 2D side's SK mean and
    weights, the 3D side's))."""
    batch, height, width, c2 = feat_2d.shape
    bf16 = params["out_conv"].bf16
    if bf16:  # the feature tables in bf16 before every gather and product
        feat_2d, feat_3d = bf16_round(feat_2d), bf16_round(feat_3d)
    # 3D -> 2D: the nearest point's features, gated, then out_conv
    gathered = gather_points(feat_3d, nn_idx)[:, :, 0]  # [B, HW, C3]
    gated = score.float() * gathered
    if bf16:  # a bf16 product
        gated = bf16_round(gated)
    interp = _leaky(linear_plain(gated, params["out_conv"]))
    interp = interp.reshape(batch, height, width, -1)
    a, b = (_leaky(linear_plain(feat_2d, params["align1_2d"])),
            _leaky(linear_plain(interp, params["align2_2d"])))
    sk_2d = _sk_state(a, b, params["sk_2d"], bf16)
    out_2d = _sk_fuse(a, b, sk_2d[1])
    # 2D -> 3D: the bilinear sample (grid_sample_pixel's sum), then mlps3d
    flat = feat_2d.reshape(batch, height * width, c2)
    sampled = None
    for t in range(4):
        vals = gather_points(flat, tap_idx[..., t]) * tap_w[..., t : t + 1]
        sampled = vals if sampled is None else sampled + vals
    sampled = _leaky(linear_plain(sampled, params["mlps3d"]))
    a, b = (_leaky(linear_plain(sampled, params["align1_3d"])),
            _leaky(linear_plain(feat_3d, params["align2_3d"])))
    sk_3d = _sk_state(a, b, params["sk_3d"], bf16)
    return out_2d, _sk_fuse(a, b, sk_3d[1]), (sk_2d, sk_3d)


def clfm_fused_plain(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params: dict):
    return _plain(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params)[:2]


def sk_state_plain(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params: dict):
    """The plain version's SK state of each side: the mean of a + b over its
    rows [B, C] and the pair weights [B, C, 2] (`sk_state`)."""
    return _plain(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params)[2]


def _scratch_parts(batch: int, hw: int, n: int, c2: int, c3: int, bf16: bool) -> list[int]:
    """The kernel's scratch parts, in floats and in order (csrc/clfm.cu::
    camli_clfm lists the exact form's, run_bf16 the bf16 form's); the last
    two hold the SK weights [batch, c2, 2] and [batch, c3, 2]."""
    rows2, rows3 = batch * hw, batch * n
    weights = [2 * batch * c2, 2 * batch * c3]
    if bf16:  # a, b, a3, b3 in f32, the partial sums by 64-row tile, each 4-float aligned
        parts = [rows2 * c2, rows2 * c2, rows3 * c3, rows3 * c3,
                 batch * -(-hw // CHAIN_ROWS) * c2, batch * -(-n // CHAIN_ROWS) * c3, *weights]
        return [_round_up(part, 4) for part in parts]
    # g, interp, samp, sm, a, b, b3, a3, the partial sums by 256-row chunk
    return [rows2 * c3, rows2 * c3, rows3 * c2, rows3 * c2, rows2 * c2, rows2 * c2, rows3 * c3,
            rows3 * c3, batch * -(-hw // CHUNK) * c2, batch * -(-n // CHUNK) * c3, *weights]


def scratch_floats(batch: int, hw: int, n: int, c2: int, c3: int, bf16: bool = False) -> int:
    """The kernel's scratch (`_scratch_parts`)."""
    return sum(_scratch_parts(batch, hw, n, c2, c3, bf16))


def chain_smem_bytes(c2: int, c3: int) -> int:
    """The bf16 form's shared memory a block (csrc/clfm.cu::chain_smem_bytes):
    the A operands of the wider side in 64-column chunks of 8 KB, the ring of
    weight tiles (128 outputs of 64 bf16, 16 KB), the barriers, the rows'
    gather indices, the column sums' exchange of two warpgroups, 1 KB to
    align."""
    k2, k3 = -(-c2 // 64), -(-c3 // 64)
    chunks = max(2 * k3 + k2, 2 * k2 + k3)
    return (chunks * 8192 + CHAIN_STAGES * 16384 + (2 * CHAIN_STAGES + 2) * 8 + CHAIN_ROWS * 32
            + 2 * 4 * 64 * 4 + 1024)


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
    _check_tc(name, dense, DENSE)  # one packing, f32 or bf16, for all six
    if dense["out_conv"].bf16:  # the chain's planes, and its shared memory
        for key, (cin, cout) in fits.items():
            plane = dense[key].hi
            if (plane.dtype != torch.bfloat16
                    or plane.shape != (_round_up(cout, N_ALIGN), _round_up(cin, K_ALIGN_BF16))):
                raise ValueError(f"{name}: params[{key!r}] need their bf16 plane [N_pad, K_pad], "
                                 f"K_pad a multiple of {K_ALIGN_BF16}; pack them with "
                                 "prepare_clfm_params(..., bf16=True)")
        if chain_smem_bytes(c2, c3) > MAX_SMEM:
            raise ValueError(f"{name}: the bf16 form's block at C2={c2}, C3={c3} needs "
                             f"{chain_smem_bytes(c2, c3)} bytes of shared memory, over "
                             f"{MAX_SMEM}")
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


def _launch(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params: dict):
    """The kernel on CUDA tensors: (out_2d, out_3d, its scratch)."""
    tensors = (feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w)
    name = "clfm_fused"
    bf16 = params["out_conv"].bf16
    _cuda.check(name, torch.float32, feat_2d=feat_2d, feat_3d=feat_3d, tap_w=tap_w)
    _cuda.check(name, torch.bfloat16 if bf16 else torch.float32, score=score)
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
    if bf16 and (score.data_ptr() % 8 or tap_idx.data_ptr() % 16 or tap_w.data_ptr() % 16):
        raise ValueError(f"{name}: the bf16 form reads the score 4 values and the taps a "
                         "point at a time: score 8-byte and the taps 16-byte aligned")
    planes, heads = _weights(name, params, feat_2d, feat_3d)
    scratch = feat_2d.new_empty(scratch_floats(batch, hw, n, c2, c3, bf16))
    out_2d, out_3d = torch.empty_like(feat_2d), torch.empty_like(feat_3d)
    from ..csrc.build import launch

    launch("camli_clfm", *(t.data_ptr() for t in tensors), planes, *heads,
           scratch.data_ptr(), out_2d.data_ptr(), out_3d.data_ptr(), int(bf16), batch, hw, n,
           c2, c3, params["sk_2d"].mid_t.shape[0], params["sk_3d"].mid_t.shape[0])
    _cuda.count(clfm_fused, bf16)
    return out_2d, out_3d, scratch


def clfm_fused(feat_2d: torch.Tensor, feat_3d: torch.Tensor, score: torch.Tensor,
               nn_idx: torch.Tensor, tap_idx: torch.Tensor, tap_w: torch.Tensor,
               params: dict):
    """feat_2d [B, H, W, C2], feat_3d [B, N, C3], score [B, HW, C3], nn_idx
    [B, HW, 1] int32 (the pixels' nearest points, `fusion_interp_cache`),
    tap_idx [B, N, 4] int32 and tap_w [B, N, 4] (`grid_sample_cache`) ->
    (out_2d, out_3d). The params' packing picks the form: f32 (score f32)
    or bf16 (`prepare_clfm_params(..., bf16=True)`, score a bf16 tensor,
    `hoist_interp_score(..., bf16=True)`). CPU tensors take the plain
    version; CUDA tensors the kernel. The bf16 form's launches count on
    `.fast_launches`."""
    tensors = (feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w)
    _cuda.forward_only("clfm_fused", *tensors)
    if _cuda.on_cpu(*tensors):
        return clfm_fused_plain(*tensors, params)
    return _launch(*tensors, params)[:2]


def sk_state(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params: dict):
    """One call's SK state of each side, ((mean [B, C2], weights [B, C2, 2]),
    (mean [B, C3], weights [B, C3, 2])): the mean of a + b over the side's
    rows, and the pair weights the heads made of it. On CUDA tensors, the
    mean of the column sums that the kernel wrote by tile (or chunk) into its
    scratch, summed in f64, and the weights it wrote there; on CPU tensors,
    the plain version's. A check of the one reduction across blocks."""
    tensors = (feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w)
    _cuda.forward_only("clfm_fused", *tensors)
    if _cuda.on_cpu(*tensors):
        return sk_state_plain(*tensors, params)
    scratch = _launch(*tensors, params)[2]
    batch, height, width, c2 = feat_2d.shape
    n, c3 = feat_3d.shape[1:]
    bf16 = params["out_conv"].bf16
    parts = _scratch_parts(batch, height * width, n, c2, c3, bf16)
    starts = [sum(parts[:i]) for i in range(len(parts))]
    rows_a_tile = CHAIN_ROWS if bf16 else CHUNK
    state = []
    for side, (rows, c) in enumerate(((height * width, c2), (n, c3))):
        tiles = -(-rows // rows_a_tile)
        at = starts[len(parts) - 4 + side]
        partial = scratch[at : at + batch * tiles * c].view(batch, tiles, c)
        at = starts[len(parts) - 2 + side]
        weights = scratch[at : at + batch * c * 2].view(batch, c, 2)
        state.append((partial.double().sum(1).div(rows).float(), weights))
    return tuple(state)


clfm_fused.launches = 0
clfm_fused.fast_launches = 0
