"""The 2D update chain: CUDA kernels, plain versions, wrappers.

Replaces camliflow_tpu/ops/pallas_update2d.py::motion_encoder_2d_pallas,
::gru_flowhead_2d_pallas and ::update_2d_pallas with `csrc/update2d.cu`
(see the source's note for the design and the bound). All compute the exact
path in f32 on the 3xTF32 tensor-core tile of `csrc/conv_tile_tc.cuh`, one
launch a conv: the motion encoder (4), the GRU and the flow head (6), and
the RAFT iteration (10) from one entry point.

The modules' weights are repacked once per request, outside the refinement
loop, by `prepare_motion_encoder_params` / `prepare_gru_params` /
`prepare_flow_head_params`: each conv becomes a `PackedConv`, its HWIO
kernel flattened to [kh*kw*Cin, Cout] (row (ky*kw + kx)*Cin + ci) and
zero-padded to the kernels' tiles, and beside it the same weights
transposed (K-major) and split into the tf32 planes hi = tf32(w) and
lo = tf32(w - hi) that the tensor-core tile reads. The plain versions take
the same packed f32 weights and run an `F.conv2d` chain. Maps are NHWC at
every public function. The tensor-core tile copies 4 channels (16 bytes)
at a time, so its wrappers take inputs whose channel counts are multiples
of 4 and whose addresses are 16-byte aligned, and raise on others.

The fast path (`fast_inference=on`) packs with `bf16=True`: the weights
rounded to bf16 once per request and stored as a `torch.bfloat16` plane
[N_pad, K_pad], K_pad a multiple of 64 (the biases stay f32), and the kernels
run on `csrc/conv_tile_bf16.cuh`'s wgmma tile with f32 accumulation, at the
rounding points of camliflow_tpu/ops/pallas_update2d.py: every conv's input
rounded to bf16, and the GRU's hidden state rounded to bf16 (after
nan_to_num) at the end of each direction and wherever it is read. The
intermediates that every consumer rounds (the ReLU outputs of conv_c1,
conv_c2, conv_f2 and the flow head's first conv, and r*h) are kept in bf16.
The plain versions round at the same points, on the same bf16 values as f32
(`PackedConv.weight`). The fast forms' launches count on each wrapper's
`.fast_launches`.

    motion_encoder_2d(flow, corr, me)          -> motion [B, H, W, 126 + 2]
    gru_2d(h, x2d, motion, gru)                -> h' [B, H, W, 128]
    flow_head_2d(h, head)                      -> delta [B, H, W, 2]
    gru_flowhead_2d(h, x2d, motion, gf)        -> (h', delta): the two above
                                                  in sequence
    update_2d(h, x2d, flow, corr, me, gf)      -> the whole iteration from ONE
                                                  entry point (RAFT, no CLFM
                                                  between them): the two
                                                  above, bit for bit
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _cuda

K_ALIGN = 16  # the 3xTF32 tile's reduction chunk
K_ALIGN_BF16 = 64  # the bf16 tile's reduction stage: one 128-byte row of bf16
N_ALIGN = 64  # the kernels' output-channel tile


class PackedConv(NamedTuple):
    weight: torch.Tensor  # [K_pad, N_pad]: HWIO flattened, zero-padded
    bias: torch.Tensor  # [N_pad]
    kh: int
    kw: int
    cin: int
    cout: int
    hi: torch.Tensor | None = None  # [N_pad, K_pad]: tf32(weight.T) (bf16: weight.T in bf16)
    lo: torch.Tensor | None = None  # [N_pad, K_pad]: tf32(weight.T - hi) (bf16: none)
    bf16: bool = False  # the fast path's packing: weight holds bf16 values

    def oihw(self) -> torch.Tensor:
        k = self.kh * self.kw * self.cin
        w = self.weight[:k, : self.cout].reshape(self.kh, self.kw, self.cin, self.cout)
        return w.permute(3, 2, 0, 1)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (10 mantissa bits, ties away from
    zero), as `cvt.rna.tf32.f32` rounds: half of the dropped 13 bits added
    to the magnitude, then the 13 bits cleared (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), as f32."""
    return x.to(torch.bfloat16).float()


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split: hi = tf32(x), lo = tf32(x - hi); hi + lo is x to
    about 2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def pack_convs(*convs: nn.Conv2d, bf16: bool = False) -> PackedConv:
    """One packed conv from Conv2d modules sharing their input: their output
    channels are stacked in order (the GRU's z and r). Also the tf32 planes
    of the 3xTF32 tile, zero in the padding; with `bf16` (the fast path) the
    weights rounded to bf16, K padded to a multiple of 64, and as the bf16
    tile's one plane their transpose stored in bf16."""
    weight = torch.cat([c.weight for c in convs], dim=0).detach().float()
    bias = torch.cat([c.bias for c in convs], dim=0).detach().float()
    cout, cin, kh, kw = weight.shape
    k = kh * kw * cin
    flat = weight.permute(2, 3, 1, 0).reshape(k, cout)
    packed = weight.new_zeros(_round_up(k, K_ALIGN_BF16 if bf16 else K_ALIGN),
                              _round_up(cout, N_ALIGN))
    packed[:k, :cout] = flat
    padded_bias = bias.new_zeros(packed.shape[1])
    padded_bias[:cout] = bias
    if bf16:
        packed = bf16_round(packed)
        plane = packed.t().contiguous().to(torch.bfloat16)
        return PackedConv(packed, padded_bias, kh, kw, cin, cout, plane, None, True)
    hi, lo = split_tf32(packed.t().contiguous())
    return PackedConv(packed, padded_bias, kh, kw, cin, cout, hi, lo)


def _rounding(conv: PackedConv):
    """What a plain version does to a conv's input: round it to bf16 for a
    bf16 packing, nothing otherwise."""
    return bf16_round if conv.bf16 else (lambda x: x)


def conv_plain(x: torch.Tensor, conv: PackedConv) -> torch.Tensor:
    """NHWC 'same' convolution with bias from a packed conv."""
    out = F.conv2d(x.permute(0, 3, 1, 2), conv.oihw(), conv.bias[: conv.cout],
                   padding=((conv.kh - 1) // 2, (conv.kw - 1) // 2))
    return out.permute(0, 2, 3, 1)


# --- MotionEncoder2D (kernel #9) -----------------------------------------


def prepare_motion_encoder_params(encoder: nn.Module, bf16: bool = False) -> dict:
    """Packed convs of a `models.raft.MotionEncoder2D`; conv_f1 stays a
    plain (weight, bias) pair: it runs outside the kernel (with `bf16`, its
    weight rounded to bf16)."""
    _cuda.forward_only_modules("prepare_motion_encoder_params", encoder)
    params = {name: pack_convs(getattr(encoder, name), bf16=bf16)
              for name in ("conv_c1", "conv_c2", "conv_f2", "conv")}
    weight = encoder.conv_f1.weight.detach().float()
    params["conv_f1"] = (bf16_round(weight) if bf16 else weight,
                         encoder.conv_f1.bias.detach().float())
    return params


def _conv_f1(flow: torch.Tensor, params: dict) -> torch.Tensor:
    """conv_f1 (7x7, bias, ReLU) as one F.conv2d -> NHWC contiguous; on a
    bf16 packing over the flow rounded to bf16 (the products of bf16 values
    are exact in f32, as the JAX package's bf16 XLA conv takes them)."""
    weight, bias = params["conv_f1"]
    flow = _rounding(params["conv"])(flow)
    out = F.relu(F.conv2d(flow.permute(0, 3, 1, 2), weight, bias, padding=3))
    return out.permute(0, 2, 3, 1).contiguous()


def motion_encoder_2d_plain(flow: torch.Tensor, corr: torch.Tensor, params: dict):
    r = _rounding(params["conv"])
    ff = _conv_f1(flow, params)
    cf = F.relu(conv_plain(r(corr), params["conv_c1"]))
    cf = F.relu(conv_plain(r(cf), params["conv_c2"]))
    ff = F.relu(conv_plain(r(ff), params["conv_f2"]))
    out = torch.nan_to_num(F.relu(conv_plain(r(torch.cat([cf, ff], dim=-1)), params["conv"])))
    return torch.cat([out, flow], dim=-1)


def _check_params(name: str, params: dict, device: torch.device) -> None:
    for key, value in params.items():
        tensors = value[:2]
        for t in tensors:
            if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}: params[{key!r}] must be contiguous f32 on "
                                 f"{device}; prepare them on the inputs' device")


def _check_tc(name: str, params: dict, keys, bf16_tile: bool = False,
              **tensors: torch.Tensor) -> None:
    """What the tensor-core tiles assume: each input's channel count a
    multiple of 4 and its address 16-byte aligned (copies of 4 channels),
    and each packed conv's tf32 planes (bf16: its one plane) beside its
    weights, all in one mode. `bf16_tile`: a bf16 packing feeds the bf16
    tile (the 2D chain's fast path), whose plane is bf16 with K_pad a
    multiple of 64 (a TMA box a stage) and whose convs have at most 256
    outputs (one wgmma width)."""
    for key, t in tensors.items():
        if t.shape[-1] % 4:
            raise ValueError(f"{name}: {key} has {t.shape[-1]} channels, not a multiple of 4 "
                             "(the kernel copies 4 channels at a time)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start at a 16-byte aligned address")
    if len({params[key].bf16 for key in keys}) > 1:
        raise ValueError(f"{name}: params{list(keys)} mix bf16 and f32 packings")
    for key in keys:
        conv = params[key]
        for plane in (conv.hi,) if conv.bf16 else (conv.hi, conv.lo):
            if (plane is None or plane.device != conv.weight.device
                    or plane.shape != conv.weight.shape[::-1] or not plane.is_contiguous()
                    or plane.data_ptr() % 16):
                raise ValueError(f"{name}: params[{key!r}] lack their tf32 planes; pack them "
                                 "with pack_convs")
        if key != keys[-1] and conv.cout % 4:
            raise ValueError(f"{name}: params[{key!r}] feed the next conv {conv.cout} "
                             "channels, not a multiple of 4")
        if bf16_tile and conv.bf16 and (conv.hi.dtype != torch.bfloat16
                                        or conv.hi.shape[1] % K_ALIGN_BF16):
            raise ValueError(f"{name}: params[{key!r}] need their bf16 plane [N_pad, K_pad], "
                             f"K_pad a multiple of {K_ALIGN_BF16}; pack them with "
                             "pack_convs(..., bf16=True)")
        if bf16_tile and conv.bf16 and conv.cout > 256:
            raise ValueError(f"{name}: params[{key!r}] have {conv.cout} outputs; the bf16 "
                             "tile takes up to 256")


def _scratch_dtype(conv: PackedConv) -> torch.dtype:
    """The storage of the intermediates that every consumer rounds to bf16
    (the chain's ReLU outputs, r*h): bf16 on the fast path's packing."""
    return torch.bfloat16 if conv.bf16 else torch.float32


def _planes(params: dict, keys) -> ctypes.Array:
    """The (hi, lo, bias) pointers of the packed convs `keys`, in order, as
    the C array the entry points take (a bf16 packing's lo: null)."""
    ptrs = [None if t is None else t.data_ptr() for key in keys
            for t in (params[key].hi, params[key].lo, params[key].bias)]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


ME_CONVS = ("conv_c1", "conv_c2", "conv_f2", "conv")
GRU_CONVS = ("zr1", "q1", "zr2", "q2")
HEAD_CONVS = ("head1", "head2")


def motion_encoder_2d(flow: torch.Tensor, corr: torch.Tensor, params: dict):
    """flow [B, H, W, 2], corr [B, H, W, C] -> [B, H, W, 126 + 2] (the merge
    conv's output, then the flow). CPU tensors take the plain version; CUDA
    tensors the kernel, after conv_f1 as one F.conv2d."""
    _cuda.forward_only("motion_encoder_2d", flow, corr)
    if _cuda.on_cpu(flow, corr):
        return motion_encoder_2d_plain(flow, corr, params)
    name = "motion_encoder_2d"
    _cuda.check(name, torch.float32, flow=flow, corr=corr)
    batch, height, width = flow.shape[:3]
    _cuda.check_shape(name, "flow", flow, (batch, height, width, 2))
    c1, c2, f2, merge = (params[k] for k in ME_CONVS)
    _cuda.check_shape(name, "corr", corr, (batch, height, width, c1.cin))
    _check_params(name, params, flow.device)
    ff1 = _conv_f1(flow, params)
    if (c2.cin, f2.cin, merge.cin) != (c1.cout, ff1.shape[-1], c2.cout + f2.cout):
        raise ValueError(f"{name}: the packed convs do not chain")
    _check_tc(name, params, ME_CONVS, bf16_tile=True, corr=corr, ff1=ff1)
    mid = _scratch_dtype(merge)  # the ReLU outputs between the convs

    def new(c, dtype=torch.float32):
        return flow.new_empty(batch, height, width, c, dtype=dtype)

    cf1, cf, ff, out = new(c1.cout, mid), new(c2.cout, mid), new(f2.cout, mid), new(merge.cout + 2)
    from ..csrc.build import launch

    launch("camli_motion_encoder_2d", flow.data_ptr(), ff1.data_ptr(), corr.data_ptr(),
           _planes(params, ME_CONVS), cf1.data_ptr(), cf.data_ptr(), ff.data_ptr(),
           out.data_ptr(), int(merge.bf16), batch, height, width, c1.cin, c1.cout, c2.cout,
           ff1.shape[-1], f2.cout, merge.cout)
    _cuda.count(motion_encoder_2d, merge.bf16)
    return out


motion_encoder_2d.launches = 0
motion_encoder_2d.fast_launches = 0


# --- GRU2D + FlowHead2D (kernel #8) --------------------------------------


def prepare_gru_params(gru: nn.Module, bf16: bool = False) -> dict:
    """Packed convs of a `models.raft.GRU2D`: per direction, z|r stacked
    into one conv, and q."""
    _cuda.forward_only_modules("prepare_gru_params", gru)
    return {
        "zr1": pack_convs(gru.convz1, gru.convr1, bf16=bf16),
        "q1": pack_convs(gru.convq1, bf16=bf16),
        "zr2": pack_convs(gru.convz2, gru.convr2, bf16=bf16),
        "q2": pack_convs(gru.convq2, bf16=bf16),
    }


def prepare_flow_head_params(head: nn.Module, bf16: bool = False) -> dict:
    """Packed convs of a `models.raft.FlowHead2D`."""
    _cuda.forward_only_modules("prepare_flow_head_params", head)
    return {"head1": pack_convs(head.conv1, bf16=bf16),
            "head2": pack_convs(head.conv2, bf16=bf16)}


def prepare_gru_flowhead_params(gru: nn.Module, head: nn.Module, bf16: bool = False) -> dict:
    return {**prepare_gru_params(gru, bf16), **prepare_flow_head_params(head, bf16)}


def gru_2d_plain(h: torch.Tensor, x: torch.Tensor, params: dict) -> torch.Tensor:
    """Separable ConvGRU (1x5 then 5x1); nan_to_num once at the end. On a
    bf16 packing the JAX bf16 kernel's roundings: x and, in each direction,
    h and r*h rounded to bf16, and the new h nan_to_num-ed and rounded."""
    hidden = h.shape[-1]
    fast = params["zr1"].bf16
    r16 = _rounding(params["zr1"])
    x = r16(x)
    for zr, q in (("zr1", "q1"), ("zr2", "q2")):
        h = r16(h)
        gates = torch.sigmoid(conv_plain(torch.cat([h, x], dim=-1), params[zr]))
        z, r = gates[..., :hidden], gates[..., hidden:]
        q_new = torch.tanh(conv_plain(torch.cat([r16(r * h), x], dim=-1), params[q]))
        h = (1.0 - z) * h + z * q_new
        if fast:
            h = r16(torch.nan_to_num(h))
    return h if fast else torch.nan_to_num(h)


def flow_head_2d_plain(h: torch.Tensor, params: dict) -> torch.Tensor:
    r = _rounding(params["head1"])
    mid = F.relu(conv_plain(r(h), params["head1"]))
    return torch.nan_to_num(conv_plain(r(mid), params["head2"]))


def gru_flowhead_2d_plain(h, x2d, motion, params):
    h = gru_2d_plain(h, torch.cat([x2d, motion], dim=-1), params)
    return h, flow_head_2d_plain(h, params)


def _check_gru(name: str, params: dict, ch: int, cx: int, cm: int) -> None:
    """The GRU's packed convs take [h, x2d, motion] (Ch + Cx + Cm channels)."""
    for key, (kh, kw) in (("zr1", (1, 5)), ("q1", (1, 5)), ("zr2", (5, 1)), ("q2", (5, 1))):
        conv = params[key]
        cout = 2 * ch if key.startswith("zr") else ch
        if (conv.kh, conv.kw, conv.cin, conv.cout) != (kh, kw, ch + cx + cm, cout):
            raise ValueError(f"{name}: params[{key!r}] do not fit the inputs")


def _check_flow_head(name: str, params: dict, ch: int) -> None:
    """The flow head's packed convs chain from Ch to 2."""
    head1, head2 = params["head1"], params["head2"]
    if (head1.cin, head2.cin, head2.cout) != (ch, head1.cout, 2):
        raise ValueError(f"{name}: the flow head's packed convs do not chain")


def _check_gru_flowhead(name: str, params: dict, ch: int, cx: int, cm: int) -> None:
    _check_gru(name, params, ch, cx, cm)
    _check_flow_head(name, params, ch)


def _check_gru_inputs(name: str, h, x2d, motion) -> tuple[int, int, int, int, int, int]:
    """(batch, height, width, Ch, Cx, Cm) of the GRU's inputs."""
    _cuda.check(name, torch.float32, h=h, x2d=x2d, motion=motion)
    batch, height, width, ch = h.shape
    _cuda.check_shape(name, "x2d", x2d, (batch, height, width, None))
    _cuda.check_shape(name, "motion", motion, (batch, height, width, None))
    return batch, height, width, ch, x2d.shape[-1], motion.shape[-1]


def gru_2d(h: torch.Tensor, x2d: torch.Tensor, motion: torch.Tensor,
           params: dict) -> torch.Tensor:
    """h [B, H, W, Ch], x2d [B, H, W, Cx], motion [B, H, W, Cm] -> h'
    [B, H, W, Ch]: GRU2D over [h, x2d, motion] (`prepare_gru_params`).
    CPU tensors take the plain version; CUDA tensors #8's GRU half, 4
    launches."""
    _cuda.forward_only("gru_2d", h, x2d, motion)
    if _cuda.on_cpu(h, x2d, motion):
        return gru_2d_plain(h, torch.cat([x2d, motion], dim=-1), params)
    name = "gru_2d"
    batch, height, width, ch, cx, cm = _check_gru_inputs(name, h, x2d, motion)
    _check_params(name, params, h.device)
    _check_gru(name, params, ch, cx, cm)
    _check_tc(name, params, GRU_CONVS, bf16_tile=True, h=h, x2d=x2d, motion=motion)
    z, h1, h_out = (h.new_empty(batch, height, width, ch) for _ in range(3))
    rh = h.new_empty(batch, height, width, ch, dtype=_scratch_dtype(params["q1"]))
    from ..csrc.build import launch

    bf16 = params["zr1"].bf16
    launch("camli_gru_2d", h.data_ptr(), x2d.data_ptr(), motion.data_ptr(),
           _planes(params, GRU_CONVS), z.data_ptr(), rh.data_ptr(), h1.data_ptr(),
           h_out.data_ptr(), int(bf16), batch, height, width, ch, cx, cm)
    _cuda.count(gru_2d, bf16)
    return h_out


gru_2d.launches = 0
gru_2d.fast_launches = 0


def flow_head_2d(h: torch.Tensor, params: dict) -> torch.Tensor:
    """h [B, H, W, Ch] -> delta [B, H, W, 2]: FlowHead2D
    (`prepare_flow_head_params`). CPU tensors take the plain version; CUDA
    tensors #8's flow-head half, 2 launches."""
    _cuda.forward_only("flow_head_2d", h)
    if _cuda.on_cpu(h):
        return flow_head_2d_plain(h, params)
    name = "flow_head_2d"
    _cuda.check(name, torch.float32, h=h)
    batch, height, width, ch = h.shape
    _check_params(name, params, h.device)
    _check_flow_head(name, params, ch)
    _check_tc(name, params, HEAD_CONVS, bf16_tile=True, h=h)
    mid = h.new_empty(batch, height, width, params["head1"].cout,
                      dtype=_scratch_dtype(params["head1"]))
    delta = h.new_empty(batch, height, width, 2)
    from ..csrc.build import launch

    bf16 = params["head1"].bf16
    launch("camli_flow_head_2d", h.data_ptr(), _planes(params, HEAD_CONVS), mid.data_ptr(),
           delta.data_ptr(), int(bf16), batch, height, width, ch, mid.shape[-1])
    _cuda.count(flow_head_2d, bf16)
    return delta


flow_head_2d.launches = 0
flow_head_2d.fast_launches = 0


def gru_flowhead_2d(h: torch.Tensor, x2d: torch.Tensor, motion: torch.Tensor,
                    params: dict):
    """h [B, H, W, Ch], x2d [B, H, W, Cx], motion [B, H, W, Cm] ->
    (h' [B, H, W, Ch], delta [B, H, W, 2]). CPU tensors take the plain
    version; CUDA tensors the kernel: `gru_2d` then `flow_head_2d` from one
    entry point, 6 launches."""
    _cuda.forward_only("gru_flowhead_2d", h, x2d, motion)
    if _cuda.on_cpu(h, x2d, motion):
        return gru_flowhead_2d_plain(h, x2d, motion, params)
    name = "gru_flowhead_2d"
    batch, height, width, ch, cx, cm = _check_gru_inputs(name, h, x2d, motion)
    _check_params(name, params, h.device)
    _check_gru_flowhead(name, params, ch, cx, cm)
    _check_tc(name, params, GRU_CONVS + HEAD_CONVS, bf16_tile=True, h=h, x2d=x2d,
              motion=motion)
    head1 = params["head1"]
    bf = _scratch_dtype(head1)

    def new(c, dtype=torch.float32):
        return h.new_empty(batch, height, width, c, dtype=dtype)

    z, rh, h1, mid, h_out, delta = new(ch), new(ch, bf), new(ch), new(head1.cout, bf), new(ch), \
        new(2)
    from ..csrc.build import launch

    launch("camli_gru_flowhead_2d", h.data_ptr(), x2d.data_ptr(), motion.data_ptr(),
           _planes(params, GRU_CONVS + HEAD_CONVS), z.data_ptr(), rh.data_ptr(), h1.data_ptr(),
           mid.data_ptr(), h_out.data_ptr(), delta.data_ptr(), int(head1.bf16), batch, height,
           width, ch, cx, cm, head1.cout)
    _cuda.count(gru_flowhead_2d, head1.bf16)
    return h_out, delta


gru_flowhead_2d.launches = 0
gru_flowhead_2d.fast_launches = 0


# --- the whole RAFT iteration (kernel #10) --------------------------------


def prepare_update_2d_params(encoder: nn.Module, gru: nn.Module, head: nn.Module,
                             bf16: bool = False):
    """(me, gf): the motion encoder's and the GRU + flow head's packings."""
    return (prepare_motion_encoder_params(encoder, bf16),
            prepare_gru_flowhead_params(gru, head, bf16))


def update_2d_plain(h, x2d, flow, corr, me: dict, gf: dict):
    motion = motion_encoder_2d_plain(flow, corr, me)
    return gru_flowhead_2d_plain(h, x2d, motion, gf)


def update_2d(h: torch.Tensor, x2d: torch.Tensor, flow: torch.Tensor, corr: torch.Tensor,
              me: dict, gf: dict):
    """h [B, H, W, Ch], x2d [B, H, W, Cx], flow [B, H, W, 2], corr
    [B, H, W, C] -> (h' [B, H, W, Ch], delta [B, H, W, 2]). CPU tensors take
    the plain version; CUDA tensors conv_f1 as one F.conv2d, then the kernel
    from one entry point: `motion_encoder_2d` then `gru_flowhead_2d`, bit
    for bit, on one scratch buffer."""
    _cuda.forward_only("update_2d", h, x2d, flow, corr)
    if _cuda.on_cpu(h, x2d, flow, corr):
        return update_2d_plain(h, x2d, flow, corr, me, gf)
    name = "update_2d"
    _cuda.check(name, torch.float32, h=h, x2d=x2d, flow=flow, corr=corr)
    batch, height, width, ch = h.shape
    for key, t in (("x2d", x2d), ("corr", corr)):
        _cuda.check_shape(name, key, t, (batch, height, width, None))
    _cuda.check_shape(name, "flow", flow, (batch, height, width, 2))
    _check_params(name, me, h.device)
    _check_params(name, gf, h.device)
    c1, c2, f2, merge = (me[k] for k in ME_CONVS)
    if c1.cin != corr.shape[-1] or (c2.cin, merge.cin) != (c1.cout, c2.cout + f2.cout):
        raise ValueError(f"{name}: the motion encoder's packed convs do not fit the inputs")
    cx, cm = x2d.shape[-1], merge.cout + 2
    _check_gru_flowhead(name, gf, ch, cx, cm)
    head1 = gf["head1"]
    ff1 = _conv_f1(flow, me)
    if f2.cin != ff1.shape[-1]:
        raise ValueError(f"{name}: conv_f1 does not feed conv_f2")
    _check_tc(name, me, ME_CONVS, bf16_tile=True, corr=corr, ff1=ff1)
    _check_tc(name, gf, GRU_CONVS + HEAD_CONVS, bf16_tile=True, h=h, x2d=x2d)
    bf16 = merge.bf16
    if head1.bf16 != bf16:
        raise ValueError(f"{name}: the motion encoder's and the GRU's packings differ in mode")
    if cm % 4:
        raise ValueError(f"{name}: the motion features have {cm} channels, not a multiple of 4 "
                         "(the kernel copies 4 channels at a time)")
    from ..csrc.build import launch, library

    # one scratch buffer, its maps laid out by the kernel: [max(c1, head1) |
    # c2 | f2] (bf16 on the fast path), [motion | z] f32, [r*h] (bf16 on the
    # fast path), [h1] f32 a pixel
    nbytes = library().camli_update_2d_scratch(int(bf16), batch * height * width, c1.cout,
                                               c2.cout, f2.cout, merge.cout, ch, head1.cout)
    scratch = h.new_empty(nbytes, dtype=torch.uint8)
    h_out, delta = h.new_empty(batch, height, width, ch), h.new_empty(batch, height, width, 2)

    launch("camli_update_2d", h.data_ptr(), x2d.data_ptr(), flow.data_ptr(), ff1.data_ptr(),
           corr.data_ptr(), _planes({**me, **gf}, ME_CONVS + GRU_CONVS + HEAD_CONVS),
           scratch.data_ptr(), h_out.data_ptr(), delta.data_ptr(), int(bf16), batch, height,
           width, c1.cin, c1.cout, c2.cout, ff1.shape[-1], f2.cout, merge.cout, ch, cx,
           head1.cout)
    _cuda.count(update_2d, bf16)
    return h_out, delta


update_2d.launches = 0
update_2d.fast_launches = 0
