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

K_ALIGN = 16  # the kernel's reduction chunk
N_ALIGN = 64  # the kernel's output-channel tile


class PackedConv(NamedTuple):
    weight: torch.Tensor  # [K_pad, N_pad]: HWIO flattened, zero-padded
    bias: torch.Tensor  # [N_pad]
    kh: int
    kw: int
    cin: int
    cout: int
    hi: torch.Tensor | None = None  # [N_pad, K_pad]: tf32(weight.T)
    lo: torch.Tensor | None = None  # [N_pad, K_pad]: tf32(weight.T - hi)

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


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split: hi = tf32(x), lo = tf32(x - hi); hi + lo is x to
    about 2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def pack_convs(*convs: nn.Conv2d) -> PackedConv:
    """One packed conv from Conv2d modules sharing their input: their output
    channels are stacked in order (the GRU's z and r). Also the tf32 planes
    of the tensor-core tile, zero in the padding."""
    weight = torch.cat([c.weight for c in convs], dim=0).detach().float()
    bias = torch.cat([c.bias for c in convs], dim=0).detach().float()
    cout, cin, kh, kw = weight.shape
    k = kh * kw * cin
    flat = weight.permute(2, 3, 1, 0).reshape(k, cout)
    packed = weight.new_zeros(_round_up(k, K_ALIGN), _round_up(cout, N_ALIGN))
    packed[:k, :cout] = flat
    padded_bias = bias.new_zeros(packed.shape[1])
    padded_bias[:cout] = bias
    hi, lo = split_tf32(packed.t().contiguous())
    return PackedConv(packed, padded_bias, kh, kw, cin, cout, hi, lo)


def conv_plain(x: torch.Tensor, conv: PackedConv) -> torch.Tensor:
    """NHWC 'same' convolution with bias from a packed conv."""
    out = F.conv2d(x.permute(0, 3, 1, 2), conv.oihw(), conv.bias[: conv.cout],
                   padding=((conv.kh - 1) // 2, (conv.kw - 1) // 2))
    return out.permute(0, 2, 3, 1)


# --- MotionEncoder2D (kernel #9) -----------------------------------------


def prepare_motion_encoder_params(encoder: nn.Module) -> dict:
    """Packed convs of a `models.raft.MotionEncoder2D`; conv_f1 stays a
    plain (weight, bias) pair: it runs outside the kernel."""
    _cuda.forward_only_modules("prepare_motion_encoder_params", encoder)
    params = {name: pack_convs(getattr(encoder, name))
              for name in ("conv_c1", "conv_c2", "conv_f2", "conv")}
    params["conv_f1"] = (encoder.conv_f1.weight.detach().float(),
                         encoder.conv_f1.bias.detach().float())
    return params


def _conv_f1(flow: torch.Tensor, params: dict) -> torch.Tensor:
    """conv_f1 (7x7, bias, ReLU) as one F.conv2d -> NHWC contiguous."""
    weight, bias = params["conv_f1"]
    out = F.relu(F.conv2d(flow.permute(0, 3, 1, 2), weight, bias, padding=3))
    return out.permute(0, 2, 3, 1).contiguous()


def motion_encoder_2d_plain(flow: torch.Tensor, corr: torch.Tensor, params: dict):
    ff = _conv_f1(flow, params)
    cf = F.relu(conv_plain(corr, params["conv_c1"]))
    cf = F.relu(conv_plain(cf, params["conv_c2"]))
    ff = F.relu(conv_plain(ff, params["conv_f2"]))
    out = torch.nan_to_num(F.relu(conv_plain(torch.cat([cf, ff], dim=-1), params["conv"])))
    return torch.cat([out, flow], dim=-1)


def _check_params(name: str, params: dict, device: torch.device) -> None:
    for key, value in params.items():
        tensors = value[:2]
        for t in tensors:
            if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}: params[{key!r}] must be contiguous f32 on "
                                 f"{device}; prepare them on the inputs' device")


def _check_tc(name: str, params: dict, keys, **tensors: torch.Tensor) -> None:
    """What the tensor-core tile assumes: each input's channel count a
    multiple of 4 and its address 16-byte aligned (16-byte copies of 4
    channels), and each packed conv's tf32 planes beside its weights."""
    for key, t in tensors.items():
        if t.shape[-1] % 4:
            raise ValueError(f"{name}: {key} has {t.shape[-1]} channels, not a multiple of 4 "
                             "(the kernel copies 4 channels at a time)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start at a 16-byte aligned address")
    for key in keys:
        conv = params[key]
        for plane in (conv.hi, conv.lo):
            if (plane is None or plane.device != conv.weight.device
                    or plane.shape != conv.weight.shape[::-1] or not plane.is_contiguous()
                    or plane.data_ptr() % 16):
                raise ValueError(f"{name}: params[{key!r}] lack their tf32 planes; pack them "
                                 "with pack_convs")
        if key != keys[-1] and conv.cout % 4:
            raise ValueError(f"{name}: params[{key!r}] feed the next conv {conv.cout} "
                             "channels, not a multiple of 4")


def _planes(params: dict, keys) -> ctypes.Array:
    """The (hi, lo, bias) pointers of the packed convs `keys`, in order, as
    the C array the entry points take."""
    ptrs = [t.data_ptr() for key in keys
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
    _check_tc(name, params, ME_CONVS, corr=corr, ff1=ff1)
    new = lambda c: flow.new_empty(batch, height, width, c)  # noqa: E731
    cf1, cf, ff, out = new(c1.cout), new(c2.cout), new(f2.cout), new(merge.cout + 2)
    from ..csrc.build import launch

    launch("camli_motion_encoder_2d", flow.data_ptr(), ff1.data_ptr(), corr.data_ptr(),
           _planes(params, ME_CONVS), cf1.data_ptr(), cf.data_ptr(), ff.data_ptr(),
           out.data_ptr(), batch, height, width, c1.cin, c1.cout, c2.cout, ff1.shape[-1],
           f2.cout, merge.cout)
    motion_encoder_2d.launches += 1
    return out


motion_encoder_2d.launches = 0


# --- GRU2D + FlowHead2D (kernel #8) --------------------------------------


def prepare_gru_params(gru: nn.Module) -> dict:
    """Packed convs of a `models.raft.GRU2D`: per direction, z|r stacked
    into one conv, and q."""
    _cuda.forward_only_modules("prepare_gru_params", gru)
    return {
        "zr1": pack_convs(gru.convz1, gru.convr1), "q1": pack_convs(gru.convq1),
        "zr2": pack_convs(gru.convz2, gru.convr2), "q2": pack_convs(gru.convq2),
    }


def prepare_flow_head_params(head: nn.Module) -> dict:
    """Packed convs of a `models.raft.FlowHead2D`."""
    _cuda.forward_only_modules("prepare_flow_head_params", head)
    return {"head1": pack_convs(head.conv1), "head2": pack_convs(head.conv2)}


def prepare_gru_flowhead_params(gru: nn.Module, head: nn.Module) -> dict:
    return {**prepare_gru_params(gru), **prepare_flow_head_params(head)}


def gru_2d_plain(h: torch.Tensor, x: torch.Tensor, params: dict) -> torch.Tensor:
    """Separable ConvGRU (1x5 then 5x1); nan_to_num once at the end."""
    hidden = h.shape[-1]
    for zr, q in (("zr1", "q1"), ("zr2", "q2")):
        gates = torch.sigmoid(conv_plain(torch.cat([h, x], dim=-1), params[zr]))
        z, r = gates[..., :hidden], gates[..., hidden:]
        q_new = torch.tanh(conv_plain(torch.cat([r * h, x], dim=-1), params[q]))
        h = (1.0 - z) * h + z * q_new
    return torch.nan_to_num(h)


def flow_head_2d_plain(h: torch.Tensor, params: dict) -> torch.Tensor:
    mid = F.relu(conv_plain(h, params["head1"]))
    return torch.nan_to_num(conv_plain(mid, params["head2"]))


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
    _check_tc(name, params, GRU_CONVS, h=h, x2d=x2d, motion=motion)
    z, rh, h1, h_out = (h.new_empty(batch, height, width, ch) for _ in range(4))
    from ..csrc.build import launch

    launch("camli_gru_2d", h.data_ptr(), x2d.data_ptr(), motion.data_ptr(),
           _planes(params, GRU_CONVS), z.data_ptr(), rh.data_ptr(), h1.data_ptr(),
           h_out.data_ptr(), batch, height, width, ch, cx, cm)
    gru_2d.launches += 1
    return h_out


gru_2d.launches = 0


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
    _check_tc(name, params, HEAD_CONVS, h=h)
    mid = h.new_empty(batch, height, width, params["head1"].cout)
    delta = h.new_empty(batch, height, width, 2)
    from ..csrc.build import launch

    launch("camli_flow_head_2d", h.data_ptr(), _planes(params, HEAD_CONVS), mid.data_ptr(),
           delta.data_ptr(), batch, height, width, ch, mid.shape[-1])
    flow_head_2d.launches += 1
    return delta


flow_head_2d.launches = 0


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
    _check_tc(name, params, GRU_CONVS, h=h, x2d=x2d, motion=motion)
    _check_tc(name, params, HEAD_CONVS)
    head1 = params["head1"]
    new = lambda c: h.new_empty(batch, height, width, c)  # noqa: E731
    z, rh, h1, mid, h_out, delta = new(ch), new(ch), new(ch), new(head1.cout), new(ch), new(2)
    from ..csrc.build import launch

    launch("camli_gru_flowhead_2d", h.data_ptr(), x2d.data_ptr(), motion.data_ptr(),
           _planes(params, GRU_CONVS + HEAD_CONVS), z.data_ptr(), rh.data_ptr(), h1.data_ptr(),
           mid.data_ptr(), h_out.data_ptr(), delta.data_ptr(), batch, height, width, ch, cx,
           cm, head1.cout)
    gru_flowhead_2d.launches += 1
    return h_out, delta


gru_flowhead_2d.launches = 0


# --- the whole RAFT iteration (kernel #10) --------------------------------


def prepare_update_2d_params(encoder: nn.Module, gru: nn.Module, head: nn.Module):
    """(me, gf): the motion encoder's and the GRU + flow head's packings."""
    return prepare_motion_encoder_params(encoder), prepare_gru_flowhead_params(gru, head)


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
    _check_tc(name, me, ME_CONVS, corr=corr, ff1=ff1)
    _check_tc(name, gf, GRU_CONVS, h=h, x2d=x2d)
    _check_tc(name, gf, HEAD_CONVS)
    if cm % 4:
        raise ValueError(f"{name}: the motion features have {cm} channels, not a multiple of 4 "
                         "(the kernel copies 4 channels at a time)")
    pixels = batch * height * width
    # one scratch buffer: [max(c1, head1) | c2 | f2 | motion | 3 x Ch] per pixel
    per_pixel = max(c1.cout, head1.cout) + c2.cout + f2.cout + cm + 3 * ch
    scratch = h.new_empty(pixels * per_pixel)
    h_out, delta = h.new_empty(batch, height, width, ch), h.new_empty(batch, height, width, 2)
    from ..csrc.build import launch

    launch("camli_update_2d", h.data_ptr(), x2d.data_ptr(), flow.data_ptr(), ff1.data_ptr(),
           corr.data_ptr(), _planes({**me, **gf}, ME_CONVS + GRU_CONVS + HEAD_CONVS),
           scratch.data_ptr(), h_out.data_ptr(), delta.data_ptr(), batch, height, width,
           c1.cin, c1.cout, c2.cout, ff1.shape[-1], f2.cout, merge.cout, ch, cx, head1.cout)
    update_2d.launches += 1
    return h_out, delta


update_2d.launches = 0
