"""PyTorch port, the 2D update chain's bf16 packing for the wgmma tile, on
the CPU.

The fast path's tile (camliflow_torch/csrc/conv_tile_bf16.cuh) reads each
conv's weights as a bf16 plane [N_pad, K_pad], K_pad a multiple of 64 (one
128-byte TMA row a stage), packed once per request by
`pack_convs(..., bf16=True)`. These tests hold that plane to the f32 plane of
bf16-rounded weights that the earlier bf16 mode read ([N_pad, K_pad] with
K_pad a multiple of 16), value for value with zeros in the padding, and hold
the plain bf16 versions of #9, #8 and #10 bit for bit to what they give on
that earlier packing. The plain forms against the JAX package's bf16 kernels
are tests/test_torch_fast_inference.py; the kernels themselves run only on
a card: tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from camliflow_torch.models import raft as traft
from camliflow_torch.ops import update2d

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def forward_only():
    """The packers are forward-only (they refuse weights that require grad
    while grad mode is on); these tests exercise the eval path."""
    with torch.no_grad():
        yield


def modules(seed: int, corr_channels: int = 36) -> dict:
    torch.manual_seed(seed)
    return {"me": traft.MotionEncoder2D(corr_channels=corr_channels), "gru": traft.GRU2D(),
            "head": traft.FlowHead2D()}


def packings(mods: dict, bf16: bool) -> tuple[dict, dict]:
    return update2d.prepare_update_2d_params(mods["me"], mods["gru"], mods["head"], bf16=bf16)


def earlier_packing(conv: update2d.PackedConv) -> update2d.PackedConv:
    """The bf16 packing the tile's earlier bf16 mode read: the rounded weights
    [K_pad, N_pad] with K_pad a multiple of 16, and as its one plane their
    transpose in f32."""
    k = conv.kh * conv.kw * conv.cin
    weight = conv.weight.new_zeros(-(-k // 16) * 16, conv.weight.shape[1])
    weight[:k] = conv.weight[:k]
    return conv._replace(weight=weight, hi=weight.t().contiguous())


@pytest.mark.parametrize("key", ["conv_c1", "conv_c2", "conv_f2", "conv", "zr1", "q1", "zr2",
                                 "q2", "head1", "head2"])
def test_bf16_plane_holds_the_earlier_plane(key):
    """The bf16 plane: torch.bfloat16, contiguous, [N_pad, K_pad] with N_pad
    a multiple of 64 and K_pad the reduction rounded up to 64; its values are
    the earlier f32 plane's (the weights rounded to bf16, transposed) and
    zero past (cout, kh * kw * cin); the f32 weights the plain versions read
    are the same values."""
    mods = modules(11)
    me, gf = packings(mods, bf16=True)
    conv = {**me, **gf}[key]
    k = conv.kh * conv.kw * conv.cin
    plane = conv.hi
    assert conv.bf16 and conv.lo is None
    assert plane.dtype == torch.bfloat16 and plane.is_contiguous()
    assert plane.shape == (-(-conv.cout // 64) * 64, -(-k // 64) * 64)
    assert plane.shape == conv.weight.shape[::-1]
    earlier = earlier_packing(conv).hi
    assert torch.equal(plane.float()[:, : earlier.shape[1]], earlier)
    assert not plane[:, k:].float().any() and not plane[conv.cout:].float().any()
    assert torch.equal(plane.float().t(), conv.weight)
    # the values are the modules' weights rounded to bf16 (nearest, ties to even)
    gru, head = mods["gru"], mods["head"]
    sources = {"zr1": (gru.convz1, gru.convr1), "q1": (gru.convq1,),
               "zr2": (gru.convz2, gru.convr2), "q2": (gru.convq2,), "head1": (head.conv1,),
               "head2": (head.conv2,)}
    sources = sources[key] if key in sources else (getattr(mods["me"], key),)
    flat = torch.cat([c.weight for c in sources]).permute(2, 3, 1, 0).reshape(k, conv.cout)
    assert torch.equal(plane.float()[: conv.cout, :k], update2d.bf16_round(flat).t())


@pytest.mark.parametrize("form", ["motion_encoder_2d", "gru_flowhead_2d", "update_2d"])
@pytest.mark.parametrize("shape", [(1, 5, 13), (2, 4, 6)])
def test_plain_bf16_forms_bit_for_bit_on_the_earlier_packing(form, shape):
    """motion_encoder_2d_plain, gru_flowhead_2d_plain and update_2d_plain on
    the bf16 planes give, bit for bit, what they give on the earlier packing:
    the repacking moves no value the plain versions read."""
    me, gf = packings(modules(12), bf16=True)
    old_me = {k: v if k == "conv_f1" else earlier_packing(v) for k, v in me.items()}
    old_gf = {k: earlier_packing(v) for k, v in gf.items()}
    rng = np.random.RandomState(13)

    def rand(channels, scale=1.0):
        return torch.from_numpy(scale * rng.randn(*shape, channels).astype(np.float32))

    flow, corr = rand(2, 2.0), rand(36)
    h, x2d, motion = torch.tanh(rand(128)), torch.relu(rand(128)), rand(128)
    if form == "motion_encoder_2d":
        new = (update2d.motion_encoder_2d_plain(flow, corr, me),)
        old = (update2d.motion_encoder_2d_plain(flow, corr, old_me),)
    elif form == "gru_flowhead_2d":
        new = update2d.gru_flowhead_2d_plain(h, x2d, motion, gf)
        old = update2d.gru_flowhead_2d_plain(h, x2d, motion, old_gf)
    else:
        new = update2d.update_2d_plain(h, x2d, flow, corr, me, gf)
        old = update2d.update_2d_plain(h, x2d, flow, corr, old_me, old_gf)
    for a, b in zip(new, old):
        assert torch.equal(a, b)

