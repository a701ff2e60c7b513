"""PyTorch port, the 2D update chain's tensor-core packing and #8's halves,
on the CPU.

The tensor-core tile (camliflow_torch/csrc/conv_tile_tc.cuh) multiplies f32
by the 3xTF32 split: each operand x becomes hi = tf32(x) and
lo = tf32(x - hi), and a product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b. The
weights are split once per request by `pack_convs`. These tests hold the
packing's planes to the f32 weights, show with a plain-torch emulation of
the split that the card tests' tolerance (max |kernel - plain| <=
1e-4 * (1 + max |plain|)) is attainable at the flagship's reductions, and
hold `gru_2d` / `flow_head_2d` (on CPU tensors, their plain versions) to the
Flax GRU2D and FlowHead2D through the weight bridge. The kernels themselves
run only on a card: tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from camliflow_tpu.models import raft as jraft
from camliflow_tpu.ops import pallas_update2d as jpallas
from camliflow_tpu.ops.pallas_update2d import update_2d_pallas
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_torch.models import raft as traft
from camliflow_torch.ops import update2d
from camliflow_torch.runtime.checkpoint import relayout
from camliflow_torch.runtime.names import translate_suffix

torch.set_num_threads(2)

CONV_TOL = 1e-4  # max|kernel - plain| <= CONV_TOL * (1 + max|plain|), as on the card


def low_bits(x: torch.Tensor) -> torch.Tensor:
    """The 13 mantissa bits a tf32 value leaves zero."""
    return x.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_round_is_cvt_rna():
    """Nearest of the 10-bit mantissas, ties away from zero, in the
    exponent's own scale; tf32 values are fixed points."""
    one = 1.0
    ulp = 2.0 ** -10  # tf32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, -0.0, 2.0 ** -130, 1e30], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, -0.0, 2.0 ** -130,
                         float(np.float32(1e30))], dtype=torch.float32)
    got = update2d.tf32_round(x)
    assert torch.equal(low_bits(got), torch.zeros_like(low_bits(got)))
    assert torch.equal(got[:5], want[:5]) and got[5].item() == 0.0
    assert got[6] == want[6]  # a subnormal with zero low bits stays
    assert abs(got[7].item() / 1e30 - 1) < 2 ** -11
    assert torch.equal(update2d.tf32_round(got), got)


def update_modules(seed):
    torch.manual_seed(seed)
    return {"me": traft.MotionEncoder2D(corr_channels=36), "gru": traft.GRU2D(),
            "head": traft.FlowHead2D()}


@pytest.mark.parametrize("module,key", [("me", "conv_c1"), ("me", "conv_c2"), ("me", "conv"),
                                        ("gru", "zr1"), ("gru", "q2"), ("head", "head1"),
                                        ("head", "head2")])
def test_pack_convs_tf32_planes_reconstruct_the_weight(module, key):
    """hi and lo are tf32 values, K-major ([N_pad, K_pad], the f32 weight
    transposed), zero in the padding, and hi + lo is the weight to 2^-21
    relative."""
    modules = update_modules(50)
    prepare = {"me": update2d.prepare_motion_encoder_params,
               "gru": update2d.prepare_gru_params,
               "head": update2d.prepare_flow_head_params}[module]
    conv = prepare(modules[module])[key]
    k = conv.kh * conv.kw * conv.cin
    assert conv.hi.shape == conv.lo.shape == conv.weight.shape[::-1]
    assert conv.hi.is_contiguous() and conv.lo.is_contiguous()
    assert conv.hi.shape[0] % 64 == 0 and conv.hi.shape[1] % 16 == 0
    for plane in (conv.hi, conv.lo):
        assert not low_bits(plane).any()
        assert not plane[conv.cout:].any() and not plane[:, k:].any()
    w = conv.weight.t()[: conv.cout, :k]
    err = (conv.hi[: conv.cout, :k] + conv.lo[: conv.cout, :k] - w).abs()
    assert (err <= 2.0 ** -21 * w.abs()).all()
    assert (conv.lo[: conv.cout, :k].abs() <= 2.0 ** -11 * w.abs()).all()


def emulate_3xtf32(x: torch.Tensor, conv: update2d.PackedConv) -> torch.Tensor:
    """The tile's arithmetic in plain torch: the activations split as the
    kernel splits them, the weights as packed, products of tf32 values
    (exact in f32) summed in f32, the small terms first."""
    k = conv.kh * conv.kw * conv.cin

    def oihw(plane):
        return plane[: conv.cout, :k].reshape(conv.cout, conv.kh, conv.kw, conv.cin).permute(
            0, 3, 1, 2)

    x_hi, x_lo = (t.permute(0, 3, 1, 2) for t in update2d.split_tf32(x))
    pad = ((conv.kh - 1) // 2, (conv.kw - 1) // 2)
    w_hi, w_lo = oihw(conv.hi), oihw(conv.lo)
    out = F.conv2d(x_lo, w_hi, padding=pad) + F.conv2d(x_hi, w_lo, padding=pad)
    out = out + F.conv2d(x_hi, w_hi, padding=pad) + conv.bias[: conv.cout, None, None]
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("kh,kw,cin,cout", [
    (3, 3, 256, 192),  # conv_c2, K = 2304
    (3, 3, 256, 2),  # the flow head's last conv, K = 2304
    (1, 5, 384, 256),  # the GRU's z|r, K = 1920
    (5, 1, 384, 128),  # its q, K = 1920
])
def test_3xtf32_emulation_meets_the_card_tolerance(kh, kw, cin, cout):
    """At the flagship's reductions the split product stays within the card
    tests' tolerance of the f32 convolution (and 1xTF32 would not come
    close: the split is what buys the exact path)."""
    torch.manual_seed(51)
    conv = update2d.pack_convs(torch.nn.Conv2d(cin, cout, (kh, kw)))
    rng = np.random.RandomState(52)
    x = torch.from_numpy(rng.randn(1, 12, 16, cin).astype(np.float32))
    ref = update2d.conv_plain(x, conv)
    limit = CONV_TOL * (1.0 + float(ref.abs().max()))
    err_3x = float((emulate_3xtf32(x, conv) - ref).abs().max())
    one_term = F.conv2d(update2d.tf32_round(x).permute(0, 3, 1, 2),
                        update2d.tf32_round(conv.oihw()), conv.bias[: conv.cout],
                        padding=((kh - 1) // 2, (kw - 1) // 2)).permute(0, 2, 3, 1)
    err_1x = float((one_term - ref).abs().max())
    assert err_3x <= limit / 10, (err_3x, limit)
    assert err_3x < err_1x / 20, (err_3x, err_1x)


def flax_block(block, seed, *args):
    variables = block.init(jax.random.PRNGKey(seed), *args)
    flat = tree_to_flat(jax.tree.map(np.asarray, variables))
    return flat, flat_to_tree(flat)


def load_block(module, flat):
    """Carry a standalone Flax block's flat variables into its port."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    state = {}
    for path, value in flat.items():
        key = translate_suffix(path.split("/", 1)[1])
        value = np.asarray(value, np.float32)
        if path.endswith("/kernel"):
            value = relayout(value, shapes[key])
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def hidden_inputs():
    rng = np.random.RandomState(53)
    shape = (2, 7, 9)
    return {"h": np.tanh(rng.randn(*shape, 32)).astype(np.float32),
            "x2d": np.maximum(rng.randn(*shape, 32), 0).astype(np.float32),
            "motion": rng.randn(*shape, 32).astype(np.float32)}


def test_gru_2d_matches_flax(hidden_inputs):
    """The GRU half on CPU tensors (its plain version, the inputs' virtual
    concat made real) against the Flax GRU2D on the same weights."""
    c = hidden_inputs
    x = np.concatenate([c["x2d"], c["motion"]], -1)
    block = jraft.GRU2D(hidden_dim=32)
    flat, tree = flax_block(block, 54, jnp.asarray(c["h"]), jnp.asarray(x))
    ref = np.asarray(block.apply(tree, jnp.asarray(c["h"]), jnp.asarray(x)))
    port = load_block(traft.GRU2D(hidden_dim=32, input_dim=64), flat)
    params = update2d.prepare_gru_params(port)
    got = update2d.gru_2d(*(torch.from_numpy(c[k]) for k in ("h", "x2d", "motion")), params)
    assert got.shape == (2, 7, 9, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_flow_head_2d_matches_flax(hidden_inputs):
    """The flow-head half on CPU tensors against the Flax FlowHead2D."""
    h = hidden_inputs["h"]
    block = jraft.FlowHead2D(hidden_dim=64)
    flat, tree = flax_block(block, 55, jnp.asarray(h))
    ref = np.asarray(block.apply(tree, jnp.asarray(h)))
    port = load_block(traft.FlowHead2D(input_dim=32, hidden_dim=64), flat)
    got = update2d.flow_head_2d(torch.from_numpy(h), update2d.prepare_flow_head_params(port))
    assert got.shape == (2, 7, 9, 2)
    assert np.abs(ref).max() > 1e-2  # the comparison is not of near-zeros
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_halves_in_sequence_are_gru_flowhead_2d(hidden_inputs):
    """gru_flowhead_2d is gru_2d then flow_head_2d, bit for bit on the CPU."""
    modules = update_modules(56)
    rng = np.random.RandomState(57)
    h, x2d, motion = (torch.from_numpy(rng.randn(1, 5, 13, 128).astype(np.float32))
                      for _ in range(3))
    gf = update2d.prepare_gru_flowhead_params(modules["gru"], modules["head"])
    h_ref, d_ref = update2d.gru_flowhead_2d(h, x2d, motion, gf)
    h_got = update2d.gru_2d(h, x2d, motion, update2d.prepare_gru_params(modules["gru"]))
    d_got = update2d.flow_head_2d(h_got, update2d.prepare_flow_head_params(modules["head"]))
    assert torch.equal(h_got, h_ref) and torch.equal(d_got, d_ref)


def emulate_update_2d(h, x2d, flow, corr, me, gf):
    """Kernel #10's nine convolutions, each as `emulate_3xtf32` (conv_f1
    stays an f32 F.conv2d, as in the wrapper), with the kernel's epilogues."""
    relu, cat = torch.relu, torch.cat
    cf = relu(emulate_3xtf32(relu(emulate_3xtf32(corr, me["conv_c1"])), me["conv_c2"]))
    ff = relu(emulate_3xtf32(update2d._conv_f1(flow, me), me["conv_f2"]))
    out = torch.nan_to_num(relu(emulate_3xtf32(cat([cf, ff], -1), me["conv"])))
    motion = cat([out, flow], -1)
    hidden = h.shape[-1]
    for zr, q in (("zr1", "q1"), ("zr2", "q2")):
        gates = torch.sigmoid(emulate_3xtf32(cat([h, x2d, motion], -1), gf[zr]))
        z, r = gates[..., :hidden], gates[..., hidden:]
        h = (1 - z) * h + z * torch.tanh(emulate_3xtf32(cat([r * h, x2d, motion], -1), gf[q]))
    h = torch.nan_to_num(h)
    mid = relu(emulate_3xtf32(h, gf["head1"]))
    return h, torch.nan_to_num(emulate_3xtf32(mid, gf["head2"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_emulation_of_the_raft_iteration_meets_the_card_tolerance(seed):
    """The whole RAFT iteration with every conv split as the tile splits it
    stays within the card tests' bound of the f32 chain (update_2d_plain),
    and within the split kernels' tolerances of the Pallas kernel (bf16
    operands, interpret mode) at 2 x 7 x 9, corr 36."""
    rng = np.random.RandomState(70 + seed)
    shape = (2, 7, 9)
    c = {"flow": 2 * rng.randn(*shape, 2), "corr": rng.randn(*shape, 36),
         "h": np.tanh(rng.randn(*shape, 128)), "x2d": np.maximum(rng.randn(*shape, 128), 0)}
    c = {k: np.asarray(v, np.float32) for k, v in c.items()}
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    flat_me, tree_me = flax_block(jraft.MotionEncoder2D(), 71 + seed, jc["flow"], jc["corr"])
    motion = jraft.MotionEncoder2D().apply(tree_me, jc["flow"], jc["corr"])
    flat_gru, tree_gru = flax_block(jraft.GRU2D(), 73 + seed, jc["h"],
                                    jnp.concatenate([jc["x2d"], motion], -1))
    flat_head, tree_head = flax_block(jraft.FlowHead2D(), 75 + seed, jc["h"])
    me, gf = update2d.prepare_update_2d_params(
        load_block(traft.MotionEncoder2D(corr_channels=36), flat_me),
        load_block(traft.GRU2D(), flat_gru), load_block(traft.FlowHead2D(), flat_head))
    args = [torch.from_numpy(c[k]) for k in ("h", "x2d", "flow", "corr")]
    with torch.inference_mode():
        got = emulate_update_2d(*args, me, gf)
        plain = update2d.update_2d_plain(*args, me, gf)
    pallas = [np.asarray(a) for a in update_2d_pallas(
        jc["h"], jc["x2d"], jc["flow"], jc["corr"],
        jpallas.prepare_motion_encoder_params(tree_me["params"]),
        jpallas.prepare_gru_flowhead_params(tree_gru["params"], tree_head["params"]), 7, 9,
        interpret=True)]
    assert np.abs(plain[1].numpy()).max() > 1e-2  # not a comparison of near-zeros
    for g, p, q, atol in zip(got, plain, pallas, (3e-2, 6e-2)):
        err = float((g - p).abs().max())
        assert err <= CONV_TOL * (1.0 + float(p.abs().max())), err
        np.testing.assert_allclose(g.numpy(), q, rtol=0, atol=atol)
