"""PyTorch port, #6's and #7's int8 forms (CAMLIFLOW_UPDATE3D=1) on bf16
tables, on the CPU: their division of work, and what the wrappers hand
their kernels.

csrc/update3d.cu's #6 and #7 take their int8 form as their bf16 form does:
every gathered table is written once in bf16 by its producer (the
activation applied in f32, then one rounding), and a tail reads a lane's 8
(or 4) channels of table as bf16 words and of int8 weights in one 8- (or
4-) byte load, then, after the group's loads, widens each pair of weights
exactly into a bf16x2 word (`int8_words`: the byte biased by 128 as the
low byte of 2^23 + (w + 128) in f32, less 2^23 + 128, whose high half is
w's bf16) for `mul.rn.bf16x2`. The tail is held bit for bit to
`dw_max_plain` on int8 weights (the oracle the kernels are held to on the
card) and, up to the sign of a zero maximum, to the Pallas kernels'
`_dw_conv` on int8 weights in interpret mode. The kernels themselves run
only on a card: tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from camliflow_tpu.ops.pallas_update3d import _dw_conv
from camliflow_torch.ops import update3d
from test_torch_update3d import fake_card, kernel_layout_floats, me_inputs  # noqa: F401
from test_torch_update3d_bf16 import (
    bf16_source_floats,
    bf16_words,
    cloud,
    emulated_tail,
    gf_inputs,
)

torch.set_num_threads(2)

N, C = 64, 24


@pytest.fixture(autouse=True)
def forward_only():
    with torch.no_grad():
        yield


def int8_words(w: torch.Tensor) -> torch.Tensor:
    """int8 weights [..., C] (C even) as the int8 tail widens them: each byte
    xor 0x80 in the low byte of 0x4B000000, as f32 less 8388736 (2^23 + 128),
    its high half the bf16; channel 2i in word i's low half (int64 words)."""
    biased = (w.to(torch.int32) & 0xFF) ^ 0x80
    f = (biased | 0x4B000000).view(torch.float32) - torch.tensor(8388736.0)
    bits = (f.view(torch.int32) >> 16).to(torch.int64) & 0xFFFF
    return bits[..., 0::2] | (bits[..., 1::2] << 16)


def quantized(dw: np.ndarray) -> torch.Tensor:
    """A cloud's weights as int8 (NaN to 0; the runs of +-0 stay 0, so a
    product's sign is the table's), at the scale of JAX's quantisation."""
    q = np.nan_to_num(dw, nan=0.0) * 127.0 / np.nanmax(np.abs(dw))
    return torch.from_numpy(np.clip(np.rint(q), -127, 127).astype(np.int8))


def test_int8_words_are_the_bf16_values_exactly():
    """Every int8 value, -128 included, widens to its own bf16 bits."""
    w = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    assert torch.equal(int8_words(w), bf16_words(w.to(torch.bfloat16)))


@pytest.mark.parametrize("act,k,group", [(None, 4, 8), ("leaky_relu", 32, 8),
                                         ("leaky_relu", 13, 8)])
def test_int8_tail_on_bf16_tables_is_the_plain_and_the_pallas_tail(act, k, group):
    """GRU3D's z|r and q (k = 4, no activation) and FlowHead3D's conv1 and
    conv2 (k = 32, leaky ReLU), and a k no multiple of the group: the int8
    tail on a bf16 table bit for bit `dw_max_plain` on the int8 weights, NaN
    rows, ties over repeated neighbours and signed zero maxima included, and
    the Pallas kernels' `_dw_conv` on the same int8 weights."""
    _, knn_idx, feats, dw = cloud(70 + k, k)
    rng = np.random.default_rng(k)
    dense = rng.standard_normal((7, C)).astype(np.float32)
    pre = torch.from_numpy(feats @ dense)  # a NaN input row: a NaN table row
    pre[0, 9] = 0.0  # a zero table row: zero products, the sign the weights'
    pre[0, 21] = -pre[0, 21].abs()  # a negative row: -0 products against zero weights
    idx_t, w8 = torch.from_numpy(knn_idx), quantized(dw)
    got = emulated_tail(pre, act is not None, idx_t, w8, group, words=int8_words)
    table = F.leaky_relu(pre, 0.1) if act else pre
    plain = update3d.dw_max_plain(table, idx_t, w8)
    nan = torch.isnan(plain)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), plain[~nan].view(torch.int32))
    assert ((plain == 0) & torch.signbit(plain)).any()  # a -0 maximum, the earlier zero's
    # the same int8 form against its bf16 widening: the same bits
    as_bf16 = emulated_tail(pre, act is not None, idx_t, w8.to(torch.bfloat16), group)
    assert torch.equal(torch.isnan(as_bf16), nan)
    assert torch.equal(got[~nan].view(torch.int32), as_bf16[~nan].view(torch.int32))

    def kernel(table_ref, idx_ref, dw_ref, out_ref):
        out_ref[...] = _dw_conv(table_ref[...], idx_ref, dw_ref, k)

    table16 = jnp.asarray(table.numpy()).astype(jnp.bfloat16)[0]
    dw_km = jnp.transpose(jnp.asarray(w8.numpy()), (0, 2, 1, 3))  # int8, kernel layout
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((N, C), jnp.bfloat16),
                         interpret=True)(table16, jnp.asarray(knn_idx), dw_km)
    out = np.asarray(out.astype(jnp.float32))
    assert np.array_equal(np.isnan(out), nan[0].numpy())
    assert np.array_equal(out[~nan[0].numpy()], got[0][~nan[0]].numpy())  # -0 == +0


@pytest.mark.parametrize("batch,n", [(1, 2048), (2, 100), (1, 37)])
def test_gru_flowhead_3d_int8_scratch_holds_bf16_tables(fake_card, batch, n):
    """#7's int8 form: the wrapper hands the kernel its dtype (2) and the
    bf16 form's scratch, q_xm, z and r*h in f32, then the tables of z|r, q,
    conv1 and conv2 in bf16: 672 floats a point (960 before, f32 tables),
    the entry point's own `need`."""
    launches, made = fake_card
    inputs, dw, params = gf_inputs(batch, n, torch.int8)
    packed = {key: (conv._replace(bf16=True, hi=conv.hi, lo=None) if conv.hi is not None
                    else conv._replace(bf16=True)) for key, conv in params.items()}
    update3d.gru_flowhead_3d(*inputs, dw, packed)
    (name, args), = launches
    assert name == "camli_gru_flowhead_3d" and args[18] == 2  # DW_INT8
    per_point = args[-1]
    assert per_point == 672 == bf16_source_floats(
        "camli_gru_flowhead_3d", c_h=128, c_1=128, c_2=64)
    scratch = next(t for t in made if t.data_ptr() == args[15])
    assert scratch.numel() == batch * n * per_point


def test_int8_form_takes_widths_of_whole_bf16_rows(fake_card):
    """Its tables are bf16, read 8 channels a load: a conv2 of 60 channels
    takes the f32 form, not the int8 one."""
    launches, _ = fake_card
    inputs, dw, params = gf_inputs(1, 50, torch.int8)
    packed = {key: conv._replace(bf16=True, lo=None) for key, conv in params.items()}
    narrow = {**packed, "conv2": packed["conv2"]._replace(cout=60),
              "fc": packed["fc"]._replace(cin=60)}
    ws = {**dw, "conv2": torch.zeros(1, 50, 32, 60, dtype=torch.int8)}
    with pytest.raises(ValueError, match="multiples of 8"):
        update3d.gru_flowhead_3d(*inputs, ws, narrow)
    assert not launches


# --- #6·int8 on bf16 tables, and the int8 word products ---------------------


def test_int8_word_products_are_exact_or_rounded_once():
    """Every int8 value widens to its own bf16 word (`int8_words`), and its
    product with a bf16 value (normal, subnormal, up to the largest) under
    `mul.rn.bf16x2` is the exact product rounded to bf16 once: the f64
    product has at most 15 significant bits, exact in f32 wherever it is
    finite, rounded to bf16 as the bf16 product is, and inf past bf16's
    range. Rounding is monotone and takes no nonzero product to zero, so
    the max of the rounded products has the bits of the max of the exact
    ones rounded once, zero signs and NaN included."""
    w = torch.arange(-128, 128, dtype=torch.int8)
    bits = int8_words(w.reshape(128, 2))
    lo, hi = (bits & 0xFFFF).to(torch.int32), (bits >> 16).to(torch.int32)
    w16 = (torch.stack([lo, hi], dim=-1).flatten() << 16).view(torch.float32)
    assert torch.equal(w16, w.float())
    exps = torch.arange(-133, 128, dtype=torch.float64)
    mant = torch.arange(128, 256, 7, dtype=torch.float64) / 128
    t = (mant[:, None] * torch.exp2(exps)[None]).flatten()
    t = torch.cat([t, -t, torch.exp2(torch.arange(-133, -126, dtype=torch.float64))])
    t16 = t.float().bfloat16().float()  # bf16 values, subnormals among them
    assert (t16.abs() < 2.0**-126).any() and (t16 != 0).all()
    prod = (t16.bfloat16()[:, None] * w16.bfloat16()[None]).float()
    exact = t16.double()[:, None] * w.double()[None]
    finite = exact.abs() <= torch.finfo(torch.float32).max
    assert torch.equal(exact[finite].float().double(), exact[finite])
    once = exact.float().bfloat16().float()
    assert torch.equal(prod.view(torch.int32), once.view(torch.int32))
    assert torch.isinf(prod[~finite]).all()


def test_int8_word_tail_takes_subnormals_and_overflow():
    """#6's f1 (k = 32, leaky ReLU): the shipped word tail on a bf16 table
    with bf16-subnormal values and products past f32's range, beside NaN
    rows, ties over repeated neighbours and signed zero maxima: bit for bit
    `dw_max_plain` on the int8 weights, and the Pallas kernels' `_dw_conv`
    in interpret mode up to the sign of a zero maximum. XLA on the CPU
    flushes subnormals to zero: there the Pallas tail is this tail on the
    table with its subnormals flushed to signed zeros."""
    k, group = 32, 8
    _, knn_idx, feats, dw = cloud(70 + k, k)
    rng = np.random.default_rng(k)
    pre = torch.from_numpy(feats @ rng.standard_normal((7, C)).astype(np.float32))
    pre[0, 9] = 0.0
    pre[0, 21] = -pre[0, 21].abs()
    pre[0, 12] = torch.from_numpy(rng.integers(1, 128, C) * rng.choice([-1.0, 1.0], C)
                                  * 2.0**-133).float()  # bf16 subnormals (leaky: * 0.1)
    pre[0, 14, ::3] = 3.0e38  # times 127 past f32's largest value: inf
    knn_idx[0, 40] = 12  # every neighbour the subnormal row, at weights of +-1:
    idx_t, w8 = torch.from_numpy(knn_idx), quantized(dw)
    w8[0, 40] = torch.from_numpy(rng.choice([-1, 1], (k, C)).astype(np.int8))  # subnormal maxima
    got = emulated_tail(pre, True, idx_t, w8, group, words=int8_words)
    table = F.leaky_relu(pre, 0.1)
    assert ((table[0, 12].bfloat16().float().abs() < 2.0**-126)
            & (table[0, 12].bfloat16() != 0)).all()
    plain = update3d.dw_max_plain(table, idx_t, w8)
    nan = torch.isnan(plain)
    assert nan.any() and torch.isinf(plain).any() and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), plain[~nan].view(torch.int32))
    assert ((plain == 0) & torch.signbit(plain)).any()
    assert ((plain != 0) & (plain.abs() < 2.0**-126)).any()  # a subnormal maximum

    def kernel(table_ref, idx_ref, dw_ref, out_ref):
        out_ref[...] = _dw_conv(table_ref[...], idx_ref, dw_ref, k)

    table16 = jnp.asarray(table.numpy()).astype(jnp.bfloat16)[0]
    dw_km = jnp.transpose(jnp.asarray(w8.numpy()), (0, 2, 1, 3))
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((N, C), jnp.bfloat16),
                         interpret=True)(table16, jnp.asarray(knn_idx), dw_km)
    out = np.asarray(out.astype(jnp.float32))
    t16 = table.bfloat16().float()
    flushed = torch.where(t16.abs() < 2.0**-126, t16 * 0.0, t16)
    want = emulated_tail(flushed, False, idx_t, w8, group, words=int8_words)[0].numpy()
    assert np.array_equal(np.isnan(out), np.isnan(want))
    assert np.array_equal(out[~np.isnan(out)], want[~np.isnan(want)])  # -0 == +0


@pytest.mark.parametrize("batch,n", [(1, 2048), (2, 100), (1, 37)])
def test_motion_encoder_3d_int8_scratch_holds_bf16_tables(fake_card, batch, n):
    """#6's int8 form: the wrapper hands the kernel its dtype (2) and the
    bf16 form's scratch, corr_feat and flow_feat in f32, then the tables of
    c1, f1, f2 and the merge (rows of 128) in bf16: 296 floats a point (448
    before, f32 tables), the entry point's own `need`."""
    launches, made = fake_card
    flow, corr, knn_idx, dw, params = me_inputs(batch, n, 32)
    dw8 = {key: update3d.padded_rows(torch.zeros(w.shape, dtype=torch.int8))
           for key, w in dw.items()}
    assert dw8["conv"].stride()[2:] == (128, 1)
    update3d.motion_encoder_3d(flow, corr, knn_idx, dw8, bf16_packings(params))
    (name, args), = launches
    assert name == "camli_motion_encoder_3d" and args[14] == 2  # DW_INT8
    per_point = args[-1]
    assert per_point == 296 == kernel_layout_floats(128, 32, 16, 125, bf16=True)
    scratch = next(t for t in made if t.data_ptr() == args[12])
    assert scratch.numel() == batch * n * per_point


def bf16_packings(params: dict) -> dict:
    """f32 packings relabelled as the int8 form's bf16 ones (values unread:
    nothing runs), their tile planes one plane."""
    return {key: conv._replace(bf16=True, lo=None) for key, conv in params.items()}


@pytest.mark.parametrize("case", ["f1 36", "f2 12", "f1 misaligned", "f2 misaligned"])
def test_motion_encoder_3d_int8_takes_whole_bf16_rows(fake_card, case):
    """#6's int8 form reads bf16 tables 8 channels a load: f1 and f2 widths
    that are multiples of 4 but not of 8 are refused (the f32 form takes
    them), and its f1 and f2 tails read up to 8 int8 weights in one 8-byte
    load: weights 4 bytes past an 8-byte boundary are refused (bf16 weights
    there are taken: 4-byte loads). Each refusal says why; none launches."""
    launches, _ = fake_card
    flow, corr, knn_idx, dw, params = me_inputs(1, 50, 32)
    if case.endswith("misaligned"):
        key = "conv_f1" if case.startswith("f1") else "conv_f2"
        forms = {}
        for dtype in (torch.int8, torch.bfloat16):
            ws = {k: update3d.padded_rows(torch.zeros(w.shape, dtype=dtype))
                  for k, w in dw.items()}
            base = torch.zeros(ws[key].numel() + 8, dtype=dtype)
            offset = 4 // ws[key].element_size()  # 4 bytes past an 8-byte boundary
            ws[key] = base[offset:offset + ws[key].numel()].view(ws[key].shape)
            assert ws[key].data_ptr() % 8 == 4
            forms[dtype] = ws
        with pytest.raises(ValueError, match="8-byte aligned"):
            update3d.motion_encoder_3d(flow, corr, knn_idx, forms[torch.int8],
                                       bf16_packings(params))
        assert not launches
        update3d.motion_encoder_3d(flow, corr, knn_idx, forms[torch.bfloat16], params)
        assert len(launches) == 1
        return
    width = int(case.split()[1])
    if case.startswith("f1"):
        narrow = {**params, "conv_f1": params["conv_f1"]._replace(cout=width),
                  "conv_f2": params["conv_f2"]._replace(cin=width)}
        shapes = {"conv_f1": (1, 50, 32, width)}
    else:
        narrow = {**params, "conv_f2": params["conv_f2"]._replace(cout=width),
                  "conv": params["conv"]._replace(cin=128 + width)}
        shapes = {"conv_f2": (1, 50, 16, width)}
    for dtype, raises in ((torch.int8, True), (torch.float32, False)):
        ws = {k: update3d.padded_rows(torch.zeros(shapes.get(k, w.shape), dtype=dtype))
              for k, w in dw.items()}
        packed = bf16_packings(narrow) if dtype == torch.int8 else narrow
        if raises:
            with pytest.raises(ValueError, match="multiples of 8"):
                update3d.motion_encoder_3d(flow, corr, knn_idx, ws, packed)
            assert not launches
        else:
            update3d.motion_encoder_3d(flow, corr, knn_idx, ws, packed)
            assert len(launches) == 1
