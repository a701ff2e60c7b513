"""PyTorch port, #7's int8 form (CAMLIFLOW_UPDATE3D=1) on bf16 tables, on
the CPU: its division of work, and what the wrapper hands its kernel.

csrc/update3d.cu's #7 takes its int8 form as its bf16 form does: every
gathered table is written once in bf16 by its producer (the activation
applied in f32, then one rounding), and a tail reads a lane's 8 channels of
table as bf16 words and of int8 weights in one 8-byte load. Each int8 pair
becomes a bf16x2 word exactly (`int8_pair_bf16`: the byte biased by 128 as
the low byte of 2^23 + (w + 128) in f32, less 2^23 + 128, whose high half
is w's bf16), then `mul.rn.bf16x2` and the max in neighbour order
(`take_max`). `int8_words` repeats that widening with integer and f32 ops;
the tail on it is held bit for bit to `dw_max_plain` on int8 weights (the
oracle the kernel is held to on the card) and, up to the sign of a zero
maximum, to the Pallas kernels' `_dw_conv` on int8 weights in interpret
mode. The kernel itself runs only on a card: tests/test_torch_kernels_cuda.py.
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
from test_torch_update3d import fake_card  # noqa: F401 (a fixture)
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
