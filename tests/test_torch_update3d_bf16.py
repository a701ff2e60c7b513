"""PyTorch port, the bf16 form of the 3D update chain (#6·bf16, #7·bf16) on
the CPU: its division of work, and what the wrappers hand its kernels.

csrc/update3d.cu's bf16 form keeps every gathered table in bf16: the
table's producer (a dense step's epilogue, an FMA layer) applies the
activation in f32 and rounds once to bf16 (nearest, ties to even); a tail
reads table rows and weights as bf16 words, two channels a 4-byte word,
takes `mul.rn.bf16x2` on the words as loaded, widens the products to f32
and takes the max in neighbour order (`take_max`: the later value only if
it is larger or NaN), a group of rows at a time. `emulated_tail` repeats
that on the CPU; it is held bit for bit to `dw_max_plain` (the oracle the
kernels are held to on the card) and, up to the sign of a zero maximum, to
the JAX package's PointConvDW with `fast=True` and to the Pallas kernels'
`_dw_conv` in interpret mode (XLA's max takes +0 over -0 whatever their
order; torch.amax and the kernels keep the earlier). The kernels
themselves run only on a card: tests/test_torch_kernels_cuda.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from camliflow_tpu.nn.point_conv import PointConvDW
from camliflow_tpu.ops.pallas_update3d import _dw_conv
from camliflow_torch.csrc import update3d_forms
from camliflow_torch.models import camliraft_l as tm
from camliflow_torch.ops import update3d
from test_torch_update3d import (  # noqa: F401
    SOURCE,
    fake_card,
    kernel_layout_floats,
    me_inputs,
    source_constants,
)

torch.set_num_threads(2)

N, C = 64, 24  # points, channels (3 words of 8 channels: 16-byte loads)


@pytest.fixture(autouse=True)
def forward_only():
    with torch.no_grad():
        yield


def bf16_words(x: torch.Tensor) -> torch.Tensor:
    """bf16 values [..., C] (C even) as the kernels load them: int64 words
    [..., C / 2], channel 2i in word i's low half."""
    bits = x.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    return bits[..., 0::2] | (bits[..., 1::2] << 16)


def halves(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two bf16 values of each word, widened to f32 exactly."""
    lo = ((words & 0xFFFF) << 16).to(torch.int32).view(torch.float32)
    hi = (words & 0xFFFF0000).to(torch.int32).view(torch.float32)
    return lo, hi


def mul_bf16x2(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`mul.rn.bf16x2` on words, widened: each product of two bf16 values is
    exact in f32, then rounded once to bf16 (nearest, ties to even)."""
    (a0, a1), (b0, b1) = halves(a), halves(b)
    return ((a0 * b0).bfloat16().float(), (a1 * b1).bfloat16().float())


def take_max(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where((v > m) | torch.isnan(v), v, m)


def emulated_tail(pre: torch.Tensor, leaky: bool, knn_idx: torch.Tensor, dw: torch.Tensor,
                  group: int, kmax: int = 32, words=bf16_words) -> torch.Tensor:
    """The bf16 form's division of work: the producer applies the activation
    to the f32 table `pre` and rounds it to bf16; the tail takes the point's
    neighbours in rounds of `kmax`, each in groups of `group` rows (the rows
    a lane keeps in flight), multiplies the words and keeps the max in
    neighbour order. pre [B, N, C], knn_idx [B, M, >= k], dw [B, M, k, C]
    bf16 (or int8, with `words` the int8 form's widening) -> [B, M, C] f32."""
    table = bf16_words((F.leaky_relu(pre, 0.1) if leaky else pre).bfloat16())
    weights = words(dw)
    k = dw.shape[2]
    m = None
    for jb in range(0, k, kmax):
        for j0 in range(jb, min(jb + kmax, k), group):
            for j in range(j0, min(j0 + group, k)):
                rows = torch.stack([table[b, knn_idx[b, :, j].long()]
                                    for b in range(table.shape[0])])
                lo, hi = mul_bf16x2(rows, weights[:, :, j])
                x = torch.stack([lo, hi], dim=-1).flatten(-2)  # channels back in order
                m = x if m is None else take_max(m, x)
    return m


def cloud(seed: int, k: int):
    """Points, a knn list with repeated neighbours, an input with a NaN row,
    and hoisted weights with NaN and runs of +0 and -0: ties among equal
    products, zero maxima whose sign is the tie rule's, NaN from the table
    and from the weights."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((1, N, 3)).astype(np.float32)
    knn_idx = np.argsort(((xyz[0, :, None] - xyz[0, None]) ** 2).sum(-1), axis=1)[None, :, :k]
    knn_idx = knn_idx.astype(np.int32)
    knn_idx[:, ::5, k - 1] = knn_idx[:, ::5, 0]  # a neighbour twice
    feats = rng.standard_normal((1, N, 7)).astype(np.float32)
    feats[0, 3] = np.nan  # its table row is NaN
    feats[0, 9] = 0.0  # its table row is the bias (zero below)
    dw = rng.standard_normal((1, N, k, C)).astype(np.float32)
    dw[0, 2::7, :, 1::4] = 0.0
    dw[0, 2::7, ::2, 1::4] = -0.0  # all-zero products: the max is a signed zero
    dw[0, 11, k // 2, 5] = np.nan
    dw[0, 17, :, 6] = dw[0, 17, 0, 6]  # equal weights over a repeated neighbour
    return xyz, knn_idx, feats, dw


@pytest.mark.parametrize("act,k,group", [("leaky_relu", 13, 8), (None, 4, 8),
                                         ("leaky_relu", 40, 32)])
def test_emulated_bf16_tail_is_the_plain_and_the_jax_fast_tail(act, k, group):
    """k = 13 and 40 are no multiple of the groups (8 rows of 16-byte loads;
    32 of 4-byte ones), 40 takes two rounds of 32; act None is GRU3D's z|r
    and q, leaky ReLU every other conv's."""
    xyz, knn_idx, feats, dw = cloud(60 + k, k)
    conv = PointConvDW(C, act=act, k=k)
    variables = conv.init(jax.random.PRNGKey(k), jnp.asarray(xyz), jnp.asarray(feats),
                          knn_indices=jnp.asarray(knn_idx), weights=jnp.asarray(dw))
    dense = variables["params"]["mlp"]["DenseNormAct_0"]["Dense_0"]
    dense["bias"] = jnp.zeros_like(dense["bias"])  # a zero input row: a zero table row
    # the MLP before its activation: the same Dense without one
    pre = PointConvDW(C, act=None, k=k).apply(variables, jnp.asarray(feats),
                                              method=lambda m, x: m.mlp(x))
    ref = conv.apply(variables, jnp.asarray(xyz), jnp.asarray(feats),
                     knn_indices=jnp.asarray(knn_idx), weights=jnp.asarray(dw), fast=True)

    pre_t, idx_t = torch.from_numpy(np.array(pre)), torch.from_numpy(knn_idx)
    dw16 = torch.from_numpy(dw).bfloat16()
    got = emulated_tail(pre_t, act is not None, idx_t, dw16, group)
    table = F.leaky_relu(pre_t, 0.1) if act else pre_t
    plain = update3d.dw_max_plain(table, idx_t, dw16)
    assert got.dtype == plain.dtype == torch.float32
    nan = torch.isnan(plain)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), plain[~nan].view(torch.int32))
    zeros = (plain == 0) & torch.signbit(plain)
    assert zeros.any()  # a -0 maximum: the earlier of the tied zeros

    # the JAX package: PointConvDW with fast=True, and the Pallas kernels'
    # _dw_conv in interpret mode on the bf16 table, in kernel layout
    ref = np.asarray(ref)
    assert np.array_equal(np.isnan(ref), nan.numpy())
    assert np.array_equal(ref[~nan.numpy()], got[~nan].numpy())  # -0 == +0

    def kernel(table_ref, idx_ref, dw_ref, out_ref):
        out_ref[...] = _dw_conv(table_ref[...], idx_ref, dw_ref, k)

    table16 = jnp.asarray(table.numpy()).astype(jnp.bfloat16)[0]
    dw_km = jnp.transpose(jnp.asarray(dw), (0, 2, 1, 3)).astype(jnp.bfloat16)
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((N, C), jnp.bfloat16),
                         interpret=True)(table16, jnp.asarray(knn_idx), dw_km)
    out = np.asarray(out.astype(jnp.float32))
    assert np.array_equal(np.isnan(out), nan[0].numpy())
    assert np.array_equal(out[~nan[0].numpy()], got[0][~nan[0]].numpy())


def bf16_source_floats(entry: str, **widths) -> int:
    """The floats a point of an entry point's scratch must hold in the bf16
    form, by its own check in csrc/update3d.cu (`need`'s first branch)."""
    at = SOURCE[SOURCE.index(f'extern "C" int {entry}('):]
    tables = re.search(r"const int need = tb \? ([^:]+):", at).group(1)
    return eval(tables.strip().replace("/", "//"), {"__builtins__": {}}, widths)


def gf_inputs(batch, n, dtype=torch.bfloat16):
    gru, head = tm.GRU3D(), tm.FlowHead3D()
    params = update3d.prepare_gru_flowhead_3d_params(gru, head)
    widths = (256, 128, 128, 64)
    dw = {key: torch.zeros(batch, n, k, c, dtype=dtype)
          for key, k, c in zip(update3d.GF_DW, (4, 4, 32, 32), widths)}
    h = torch.zeros(batch, n, 128)
    knn_idx = torch.zeros(batch, n, 32, dtype=torch.int32)
    return (h, h.clone(), h.clone(), knn_idx), dw, params


@pytest.mark.parametrize("batch,n", [(1, 2048), (2, 100), (1, 37)])
def test_gru_flowhead_3d_bf16_scratch_holds_bf16_tables(fake_card, batch, n):
    """#7's bf16 form: the wrapper hands the kernel its dtype (1) and a
    scratch of the kernel's bf16 layout, q_xm, z and r*h in f32, then the
    tables of z|r, q, conv1 and conv2 in bf16 (672 floats a point against
    the f32 form's 960), every part 16-byte aligned; the per-point size is
    the entry point's own `need`."""
    launches, made = fake_card
    inputs, dw, params = gf_inputs(batch, n)
    h_out, delta = update3d.gru_flowhead_3d(*inputs, dw, params)
    (name, args), = launches
    assert name == "camli_gru_flowhead_3d" and len(args) == 36
    scratch = next(t for t in made if t.data_ptr() == args[15])
    assert args[18] == 1  # DW_BF16
    per_point = args[-1]
    assert per_point == 672 == bf16_source_floats(
        "camli_gru_flowhead_3d", c_h=128, c_1=128, c_2=64)
    assert scratch.numel() == batch * n * per_point and scratch.dtype == torch.float32
    points = batch * n
    f32_bytes = 4 * np.cumsum([0, 128, 128, 128]) * points
    bf16_bytes = f32_bytes[-1] + 2 * np.cumsum([0, 256, 128, 128, 64]) * points
    assert all(o % 16 == 0 for o in (*f32_bytes, *bf16_bytes))
    assert bf16_bytes[-1] == 4 * scratch.numel()
    # the f32 form, as before: 960 floats a point
    launches.clear()
    inputs, dw32, params = gf_inputs(batch, n, torch.float32)
    update3d.gru_flowhead_3d(*inputs, dw32, params)
    assert launches[0][1][18] == 0 and launches[0][1][-1] == 960


@pytest.mark.parametrize("batch,n,idx_width", [(1, 2048, 32), (2, 100, 33), (1, 70, 40)])
def test_motion_encoder_3d_bf16_scratch_holds_bf16_tables(fake_card, batch, n, idx_width):
    """#6's bf16 form: corr_feat and flow_feat in f32, then the tables of c1,
    f1, f2 and the merge (its rows 128 values apart) in bf16: 296 floats a
    point against the f32 form's 448, every part 16-byte aligned, the size
    the entry point's own `need`."""
    launches, made = fake_card
    flow, corr, knn_idx, dw, params = me_inputs(batch, n, idx_width)
    dw16 = update3d.to_bf16(dw)
    assert dw16["conv"].stride()[2:] == (128, 1)
    update3d.motion_encoder_3d(flow, corr, knn_idx, dw16, params)
    (name, args), = launches
    assert args[14] == 1
    per_point = args[-1]
    assert per_point == 296 == kernel_layout_floats(128, 32, 16, 125, bf16=True)
    scratch = next(t for t in made if t.data_ptr() == args[12])
    assert scratch.numel() == batch * n * per_point
    points = batch * n
    f32_bytes = 4 * np.cumsum([0, 128, 16]) * points
    bf16_bytes = f32_bytes[-1] + 2 * np.cumsum([0, 128, 32, 16, 128]) * points
    assert all(o % 16 == 0 for o in (*f32_bytes, *bf16_bytes))
    assert bf16_bytes[-1] == 4 * scratch.numel()


@pytest.mark.parametrize("channels,f32_pitch,bf16_pitch", [(125, 128, 128), (61, 64, 64),
                                                            (65, 68, 72), (16, 16, 16)])
def test_bf16_rows_are_16_bytes_apart(channels, f32_pitch, bf16_pitch):
    """The bf16 form reads padded rows in 16-byte loads: `row_multiple` is
    8 for bf16 (4 for f32, 16 for int8), `padded_rows` pads to it, and
    `to_bf16` keeps a padded f32 buffer whose pitch already is a multiple of
    8 (the merge conv's 128) and pads the rows again where it is not; the
    values are the f32 values rounded, zeros between."""
    assert [update3d.row_multiple(d) for d in (torch.float32, torch.bfloat16, torch.int8)] == [
        4, 8, 16]
    w = torch.randn(2, 5, 3, channels)
    padded = update3d.padded_rows(w)
    assert padded.stride()[2:] == (f32_pitch, 1)
    w16 = update3d.to_bf16({"conv": padded})["conv"]
    assert w16.dtype == torch.bfloat16 and w16.stride()[2:] == (bf16_pitch, 1)
    assert torch.equal(w16, w.bfloat16())
    buffer = w16.as_strided(w16.shape[:-1] + (bf16_pitch,), w16.stride())
    assert not buffer[..., channels:].float().any()
    assert update3d.padded_rows(w.bfloat16()).stride()[2:] == (bf16_pitch, 1)
    update3d._check_dw("t", {"conv": w16}, ("conv",), 2, 5, w16.device, padded=("conv",))
    if bf16_pitch != f32_pitch:  # the f32 pitch alone no longer does for bf16
        stale = padded.as_strided(padded.shape[:-1] + (f32_pitch,), padded.stride())
        stale = stale.bfloat16()[..., :channels]
        with pytest.raises(ValueError, match=f"{bf16_pitch} .* apart"):
            update3d._check_dw("t", {"conv": stale}, ("conv",), 2, 5, w16.device,
                               padded=("conv",))


def test_bf16_form_raises_where_its_kernels_would_fault(fake_card):
    """bf16 tables are read in 16-byte rows: #7's widths must be multiples of
    8 (a conv2 of 60 channels takes the f32 form, not the bf16 one); #6's f1
    and f2 tails read 4-byte words, so their bf16 weights must be 4-byte
    aligned (the f32 form's may sit anywhere)."""
    launches, _ = fake_card
    inputs, dw, params = gf_inputs(1, 50)
    narrow = {**params, "conv2": params["conv2"]._replace(cout=56 + 4),
              "fc": params["fc"]._replace(cin=60)}
    for dtype, raises in ((torch.bfloat16, True), (torch.float32, False)):
        ws = {**{k: v.to(dtype) for k, v in dw.items()},
              "conv2": torch.zeros(1, 50, 32, 60, dtype=dtype)}
        if raises:
            with pytest.raises(ValueError, match="multiples of 8"):
                update3d.gru_flowhead_3d(*inputs, ws, narrow)
        else:
            update3d.gru_flowhead_3d(*inputs, ws, narrow)
    assert len(launches) == 1
    flow, corr, knn_idx, dw_me, me = me_inputs(1, 50, 32)
    dw16 = update3d.to_bf16(dw_me)

    def shifted(t):  # 2 bytes past a 4-byte boundary
        base = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        return base.copy_(t)

    for key in ("conv_f1", "conv_f2"):
        with pytest.raises(ValueError, match="4-byte aligned"):
            update3d.motion_encoder_3d(flow, corr, knn_idx, {**dw16, key: shifted(dw16[key])}, me)
    assert len(launches) == 1


@pytest.mark.parametrize("form", sorted(update3d_forms.FORMS))
def test_update3d_forms_patch_the_shipped_source(form):
    """Each form `python -m camliflow_torch.csrc.update3d_forms` builds
    finds each text it replaces in csrc/update3d.cu exactly once, so a form
    changes the one place it names (the wave a tail reads, a load, the
    launch bounds) and not another."""
    for old, _ in update3d_forms.FORMS[form]:
        assert SOURCE.count(old) == 1, (form, old[:60])


def dw_max_word_lanes(channels: int) -> int:
    """The lanes across the channels (8 channels a lane) csrc/update3d.cu's
    `camli_dw_max` gives its bf16 form on packed words at `channels`, by its
    own dispatch; the warp's 32 / lanes lane groups split the neighbours."""
    entry = SOURCE[SOURCE.index('extern "C" int camli_dw_max('):]
    start = entry.index("c % 8 == 0")  # the rule: one return statement
    rule = entry[start:entry.index(";", start)]
    for most, lanes in re.findall(r"c <= (\d+)\s*\?\s*launch_dw_max_words<(\d+)>", rule):
        if channels <= int(most):
            return int(lanes)
    return int(re.findall(r"launch_dw_max_words<(\d+)>", rule)[-1])


def emulated_word_tail(table: torch.Tensor, knn_idx: torch.Tensor, dw: torch.Tensor,
                       lanes: int, splits: int, rows: int = 8) -> torch.Tensor:
    """#13's bf16 form on packed words: rounds of lanes * 8 channels, each
    lane's 8 channels of the f32 table read as two rows of 4 and rounded
    into bf16 words a pair at a time, its 8 weights as 4 words; `splits`
    lane groups across the neighbours, each a contiguous run of ceil(k /
    splits) taken in groups of `rows` by `mul_bf16x2` and the max in
    neighbour order; then a butterfly over the splits, each pair's maxima
    taken earlier run first (an empty split gives way). table [B, N, C]
    f32, dw [B, M, k, C] bf16."""
    channels, k = table.shape[-1], dw.shape[2]
    per = -(-k // splits)
    out = torch.empty(dw.shape[0], dw.shape[1], channels)
    for c0 in range(0, channels, lanes * 8):
        for c in range(c0, min(c0 + lanes * 8, channels), 8):
            words = bf16_words(table[..., c:c + 8].bfloat16())  # cvt.rn.bf16x2 a pair
            maxima = []
            for s in range(splits):
                lo, hi = min(k, s * per), min(k, s * per + per)
                m = None
                for j0 in range(lo, hi, rows):
                    for j in range(j0, min(j0 + rows, hi)):
                        t = torch.stack([words[b, knn_idx[b, :, j].long()]
                                         for b in range(words.shape[0])])
                        lo_p, hi_p = mul_bf16x2(t, bf16_words(dw[:, :, j, c:c + 8]))
                        x = torch.stack([lo_p, hi_p], dim=-1).flatten(-2)
                        m = x if m is None else take_max(m, x)
                maxima.append(m)
            off = 1
            while off < splits:
                maxima = [maxima[s ^ off] if maxima[min(s, s ^ off)] is None
                          else maxima[min(s, s ^ off)] if maxima[max(s, s ^ off)] is None
                          else take_max(maxima[min(s, s ^ off)], maxima[max(s, s ^ off)])
                          for s in range(splits)]
                off *= 2
            out[..., c:c + 8] = maxima[0]
    return out


@pytest.mark.parametrize("channels,k", [(256, 4), (128, 4), (128, 32), (64, 32), (24, 13),
                                        (136, 40)])
def test_dw_max_bf16_word_form_is_plain_bit_for_bit(channels, k):
    """#13's bf16 form on packed words, at the fuse_hidden path's four
    shapes (z|r, q, conv1, conv2: 32, 16, 16 and 8 lanes across the
    channels, the kernel's dispatch) and at ragged ones (k no multiple of
    the splits, two rounds of channels), its neighbours split as shipped
    (over the warp where k > kWordRows) and, the same bits, not at all, in
    two runs and over the whole warp:
    bit for bit `dw_max_plain` on the bf16 weights, with a NaN
    table row, zero rows of both signs, runs of +-0 weights over every
    neighbour (zero maxima), a NaN weight and repeated neighbours. A zero
    maximum's sign is the earlier zero's (`take_max`, the kernel's rule);
    torch.amax on the CPU keeps the earlier of tied zeros on narrow rows
    and the later on wide ones (its vectorised path), so there the two are
    held equal in value."""
    assert [dw_max_word_lanes(c) for c in (256, 128, 64, 32, 16, 8, 136)] == [
        32, 16, 8, 4, 2, 1, 32]
    gen = torch.Generator().manual_seed(channels + k)
    n = 48
    table = torch.randn(1, n, channels, generator=gen)
    table[0, 3] = float("nan")
    table[0, 8], table[0, 9] = 0.0, -0.0
    rows = torch.tensor([r for r in range(n) if r not in (3, 8, 9)])
    knn_idx = rows[torch.argsort(torch.rand(1, n, len(rows), generator=gen), dim=-1)[..., :k]]
    knn_idx = knn_idx.int()
    knn_idx[:, ::5, k - 1] = knn_idx[:, ::5, 0]
    knn_idx[:, ::6, k // 2] = 3  # the NaN row
    knn_idx[:, 1::4, : min(k, 4)] = 9  # -0 rows first
    knn_idx[:, 3::8, k - 1] = 8
    w = torch.randn(1, n, k, channels, generator=gen)
    w[0, 2::7, :, 1::4] = 0.0
    w[0, 2::7, ::2, 1::4] = -0.0
    w[0, 11, k // 2, 5] = float("nan")
    w16 = w.bfloat16()
    lanes = dw_max_word_lanes(channels)
    rows = source_constants()["kWordRows"]
    shipped = 32 // lanes if k > rows else 1  # the kernel's rule: split where k > rows
    got = emulated_word_tail(table, knn_idx, w16, lanes, shipped, rows)
    for splits in {1, 2, 32 // lanes} - {shipped}:  # every split gives the same bits
        other = emulated_word_tail(table, knn_idx, w16, lanes, splits, rows)
        assert torch.equal(other.view(torch.int32), got.view(torch.int32)), splits
    plain = update3d.dw_max_plain(table, knn_idx, w16)
    nan = torch.isnan(plain)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    zero = plain == 0
    assert torch.equal(got[~nan & ~zero].view(torch.int32), plain[~nan & ~zero].view(torch.int32))
    assert torch.equal(got[zero], plain[zero])
    assert (zero & torch.signbit(got)).any() and (zero & ~torch.signbit(got)).any()
    # the earlier zero's sign: the first neighbours are the -0 row (-0 * w)
    first = torch.signbit(w16[0, 1::4, 0].float()) != torch.signbit(torch.tensor(-0.0))
    assert torch.equal(torch.signbit(got[0, 1::4])[zero[0, 1::4]], first[zero[0, 1::4]])
