"""PyTorch port, #11's bf16 form (CAMLIFLOW_CLFM=1) on the CPU: the division
of work of csrc/clfm.cu's chain, its packings, and what the wrapper hands
the kernel.

The kernel runs one chain a tile of 64 rows: a block gathers its rows' A
operand (g = score * bf16(f3d[nn]) at the pixels, the four bf16 taps times
their f32 weights in tap order at the points), runs the side's three layers
on bf16 operands with f32 sums, keeps interp (sm) only as the bf16 operand
of the next layer, and writes each tile's column sums of a + b; the SK heads
sum the tiles in order, and the blend reads a and b. Tiles never straddle
batch items, so a batch item's last tile is partial. `emulated_chain`
repeats that division on the CPU; it is held within one bf16 step
(GATED_TOL) to `clfm_fused_plain`'s bf16 form, and to
`clfm_fused_pallas` in interpret mode (the TPU kernel), at the corr and
motion widths, maps and clouds that are no multiple of 64. The kernel itself
runs only on a card: tests/test_torch_kernels_cuda.py.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from camliflow_tpu.nn.clfm import CLFM as FlaxCLFM
from camliflow_tpu.nn.clfm import fusion_interp_cache
from camliflow_tpu.ops import pallas_clfm as jclfm
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_torch.csrc import clfm_forms
from camliflow_torch.nn.clfm import CLFM
from camliflow_torch.ops import clfm, update3d
from camliflow_torch.runtime.names import translate_suffix
from test_torch_update3d import fake_card  # noqa: F401 (a fixture)

torch.set_num_threads(2)

GATED_TOL = 2.0**-7  # one bf16 step of the largest value (chip_smoke.py's)
SK_MEAN_TOL = 2.0**-14  # an SK mean against the plain one's, of its largest value (chip_smoke.py's)
SK_WEIGHT_TOL = 2.0**-12  # the SK pair weights against the plain ones (chip_smoke.py's)
HEIGHT, WIDTH, N = 9, 11, 77  # 99 pixels and 77 points: two tiles each, the second partial
SOURCE = (Path(clfm.__file__).resolve().parents[1] / "csrc" / "clfm.cu").read_text()


@pytest.fixture(autouse=True)
def forward_only():
    with torch.no_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def case(c2, c3, batch, seed):
    """The Flax CLFM's variables, the port's module carrying them, and the
    bf16 form's inputs: maps and clouds from a seed, the JAX pixel-grid
    cache, the JAX bf16 score gate."""
    rng = np.random.RandomState(seed)
    feat_2d = rng.randn(batch, HEIGHT, WIDTH, c2).astype(np.float32)
    feat_3d = rng.randn(batch, N, c3).astype(np.float32)
    uv = (rng.rand(batch, N, 2) * [WIDTH + 3, HEIGHT + 3] - 1.5).astype(np.float32)
    cache = fusion_interp_cache(uv, HEIGHT, WIDTH)
    block = FlaxCLFM(c2, c3)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(seed), uv, feat_2d, feat_3d,
                            interp_cache=cache)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        * (float(np.prod(leaf.shape[:-1])) ** -0.5 if path[-1].key == "kernel" else 0.1),
        shapes)
    port = CLFM(c2, c3)
    state = {translate_suffix(path.split("/", 1)[1]): t(value.T if path.endswith("kernel")
                                                         else value)
             for path, value in tree_to_flat(variables).items()}
    port.load_state_dict(state, strict=True)
    params = variables["params"]
    score = jclfm.hoist_interp_score(params["interp"], cache[1])
    score_t = torch.from_numpy(np.asarray(score, np.float32)).to(torch.bfloat16)
    inputs = (t(feat_2d), t(feat_3d), score_t, t(cache[0]),
              *clfm.grid_sample_cache(t(uv), HEIGHT, WIDTH))
    jax_inputs = (feat_2d, feat_3d, score, cache[0], *jclfm.grid_sample_cache(uv, HEIGHT, WIDTH),
                  jclfm.prepare_clfm_params(params))
    return port.eval(), inputs, jax_inputs


def bf16(x):
    return x.to(torch.bfloat16).float()


def distinct_items(inputs):
    """The inputs with batch item k's maps and clouds scaled by 1 + k / 4 and
    shifted by k / 4 (chip_smoke.py's), so that no two items share an SK
    mean."""
    def item(x):
        k = torch.arange(x.shape[0], dtype=x.dtype).view(-1, *(1,) * (x.dim() - 1))
        return x * (1 + 0.25 * k) + 0.25 * k

    return (item(inputs[0]), item(inputs[1]), *inputs[2:])


def emulated_chain(feat_2d, feat_3d, score, nn_idx, tap_idx, tap_w, params, rows=64):
    """csrc/clfm.cu's bf16 form by tiles of `rows` rows of one batch item:
    A0 gathered and rounded, the first layer's leaky output rounded to bf16
    (interp, sm: A1), a and b from A1 and A2 (the rows rounded), each tile's
    column sums of a + b, the tiles summed in order for the mean, the SK
    heads on bf16 operands, the blend in f32. -> (out_2d, out_3d, each
    side's (mean, pair weights), each side's column sums by tile)."""
    batch, height, width, c2 = feat_2d.shape
    hw = height * width
    f2d, f3d = bf16(feat_2d.reshape(batch, hw, c2)), bf16(feat_3d)

    def dense(x, key):  # bf16 operands (x already bf16 values), f32 sums, leaky
        conv = params[key]
        return F.leaky_relu(x @ conv.weight[: conv.cin, : conv.cout] + conv.bias[: conv.cout], 0.1)

    def chain(total, a0_rows, first, a_layer, b_layer, a2_rows, a_from_a1):
        a_out, b_out, partial = [], [], []
        for b in range(batch):
            for r0 in range(0, total, rows):
                tile = slice(r0, min(r0 + rows, total))
                a1 = bf16(dense(a0_rows(b, tile), first))  # only ever a bf16 operand
                a2 = a2_rows(b, tile)
                a = dense(a1 if a_from_a1 else a2, a_layer)
                bb = dense(a2 if a_from_a1 else a1, b_layer)
                a_out.append(a), b_out.append(bb), partial.append((a + bb).sum(0))
        tiles = -(-total // rows)
        partial = torch.stack(partial).reshape(batch, tiles, -1)
        mean = partial[:, 0]
        for i in range(1, tiles):  # the heads' fixed order
            mean = mean + partial[:, i]
        return (torch.cat(a_out).reshape(batch, total, -1),
                torch.cat(b_out).reshape(batch, total, -1), mean / total, partial)

    def g_rows(b, tile):  # one bf16 product a value
        return bf16(score[b, tile].float() * f3d[b, nn_idx[b, tile, 0].long()])

    def samp_rows(b, tile):  # the four taps in tap order, in f32
        v = f2d[b, tap_idx[b, tile, 0].long()] * tap_w[b, tile, 0:1]
        for i in range(1, 4):
            v = v + f2d[b, tap_idx[b, tile, i].long()] * tap_w[b, tile, i:i + 1]
        return bf16(v)

    a, b, mean, partial = chain(hw, g_rows, "out_conv", "align1_2d", "align2_2d",
                       lambda b, tile: f2d[b, tile], False)
    a3, b3, mean3, partial3 = chain(feat_3d.shape[1], samp_rows, "mlps3d", "align1_3d", "align2_3d",
                          lambda b, tile: f3d[b, tile], True)

    def weights(mean, head):
        mid = F.relu(bf16(mean) @ head.mid)
        s = torch.sigmoid((bf16(mid) @ head.out).reshape(batch, -1, 2))
        w1 = torch.sigmoid(s[..., 0] - s[..., 1])
        return torch.stack((w1, 1.0 - w1), dim=-1)

    w, w3 = weights(mean, params["sk_2d"]), weights(mean3, params["sk_3d"])
    out_2d = (a * w[:, None, :, 0] + b * w[:, None, :, 1]).reshape(batch, height, width, c2)
    return (out_2d, a3 * w3[:, None, :, 0] + b3 * w3[:, None, :, 1], ((mean, w), (mean3, w3)),
            (partial, partial3))


def within(got, ref):
    err = float((got - ref).abs().max())
    assert err <= GATED_TOL * float(ref.abs().max()), err


@pytest.mark.parametrize("c2,c3,batch", [(324, 128, 1), (324, 128, 2), (128, 128, 1),
                                         (128, 128, 2)])
def test_emulated_chain_is_the_plain_bf16_form(c2, c3, batch):
    port, inputs, _ = case(c2, c3, batch, 90 + c2 + batch)
    params = clfm.prepare_clfm_params(port, bf16=True)
    got = emulated_chain(*inputs, params)[:2]
    ref = clfm.clfm_fused_plain(*inputs, params)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        within(g, r)


@pytest.mark.parametrize("c2,c3,batch", [(324, 128, 2), (128, 128, 1)])
def test_emulated_chain_is_the_pallas_kernel(c2, c3, batch):
    """Against clfm_fused_pallas in interpret mode, on the same score gate,
    cache and taps: within one bf16 step of each output's largest value."""
    port, inputs, jax_inputs = case(c2, c3, batch, 95 + c2 + batch)
    ref = jclfm.clfm_fused_pallas(*jax_inputs, interpret=True)
    got = emulated_chain(*inputs, clfm.prepare_clfm_params(port, bf16=True))[:2]
    for g, r in zip(got, ref):
        within(g, t(np.asarray(r, np.float32)))


def sk_within(got, ref):
    for (mean, weights), (mean_ref, weights_ref) in zip(got, ref):
        assert mean.shape == mean_ref.shape and weights.shape == weights_ref.shape
        err = float((mean - mean_ref).abs().max())
        assert err <= SK_MEAN_TOL * float(mean_ref.abs().max()), err
        assert float((weights - weights_ref).abs().max()) <= SK_WEIGHT_TOL


@pytest.mark.parametrize("c2,c3", [(324, 128), (128, 128)])
def test_emulated_chain_sk_state_is_the_plain_one(c2, c3):
    """On batch items of distinct scales and offsets, the chain's SK means
    (by 64-row tiles in order) and pair weights are within chip_smoke.py's
    SK tolerances of the plain version's (`sk_state_plain`, which
    `sk_state` gives on CPU tensors), and the outputs within a bf16 step."""
    port, inputs, _ = case(c2, c3, 2, 97 + c2)
    inputs = distinct_items(inputs)
    params = clfm.prepare_clfm_params(port, bf16=True)
    got = emulated_chain(*inputs, params)
    ref = clfm.sk_state_plain(*inputs, params)
    sk_within(got[2], ref)
    for cpu_state, plain in zip(clfm.sk_state(*inputs, params), ref):
        assert all(torch.equal(x, y) for x, y in zip(cpu_state, plain))
    assert ref[0][1].shape == (2, c2, 2) and ref[1][1].shape == (2, c3, 2)
    for g, r in zip(got[:2], clfm.clfm_fused_plain(*inputs, params)):
        within(g, r)


@pytest.mark.parametrize("fault", ["a tile missing", "another item's tiles"])
def test_sk_tolerance_sees_a_tiling_fault(fault):
    """The SK check is not blind to the faults of the mean across blocks: on
    distinct batch items, a mean that lacks one tile's column sums, or that
    takes another batch item's, is past SK_MEAN_TOL (the flagship's maps
    have 128 tiles; here 2, and a fault there is checked on the card)."""
    port, inputs, _ = case(128, 128, 2, 98)
    inputs = distinct_items(inputs)
    params = clfm.prepare_clfm_params(port, bf16=True)
    _, _, state, partials = emulated_chain(*inputs, params)
    for (m, _), partial, total in zip(state, partials, (HEIGHT * WIDTH, N)):
        if fault == "a tile missing":  # each item's first tile left out
            bad = partial[:, 1:].sum(1) / total
        else:
            bad = m.flip(0)
        err = float((bad - m).abs().max())
        assert err > 16 * SK_MEAN_TOL * float(m.abs().max()), (fault, err)


def layout_offsets(form, batch, hw, n, c2, c3):
    """The offsets, in floats, of the partial sums and SK weights of both
    sides in csrc/clfm.cu's scratch: run_bf16's `take(...)` parts (each
    rounded up to 4 floats) or camli_clfm's pointer chain."""
    names = {"rows2": batch * hw, "rows3": batch * n, "batch": batch, "c2": c2, "c3": c3,
             "hw": hw, "n": n, "kChunk": clfm.CHUNK, "two": SimpleNamespace(tiles=-(-hw // 64)),
             "three": SimpleNamespace(tiles=-(-n // 64))}

    def value(expr):
        return eval(expr.replace("(size_t)", "").replace(" / ", " // "), {"__builtins__": {}},
                    names)

    if form == "bf16":
        body = SOURCE[SOURCE.index("int run_bf16("):SOURCE.index("  g.blocks2 = ")]
        sizes = [-(-value(part) // 4) * 4
                 for part in re.findall(r"take\((.*?)\)(?:,|;)", body)]
        starts = [sum(sizes[:i]) for i in range(len(sizes))]
        return starts[4], starts[5], starts[6], starts[7]
    body = SOURCE[SOURCE.index('extern "C" int camli_clfm('):]
    body = body[body.index("float* g = scratch;"):body.index("const Side two")]
    at = {"g": 0}
    for name, base, expr in re.findall(r"float\* (\w+) = (\w+) \+ (.*?);", body):
        at[name] = at[base] + value(expr)
    return at["partial2"], at["partial3"], at["weights2"], at["weights3"]


@pytest.mark.parametrize("form", ["exact", "bf16"])
def test_sk_state_reads_the_kernels_scratch(fake_card, monkeypatch, form):
    """On the card, `sk_state` reads each side's column sums by tile (or
    chunk) and SK weights where csrc/clfm.cu writes them: a launch that fills
    the scratch with 0, 1, 2, ... gives the means and weights of those
    offsets in the source, at 9 x 11 pixels and 77 points, bs 2."""
    from camliflow_torch.csrc import build

    launches, made = fake_card
    batch, c2, c3 = 2, 324, 128
    hw = HEIGHT * WIDTH

    def fill(name, *args):
        launches.append((name, args))
        scratch = next(x for x in made if x.data_ptr() == args[11])
        scratch.copy_(torch.arange(scratch.numel(), dtype=torch.float32))

    monkeypatch.setattr(build, "launch", fill)
    port = CLFM(c2, c3).eval()
    params = clfm.prepare_clfm_params(port, bf16=form == "bf16")
    score_dtype = torch.bfloat16 if form == "bf16" else torch.float32
    inputs = (torch.zeros(batch, HEIGHT, WIDTH, c2), torch.zeros(batch, N, c3),
              torch.zeros(batch, hw, c3, dtype=score_dtype),
              torch.zeros(batch, hw, 1, dtype=torch.int32),
              torch.zeros(batch, N, 4, dtype=torch.int32), torch.zeros(batch, N, 4))
    state = clfm.sk_state(*inputs, params)
    assert len(launches) == 1
    rows_a_tile = 64 if form == "bf16" else 256
    offsets = layout_offsets(form, batch, hw, N, c2, c3)
    for side, (rows, c) in enumerate(((hw, c2), (N, c3))):
        mean, weights = state[side]
        tiles = -(-rows // rows_a_tile)
        start = offsets[side]
        partial = torch.arange(start, start + batch * tiles * c, dtype=torch.float64)
        want = partial.view(batch, tiles, c).sum(1) / rows
        assert torch.equal(mean, want.float())
        start = offsets[2 + side]
        assert torch.equal(weights.reshape(-1), torch.arange(start, start + batch * c * 2,
                                                             dtype=torch.float32))


@pytest.mark.parametrize("key", clfm.DENSE)
def test_bf16_planes_are_the_rounded_weights_k_padded_to_64(key):
    """Each dense layer's one plane: torch.bfloat16 [N_pad, K_pad], K_pad a
    multiple of 64 (a TMA box of 64 reduction values), N_pad of 64 (so of
    8, wgmma's), zero in the padding, and the values of the earlier f32
    plane of rounded weights (pack_linears(..., bf16=True))."""
    torch.manual_seed(91)
    port = CLFM(324, 128)
    conv = clfm.prepare_clfm_params(port, bf16=True)[key]
    plane = conv.hi
    assert conv.bf16 and conv.lo is None and plane.dtype == torch.bfloat16
    assert plane.is_contiguous() and plane.shape[1] % 64 == 0 and plane.shape[0] % 8 == 0
    assert plane.shape == (-(-conv.cout // 64) * 64, -(-conv.cin // 64) * 64)
    assert not plane[conv.cout:].float().any() and not plane[:, conv.cin:].float().any()
    linear = dict(zip(clfm.DENSE, (port.interp.out_conv, port.fuse2d.align1, port.fuse2d.align2,
                                   port.mlps3d, port.fuse3d.align1, port.fuse3d.align2)))[key]
    earlier = update3d.pack_linears(linear.conv_fn, planes=True, bf16=True).hi
    assert torch.equal(plane[:, : earlier.shape[1]].float(), earlier)
    assert torch.equal(conv.weight.t()[:, : earlier.shape[1]], earlier)  # the plain version's


def source_scratch_floats(batch, hw, n, c2, c3):
    """The bf16 form's scratch as csrc/clfm.cu::run_bf16 takes it: each
    `take(...)`, rounded up to 4 floats."""
    body = SOURCE[SOURCE.index("int run_bf16("):SOURCE.index("  g.blocks2 = ")]
    names = {"rows2": batch * hw, "rows3": batch * n, "batch": batch, "c2": c2, "c3": c3,
             "two": SimpleNamespace(tiles=-(-hw // 64)), "three": SimpleNamespace(tiles=-(-n // 64))}
    parts = [part.replace("(size_t)", "") for part in re.findall(r"take\((.*?)\)(?:,|;)", body)]
    assert len(parts) == 8, parts  # a, b, a3, b3, two partial sums, two SK weights
    return sum(-(-eval(part, {"__builtins__": {}}, names) // 4) * 4 for part in parts)


@pytest.mark.parametrize("batch,height,width,n", [(1, 68, 120, 2048), (2, 9, 11, 77),
                                                  (8, 68, 120, 2048)])
def test_scratch_by_form(fake_card, batch, height, width, n):
    """The wrapper hands the kernel the scratch of its form: the exact form's
    as before; the bf16 form's a, b, a3, b3 in f32, the partial sums by
    64-row tile and the SK weights, each part a multiple of 4 floats, as
    run_bf16 takes them (no g, interp, samp or sm: they stay in the block)."""
    launches, made = fake_card
    c2, c3 = 324, 128
    port = CLFM(c2, c3).eval()
    hw = height * width
    for bf16_form in (False, True):
        params = clfm.prepare_clfm_params(port, bf16=bf16_form)
        inputs = (torch.zeros(batch, height, width, c2), torch.zeros(batch, n, c3),
                  torch.zeros(batch, hw, c3, dtype=torch.bfloat16 if bf16_form else torch.float32),
                  torch.zeros(batch, hw, 1, dtype=torch.int32),
                  torch.zeros(batch, n, 4, dtype=torch.int32), torch.zeros(batch, n, 4))
        launches.clear()
        clfm.clfm_fused(*inputs, params)
        (name, args), = launches
        assert name == "camli_clfm" and args[14] == int(bf16_form)
        scratch = next(x for x in made if x.data_ptr() == args[11])
        want = clfm.scratch_floats(batch, hw, n, c2, c3, bf16_form)
        assert scratch.numel() == want
        if bf16_form:
            assert want == source_scratch_floats(batch, hw, n, c2, c3)
            assert want < clfm.scratch_floats(batch, hw, n, c2, c3)  # no g, interp, samp, sm


def test_bf16_form_raises_on_what_its_chain_does_not_take(fake_card):
    """The chain reads the score 4 values and the taps a point at a time, its
    planes by TMA in 64 x 64 tiles, and holds the wider side's A operands in
    shared memory: a misaligned score or tap tensor, a plane of the earlier
    f32 packing (K padded to 16) and widths whose block would pass 227 KB
    are refused before a launch (an f32 score: the card tests)."""
    launches, _ = fake_card
    port = CLFM(128, 128).eval()
    params = clfm.prepare_clfm_params(port, bf16=True)
    inputs = [torch.zeros(1, 6, 8, 128), torch.zeros(1, 30, 128),
              torch.zeros(1, 48, 128, dtype=torch.bfloat16), torch.zeros(1, 48, 1, dtype=torch.int32),
              torch.zeros(1, 30, 4, dtype=torch.int32), torch.zeros(1, 30, 4)]
    clfm.clfm_fused(*inputs, params)
    assert len(launches) == 1

    def shifted(x, elements):  # `elements` past an aligned start
        base = torch.zeros(x.numel() + elements, dtype=x.dtype)[elements:]
        return base.view(x.shape)

    for i, elements in ((2, 2), (4, 1), (5, 2)):  # score 4 bytes off, taps 4 and 8 bytes off
        bad = list(inputs)
        bad[i] = shifted(inputs[i], elements)
        with pytest.raises(ValueError, match="aligned"):
            clfm.clfm_fused(*bad, params)
    f32_plane = {**params, "align1_2d": params["align1_2d"]._replace(
        hi=update3d.pack_linears(port.fuse2d.align1.conv_fn, planes=True, bf16=True).hi)}
    f32_plane["align1_2d"] = f32_plane["align1_2d"]._replace(
        weight=f32_plane["align1_2d"].hi.t().contiguous())
    with pytest.raises(ValueError, match="bf16 plane"):
        clfm.clfm_fused(*inputs, f32_plane)
    assert clfm.chain_smem_bytes(324, 128) <= clfm.MAX_SMEM < clfm.chain_smem_bytes(512, 448)
    wide = CLFM(512, 448).eval()
    wide_inputs = [torch.zeros(1, 6, 8, 512), torch.zeros(1, 30, 448),
                   torch.zeros(1, 48, 448, dtype=torch.bfloat16), *inputs[3:]]
    with pytest.raises(ValueError, match="shared memory"):
        clfm.clfm_fused(*wide_inputs, clfm.prepare_clfm_params(wide, bf16=True))
    assert len(launches) == 1


def test_chain_smem_is_the_kernels():
    """ops/clfm.py::chain_smem_bytes repeats csrc/clfm.cu's, whose constants
    it names."""
    for name, value in (("kChainRows", clfm.CHAIN_ROWS), ("kChainStages", clfm.CHAIN_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", SOURCE), name
    body = SOURCE[SOURCE.index("int chain_smem_bytes("):]
    assert ("chunks * kChunkBytes + kChainStages * kTileBytes + (2 * kChainStages + 2) * 8 +"
            "\n         kChainRows * 32 + kChainConsumers * 4 * 64 * 4 + 1024") in body[:400]
    assert re.search(r"constexpr int kChainConsumers = 2;", SOURCE)
    assert "232448" in SOURCE and clfm.MAX_SMEM == 232448


@pytest.mark.parametrize("form", sorted(clfm_forms.FORMS))
def test_clfm_forms_patch_the_shipped_source(form):
    """Each form `python -m camliflow_torch.csrc.clfm_forms` builds finds
    each text it replaces in csrc/clfm.cu exactly once."""
    for old, _ in clfm_forms.FORMS[form]:
        assert SOURCE.count(old) == 1, (form, old[:60])
