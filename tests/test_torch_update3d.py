"""PyTorch port, the 3D update chain (ops/update3d.py): the plain versions of
kernels #6 and #7 against the Flax modules and the Pallas kernels, on the
CPU.

The same numpy inputs and the same hoisted PointConvDW weights (the Flax
`precompute_weights`) go through the JAX side and the port; the Flax
variables are carried into the port's modules by name. f32 on both sides
holds to 1e-5 (summation order). Against the Pallas kernels in interpret
mode, which run their matmuls and gathers in bf16 on `to_kernel_layout`'d
bf16 weights, the tolerances are those of tests/test_pallas_update3d.py.
The CUDA kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py compares them with these plain versions.
Here the wrappers' CUDA path runs on CPU tensors with the launch recorded:
what they hand the kernels (pointers, strides, scratch) is held to
csrc/update3d.cu's own constants and layout check, read from the source.
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import camliraft_l as jm
from camliflow_tpu.ops.geometry import k_nearest_neighbor
from camliflow_tpu.ops.pallas_update3d import (
    gru_flowhead_3d_pallas,
    motion_encoder_3d_pallas,
    prepare_gru_flowhead_3d_params,
    prepare_motion_encoder_3d_params,
    to_kernel_layout,
)
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_torch.models import camliraft_l as tm
from camliflow_torch.ops import update3d
from camliflow_torch.runtime.names import translate_suffix

torch.set_num_threads(2)

N = 96  # points; the Pallas kernels in interpret mode set the size


@pytest.fixture(autouse=True)
def forward_only():
    """The fused kernels' packers and wrappers are forward-only: they refuse
    weights or inputs that require grad while grad mode is on (a gradient
    would be dropped). These tests exercise the eval path, so grad mode is
    off, as it is under the Evaluator's inference_mode."""
    with torch.no_grad():
        yield


def j(a):
    return jnp.asarray(np.asarray(a))


def t(a):
    return torch.from_numpy(np.array(a))


def load_block(block, variables):
    """Carry a standalone Flax block's variables into its port."""
    state = {}
    for path, value in tree_to_flat(jax.tree.map(np.asarray, variables)).items():
        value = np.asarray(value, np.float32)
        state[translate_suffix(path.split("/", 1)[1])] = t(
            value.T if path.endswith("kernel") else value)
    block.load_state_dict(state, strict=True)
    return block.eval()


def dw_to_torch(dw):
    return {k: t(np.asarray(v)) for k, v in dw.items()}


def pallas_dw(dw):
    return to_kernel_layout(jax.tree.map(lambda w: w.astype(jnp.bfloat16), dw))


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(40)
    xyz = jnp.asarray(rng.standard_normal((1, N, 3)), jnp.float32)
    knn = k_nearest_neighbor(xyz, xyz, 32)
    feats = {
        "flow": 0.1 * rng.standard_normal((1, N, 3)),
        "corr": rng.standard_normal((1, N, 128)),
        "h": np.tanh(rng.standard_normal((1, N, 128))),
        "x3d": np.maximum(rng.standard_normal((1, N, 128)), 0),
        "motion": rng.standard_normal((1, N, 128)),
    }
    return xyz, knn, {k: np.asarray(v, np.float32) for k, v in feats.items()}


@pytest.fixture(scope="module")
def motion_encoder(cloud):
    xyz, knn, c = cloud
    block = jm.MotionEncoder3D()
    variables = block.init(jax.random.PRNGKey(0), xyz, j(c["flow"]), j(c["corr"]), knn)
    dw = block.apply(variables, xyz, knn, method=jm.MotionEncoder3D.precompute_weights)
    return block, variables, dw, load_block(tm.MotionEncoder3D(), variables)


@pytest.fixture(scope="module")
def gru_flowhead(cloud):
    xyz, knn, c = cloud
    x = j(np.concatenate([c["x3d"], c["motion"]], -1))
    gru, head = jm.GRU3D(hidden_dim=128), jm.FlowHead3D()
    gvars = gru.init(jax.random.PRNGKey(1), xyz, j(c["h"]), x, knn)
    hvars = head.init(jax.random.PRNGKey(2), xyz, j(c["h"]), knn)
    dw = {**gru.apply(gvars, xyz, knn, method=jm.GRU3D.precompute_weights),
          **head.apply(hvars, xyz, knn, method=jm.FlowHead3D.precompute_weights)}
    ports = load_block(tm.GRU3D(), gvars), load_block(tm.FlowHead3D(), hvars)
    return (gru, gvars), (head, hvars), dw, ports


def test_motion_encoder_3d_plain_matches_flax_and_pallas(cloud, motion_encoder):
    xyz, knn, c = cloud
    block, variables, dw, port = motion_encoder
    ref = block.apply(variables, xyz, j(c["flow"]), j(c["corr"]), knn, dw=dw)
    params = update3d.prepare_motion_encoder_3d_params(port)
    args = (t(c["flow"]), t(c["corr"]), t(knn), dw_to_torch(dw), params)
    got = update3d.motion_encoder_3d_plain(*args)
    assert got.shape == (1, N, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the module's own forward is the same chain on its own weights, and the
    # wrapper on CPU tensors is the plain version
    with torch.inference_mode():
        np.testing.assert_array_equal(port(t(xyz), *args[:-1]).numpy(), got.numpy())
        np.testing.assert_array_equal(update3d.motion_encoder_3d(*args).numpy(), got.numpy())
    pallas = motion_encoder_3d_pallas(j(c["flow"]), j(c["corr"]), knn, pallas_dw(dw),
                                      prepare_motion_encoder_3d_params(variables["params"]),
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-2, atol=2e-2)


def test_gru_flowhead_3d_plain_matches_flax_and_pallas(cloud, gru_flowhead):
    xyz, knn, c = cloud
    (gru, gvars), (head, hvars), dw, (tgru, thead) = gru_flowhead
    x = j(np.concatenate([c["x3d"], c["motion"]], -1))
    h_ref = gru.apply(gvars, xyz, j(c["h"]), x, knn, dw=dw)
    d_ref = head.apply(hvars, xyz, h_ref, knn, dw=dw)
    params = update3d.prepare_gru_flowhead_3d_params(tgru, thead)
    args = (t(c["h"]), t(c["x3d"]), t(c["motion"]), t(knn), dw_to_torch(dw), params)
    h_got, d_got = update3d.gru_flowhead_3d_plain(*args)
    assert h_got.shape == (1, N, 128) and d_got.shape == (1, N, 3)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), rtol=1e-5, atol=1e-5)
    h_w, d_w = update3d.gru_flowhead_3d(*args)
    np.testing.assert_array_equal(h_w.numpy(), h_got.numpy())
    np.testing.assert_array_equal(d_w.numpy(), d_got.numpy())
    h_pal, d_pal = gru_flowhead_3d_pallas(
        j(c["h"]), j(c["x3d"]), j(c["motion"]), knn,
        pallas_dw({**dw, "flow_conv1": dw["conv1"], "flow_conv2": dw["conv2"]}),
        prepare_gru_flowhead_3d_params(gvars["params"], hvars["params"]), interpret=True)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_pal), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_pal), rtol=2e-2, atol=3e-2)


def test_packing_stacks_z_and_r(gru_flowhead):
    """z and r pack into one [384, 256] matmul: the first 128 output
    channels are z's Linear, the rest r's, each zero-padded to the tiles."""
    _, _, _, (tgru, _) = gru_flowhead
    zr = update3d.prepare_gru_3d_params(tgru)["zr"]
    assert (zr.cin, zr.cout) == (384, 256) and zr.weight.shape == (384, 256)
    np.testing.assert_array_equal(zr.weight[:, :128].numpy(),
                                  tgru.conv_z.mlp.convs[0].conv_fn.weight.detach().numpy().T)
    np.testing.assert_array_equal(zr.bias[128:].numpy(),
                                  tgru.conv_r.mlp.convs[0].conv_fn.bias.detach().numpy())
    f1 = update3d.prepare_motion_encoder_3d_params(tm.MotionEncoder3D())["conv_f1"]
    assert f1.weight.shape == (16, 64) and not f1.weight[3:].any() and not f1.weight[:, 32:].any()


def test_q_split_sums_to_q(gru_flowhead):
    """#7 splits q by its input [r*h, x3d, motion]: "zrq" is z|r beside q's
    x3d/motion part (its r*h rows zero) over [h, x3d, motion], "q_h" q's r*h
    part without bias; zrq's last 128 channels plus q_h give q's product, and
    its first 256 are z|r's. Both carry tf32 planes that rebuild the
    weights to ~2^-22."""
    _, _, _, (tgru, _) = gru_flowhead
    params = update3d.prepare_gru_3d_params(tgru)
    rng = np.random.default_rng(3)
    h, x, m, rh = (t(rng.standard_normal((2, 50, 128)).astype(np.float32)) for _ in range(4))
    zrq = update3d.linear_plain(torch.cat([h, x, m], -1), params["zrq"])
    np.testing.assert_array_equal(
        zrq[..., :256].numpy(),
        update3d.linear_plain(torch.cat([h, x, m], -1), params["zr"]).numpy())
    q = update3d.linear_plain(torch.cat([rh, x, m], -1), params["q"])
    np.testing.assert_allclose((zrq[..., 256:] + update3d.linear_plain(rh, params["q_h"])).numpy(),
                               q.numpy(), rtol=1e-5, atol=1e-5)
    for key in ("zrq", "q_h"):
        conv = params[key]
        assert conv.hi.shape == conv.weight.shape[::-1]
        rebuilt = (conv.hi.double() + conv.lo.double()).t()
        assert float((rebuilt - conv.weight.double()).abs().max()) <= 2.0**-21


# --- the PointConvDW tail alone (kernel #13) -------------------------------


@pytest.mark.parametrize("k,channels", [(4, 256), (32, 64)])
def test_dw_max_plain_matches_flax_tail(cloud, k, channels):
    """dw_max_plain on the Flax MLP's own output equals the Flax
    PointConvDW (gather, multiply, max over k) exactly, f32."""
    from camliflow_tpu.nn.point_conv import PointConvDW

    xyz, knn, c = cloud
    conv = PointConvDW(channels, act=None, k=k)
    feats = j(c["h"])
    variables = conv.init(jax.random.PRNGKey(k), xyz, feats, knn_indices=knn)
    weights = conv.apply(variables, xyz, knn_indices=knn, method=PointConvDW.compute_weights)
    ref = conv.apply(variables, xyz, feats, knn_indices=knn, weights=weights)
    table = conv.apply(variables, feats, method=lambda m, f: m.mlp(f))
    got = update3d.dw_max_plain(t(table), t(knn), t(weights))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(update3d.dw_max(t(table), t(knn), t(weights)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("k,channels", [(4, 256), (16, 125), (32, 64)])
def test_dw_max_plain_matches_ohg(k, channels):
    """Against dw_conv_ohg (interpret mode) on bf16-representable inputs: the
    OHG kernel rounds each product to bf16, so rtol 2^-8."""
    from camliflow_tpu.ops.pallas_ohg import dw_conv_ohg, pack_dw

    rng = np.random.default_rng(k * 1000 + channels)
    table = jnp.asarray(rng.standard_normal((2, 256, channels)), jnp.bfloat16)
    idx = jnp.asarray(rng.integers(0, 256, (2, 128, k)), jnp.int32)
    weights = jnp.asarray(rng.standard_normal((2, 128, k, channels)), jnp.bfloat16)
    pack = pack_dw(weights, idx)
    ref = dw_conv_ohg(table, pack["idx_km"], pack["w_km"], k, interpret=True)
    got = update3d.dw_max_plain(*(t(np.asarray(a, np.float32)) for a in (table, idx, weights)))
    assert got.shape == (2, 128, channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2.0**-8, atol=0)


def test_gru_and_flow_head_forwards_take_packed_params(cloud, gru_flowhead):
    """GRU3D's and FlowHead3D's own forwards (the differentiable chains the
    flagship trains through, on the module weights) compute what the
    packed path computes: `gru_3d`/`flow_head_3d` through `dw_max` (on the
    CPU its plain version) and the plain chains, on weights packed once per
    request."""
    xyz, knn, c = cloud
    _, _, dw, (tgru, thead) = gru_flowhead
    dw = dw_to_torch(dw)
    h, x = t(c["h"]), t(np.concatenate([c["x3d"], c["motion"]], -1))
    with torch.inference_mode():
        gru_params = update3d.prepare_gru_3d_params(tgru)
        head_params = update3d.prepare_flow_head_3d_params(thead)
        h_new = tgru(t(xyz), h, x, t(knn), dw)
        close = dict(rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(h_new, update3d.gru_3d(h, x, t(knn), dw, gru_params), **close)
        torch.testing.assert_close(h_new, update3d.gru_3d_plain(h, x, t(knn), dw, gru_params),
                                   **close)
        delta = thead(t(xyz), h_new, t(knn), dw)
        torch.testing.assert_close(delta, update3d.flow_head_3d(h_new, t(knn), dw, head_params),
                                   **close)
        torch.testing.assert_close(
            delta, update3d.flow_head_3d_plain(h_new, t(knn), dw, head_params), **close)


# --- what the wrappers hand the kernels (csrc/update3d.cu) ------------------

SOURCE = (Path(__file__).resolve().parents[1] / "camliflow_torch" / "csrc"
          / "update3d.cu").read_text()


def source_constants():
    """csrc/update3d.cu's `constexpr int k*` constants, each expression
    evaluated with the ones before it."""
    values = {}
    for line in re.findall(r"^constexpr int (k\w+ = [^;]+);", SOURCE, re.M):
        for declaration in line.split(", k"):  # `constexpr int kA = 1, kB = 2;`
            name, expr = declaration.split(" = ")
            values["k" + name.lstrip("k")] = eval(expr, {"__builtins__": {}}, dict(values))
    return values


def test_wrapper_limits_are_the_kernels_constants():
    """The wrappers' widths, neighbour caps and alignment rule are the ones
    the kernels declare, the models' widths lie inside them, and the stage
    kernel is gone: #6, #7 and #13 run on the one tail."""
    k = source_constants()
    assert update3d.MAX_ROW == k["kMaxRow"]
    assert update3d.MAX_FUSED_OUT == k["kGfThreads"]
    assert update3d.TAIL_ALIGN == k["kTailAlign"] == 16
    assert update3d.GF_KS == (k["kGruK"], k["kGruK"], k["kHeadK"], k["kHeadK"])
    assert update3d.GF_MAX_FC == k["kMaxFc"]
    assert max(update3d.GF_WIDTHS[1:3]) <= k["kMaxRow"]  # q's and conv1's fused layers
    # MotionEncoder3D's widths: f1 32 feeds the fused f2 layer (16 outputs)
    me = update3d.prepare_motion_encoder_3d_params(tm.MotionEncoder3D())
    assert me["conv_f1"].cout <= update3d.MAX_ROW and me["conv_f2"].cout <= update3d.MAX_FUSED_OUT
    assert all(me[key].cout % 4 == 0 for key in update3d.ME_CONVS[:3])
    assert "stage_kernel" not in SOURCE and "namespace staged" not in SOURCE
    assert SOURCE.count("__device__ __forceinline__ void tail(") == 1


def kernel_layout_floats(c_c1, c_f1, c_f2, c_m):
    """The floats a point of #6's scratch must hold, by the entry point's
    own check in csrc/update3d.cu (`per_point < ...`)."""
    expr = re.search(r"if \(per_point < ([^|]+) \|\|", SOURCE).group(1)
    ld_m = -(-c_m // 4) * 4
    return eval(expr, {"__builtins__": {}}, dict(c_c1=c_c1, c_f1=c_f1, c_f2=c_f2, ld_m=ld_m))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA path on CPU tensors: no device checks, and each
    launch recorded (name, arguments) instead of run; every tensor the
    wrappers allocate recorded too."""
    from camliflow_torch.csrc import build
    from camliflow_torch.ops import _cuda

    launches, made = [], []
    real_new_empty = torch.Tensor.new_empty

    def new_empty(self, *size, **kwargs):
        made.append(real_new_empty(self, *size, **kwargs))
        return made[-1]

    monkeypatch.setattr(_cuda, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(_cuda, "check", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.Tensor, "new_empty", new_empty)
    monkeypatch.setattr(build, "launch", lambda name, *args: launches.append((name, args)))
    return launches, made


def me_inputs(batch, n, idx_width):
    """MotionEncoder3D's packed MLPs, and inputs of its shapes (values
    unread: nothing runs)."""
    params = update3d.prepare_motion_encoder_3d_params(tm.MotionEncoder3D())
    dw = {key: update3d.padded_rows(torch.zeros(batch, n, k, params[key].cout))
          for key, k in zip(update3d.ME_CONVS, (16, 32, 16, 16))}
    knn_idx = torch.zeros(batch, n, idx_width, dtype=torch.int32)
    return torch.zeros(batch, n, 3), torch.zeros(batch, n, 128), knn_idx, dw, params


@pytest.mark.parametrize("batch,n,idx_width", [(1, 2048, 32), (2, 100, 33), (1, 70, 40)])
def test_motion_encoder_3d_hands_the_kernel_fitting_scratch(fake_card, batch, n, idx_width):
    """At the main path's shape and odd ones, the wrapper hands #6 the
    pointers in order, the widths, neighbours and strides of the inputs,
    and a scratch buffer that holds the kernel's layout: every part
    16-byte aligned, the last ending inside it. A second call on the same
    objects reuses the remembered check."""
    launches, made = fake_card
    flow, corr, knn_idx, dw, params = me_inputs(batch, n, idx_width)
    out = update3d.motion_encoder_3d(flow, corr, knn_idx, dw, params)
    (name, args), = launches
    assert name == "camli_motion_encoder_3d" and len(args) == 30
    assert args[:7] == (flow.data_ptr(), corr.data_ptr(), knn_idx.data_ptr(),
                        *(dw[key].data_ptr() for key in update3d.ME_CONVS))
    planes = [params[key][i] for key in update3d.ME_DENSE for i in (6, 7, 1)]  # hi, lo, bias
    assert list(args[7]) == [t.data_ptr() for t in planes]
    assert args[8:12] == tuple(t.data_ptr() for key in ("conv_f1", "conv_f2")
                               for t in params[key][:2])
    scratch = next(t for t in made if t.data_ptr() == args[12])
    assert args[13] == out.data_ptr() and out.shape == (batch, n, 125 + 3)
    ints = args[14:]
    assert ints[:9] == (batch, n, idx_width, 3, 128, 128, 32, 16, 125)
    assert ints[9:13] == (16, 32, 16, 16)  # neighbours: c1, f1, f2, merge
    assert ints[13:15] == (64, 64)  # f1's and f2's packed weights' row length
    per_point = ints[15]
    assert per_point == kernel_layout_floats(128, 32, 16, 125) == 448
    assert scratch.numel() == batch * n * per_point
    points = batch * n
    parts = [128, 32, 128, 16, 16, 128]  # c1 table, f1 table, corr_feat, f2, flow_feat, merge
    offsets = np.cumsum([0] + parts) * points
    assert all(o % 4 == 0 for o in offsets) and offsets[-1] <= scratch.numel()
    # the check is remembered while the objects stay the same
    calls = []
    check_dw = update3d._check_dw
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(update3d, "_check_dw", lambda *a, **k: calls.append(1) or check_dw(*a, **k))
        update3d.motion_encoder_3d(flow, corr, knn_idx, dw, params)
        assert not calls
        update3d.motion_encoder_3d(flow, corr, knn_idx,
                                   {**dw, "conv": update3d.padded_rows(dw["conv"].clone())},
                                   params)
        assert len(calls) == 1


def shifted(t, row=None):
    """A copy of `t` 4 bytes past a 16-byte boundary; with `row`, its rows
    `row` floats apart."""
    row = row or t.shape[-1]
    base = torch.empty(t[..., :1].numel() * row + 1)[1:].view(*t.shape[:-1], row)
    base[..., :t.shape[-1]] = t
    return base[..., :t.shape[-1]]


def test_motion_encoder_3d_raises_where_the_kernel_would_fault(fake_card):
    """The c1 and merge tails read 16-byte rows and corr feeds the
    tensor-core tile: misaligned c1 or merge weights or corr, merge weights
    whose rows are not 128 floats apart, or a width that is not a multiple
    of 4, raise before any launch. f1's and f2's tails read 4 bytes at a
    time: their weights may sit anywhere."""
    launches, _ = fake_card
    flow, corr, knn_idx, dw, params = me_inputs(1, 50, 32)
    for key, row in (("conv_c1", None), ("conv", 128)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            update3d.motion_encoder_3d(flow, corr, knn_idx, {**dw, key: shifted(dw[key], row)},
                                       params)
    with pytest.raises(ValueError, match="16-byte aligned"):
        update3d.motion_encoder_3d(flow, shifted(corr), knn_idx, dw, params)
    with pytest.raises(ValueError, match="128 floats apart"):
        update3d.motion_encoder_3d(flow, corr, knn_idx, {**dw, "conv": dw["conv"].contiguous()},
                                   params)
    narrow = {**params, "conv_f2": params["conv_f2"]._replace(cout=15),
              "conv": params["conv"]._replace(cin=143)}
    with pytest.raises(ValueError, match="multiples of 4"):
        update3d.motion_encoder_3d(flow, corr, knn_idx,
                                   {**dw, "conv_f2": dw["conv_f2"][..., :15].contiguous()}, narrow)
    assert not launches
    update3d.motion_encoder_3d(flow, corr, knn_idx, {**dw, "conv_f1": shifted(dw["conv_f1"]),
                                                     "conv_f2": shifted(dw["conv_f2"])}, params)
    assert len(launches) == 1


def test_merge_rows_padded_at_the_hoist(cloud, motion_encoder):
    """MotionEncoder3D.precompute_weights gives each conv's weights with its
    own values and shape, the merge conv's 125 channels in rows 128 floats
    apart (16-byte rows, zeros between), the others contiguous; the plain
    chain gives the same bits on them as on contiguous weights."""
    xyz, knn, c = cloud
    _, _, dw, port = motion_encoder
    with torch.inference_mode():
        padded = port.precompute_weights(t(xyz), t(knn))
        own = {name: getattr(port, name).compute_weights(t(xyz), knn_indices=t(knn))
               for name in update3d.ME_CONVS}
    merge = padded["conv"]
    assert merge.shape == own["conv"].shape and merge.stride()[2:] == (128, 1)
    assert not merge.as_strided((merge.numel() // 125, 3), (128, 1), 125).any()
    for name in update3d.ME_CONVS:
        assert torch.equal(padded[name], own[name])
        assert name == "conv" or padded[name].is_contiguous()
    params = update3d.prepare_motion_encoder_3d_params(port)
    args = (t(c["flow"]), t(c["corr"]), t(knn))
    np.testing.assert_array_equal(update3d.motion_encoder_3d_plain(*args, padded, params).numpy(),
                                  update3d.motion_encoder_3d_plain(*args, own, params).numpy())


@pytest.mark.parametrize("batch,m,n_table,idx_width,k,channels", [
    (1, 2048, 2048, 32, 4, 256), (1, 2048, 2048, 32, 4, 128),  # z|r, q
    (1, 2048, 2048, 32, 32, 128), (1, 2048, 2048, 32, 32, 64),  # conv1, conv2
    (2, 70, 100, 33, 32, 125), (2, 33, 33, 32, 1, 3), (1, 20, 30, 41, 40, 20),
])
def test_dw_max_hands_the_kernel_its_shapes(fake_card, batch, m, n_table, idx_width, k,
                                            channels):
    """#13 takes any k >= 1 and C: the wrapper hands it the table's rows,
    the queries, the index stride, k and C, and an output of [B, M, C]."""
    launches, _ = fake_card
    table = torch.zeros(batch, n_table, channels)
    knn_idx = torch.zeros(batch, m, idx_width, dtype=torch.int32)
    weights = torch.zeros(batch, m, k, channels)
    out = update3d.dw_max(table, knn_idx, weights)
    (name, args), = launches
    assert name == "camli_dw_max"
    assert args == (table.data_ptr(), weights.data_ptr(), knn_idx.data_ptr(), out.data_ptr(),
                    batch, n_table, m, idx_width, k, channels)
    assert out.shape == (batch, m, channels)
