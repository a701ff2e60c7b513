"""PyTorch port, CamLiRAFT-L: blocks, submodules and the whole model against
the JAX package through the weight bridge, on the CPU.

One JAX CamLiRAFT-L is initialised at the small test size
(tests/test_camliraft_l.py: 512 points, n_samples_list [256..16]), its
batch_stats and BN scales are perturbed away from 0/1 so that BatchNorm is
really exercised, and the variables are carried into the port with
`runtime.checkpoint.load_jax_variables`. The JAX side runs its exact path
(`fast_inference: off`). Both sides are f32; tolerances cover summation
order only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import camliraft_l as jm
from camliflow_tpu.nn import layers as jlayers
from camliflow_tpu.nn import point_conv as jpc
from camliflow_tpu.ops import geometry as jgeo
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_torch.models import camliraft_l as tm
from camliflow_torch.models.factory import model_factory
from camliflow_torch.nn import layers as tlayers
from camliflow_torch.nn import point_conv as tpc
from camliflow_torch.ops import update3d
from camliflow_torch.runtime.checkpoint import load_jax_variables, state_dict_from_jax
from tools.port_checkpoint import translate_suffix

torch.set_num_threads(2)

N_SAMPLES = [256, 128, 64, 32, 16]


def small_cfgs(ids):
    return {
        "name": "camliraft_l",
        "n_iters_eval": 3,
        "ids": {"enabled": ids},
        "fast_inference": "off",
        "n_samples_list": N_SAMPLES,
    }


def make_inputs(seed, batch=2, n=512, ids=False):
    rng = np.random.RandomState(seed)
    pc1 = rng.randn(batch, n, 3).astype(np.float32)
    if ids:
        pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(batch, n, 3).astype(np.float32)
    return {
        "pcs": np.concatenate([pc1, pc2], -1),
        "intrinsics": np.tile([1050.0, 479.5, 269.5], (batch, 1)).astype(np.float32),
    }


def perturb_bn(flat, seed):
    """Move BN statistics and affine params away from their init values."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for key, value in flat.items():
        if key.endswith("/mean") or (key.endswith("/bias") and "BatchNorm" in key):
            out[key] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        elif key.endswith("/var"):
            out[key] = (1.0 + rng.rand(*value.shape)).astype(np.float32)
        elif key.endswith("/scale"):
            out[key] = (1.0 + 0.2 * rng.randn(*value.shape)).astype(np.float32)
    return out


def j(a):
    return jnp.asarray(np.asarray(a))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def bridged():
    """(jax flat variables, jax variables tree, torch model) with IDS on."""
    cfgs = small_cfgs(ids=True)
    inputs = make_inputs(0, ids=True)
    model = jm.CamLiRAFTL(cfgs=cfgs, train_mode=False)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), {k: j(v) for k, v in inputs.items()}
    )
    flat = perturb_bn(tree_to_flat(jax.tree.map(np.asarray, variables)), 1)
    torch_model = tm.CamLiRAFTL(cfgs).eval()
    load_jax_variables(torch_model, flat, "camliraft_l")
    return flat, flat_to_tree(flat), torch_model


def sub(tree, *path):
    """Flax variables of one submodule: params and batch_stats at `path`."""
    out = {}
    for coll in ("params", "batch_stats"):
        node = tree.get(coll, {})
        for p in path:
            node = node.get(p, {})
        if node:
            out[coll] = node
    return out


@pytest.fixture(scope="module")
def geometry_consts():
    """The core's point pyramid and neighbours for one small input pair."""
    rng = np.random.RandomState(2)
    pc1 = rng.randn(1, 512, 3).astype(np.float32)
    pc2 = pc1 + 0.05 * rng.randn(1, 512, 3).astype(np.float32)
    xyzs1, xyzs2, _, _ = jgeo.build_pc_pyramid(j(pc1), j(pc2), N_SAMPLES)
    xyz1 = xyzs1[2]
    knn32 = jgeo.k_nearest_neighbor(xyz1, xyz1, 32)
    return [np.asarray(x) for x in xyzs1], [np.asarray(x) for x in xyzs2], \
        np.asarray(knn32)


# --- bridge ---------------------------------------------------------------


def test_bridge_lands_every_leaf(bridged):
    flat, _, model = bridged
    state = state_dict_from_jax(flat, "camliraft_l")
    assert len(state) == len(flat) == len(model.state_dict())
    assert set(state) == set(model.state_dict())
    # Dense kernels [I, O] arrive as Linear weights [O, I]
    kernel = flat["params/core/cnet_aligner/kernel"]
    np.testing.assert_array_equal(state["core.cnet_aligner.weight"].numpy(), kernel.T)
    np.testing.assert_array_equal(
        state["core.fnet.convs.0.norm_fn.running_var"].numpy(),
        flat["batch_stats/core/fnet/conv_0/Norm_0/BatchNorm_0/var"],
    )


def test_bridge_is_strict(bridged):
    flat, _, model = bridged
    missing = {k: v for k, v in flat.items() if "cnet_aligner/bias" not in k}
    with pytest.raises(RuntimeError, match="Missing"):
        load_jax_variables(model, missing, "camliraft_l")
    with pytest.raises(KeyError, match="no state_dict name"):
        state_dict_from_jax({**flat, "params/elsewhere/kernel": np.zeros((2, 2))},
                            "camliraft_l")


# --- nn blocks --------------------------------------------------------------


def load_block(torch_block, flax_vars):
    """Carry a standalone flax block's variables into its torch counterpart."""
    state = {}
    for path, value in tree_to_flat(jax.tree.map(np.asarray, flax_vars)).items():
        _, rest = path.split("/", 1)
        state[translate_suffix(rest, "")] = t(value.T if path.endswith("kernel") else value)
    torch_block.load_state_dict(state, strict=True)
    return torch_block.eval()


@pytest.mark.parametrize("norm", [None, "batch_norm"])
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu", "sigmoid", "tanh"])
def test_dense_norm_act(norm, act):
    x = np.random.RandomState(3).randn(2, 5, 7, 6).astype(np.float32)
    block = jlayers.DenseNormAct(4, norm=norm, act=act)
    variables = block.init(jax.random.PRNGKey(0), j(x))
    variables = flat_to_tree(perturb_bn(tree_to_flat(variables), 4))
    ref = np.asarray(block.apply(variables, j(x)))
    got = load_block(tlayers.DenseNormAct(6, 4, norm=norm, act=act), variables)(t(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)


def test_mlp():
    x = np.random.RandomState(5).randn(3, 9, 4).astype(np.float32)
    block = jlayers.MLP([8, 16, 5], norm="batch_norm")
    variables = block.init(jax.random.PRNGKey(1), j(x))
    variables = flat_to_tree(perturb_bn(tree_to_flat(variables), 6))
    ref = np.asarray(block.apply(variables, j(x)))
    got = load_block(tlayers.MLP(4, [8, 16, 5], norm="batch_norm"), variables)(t(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)


def test_point_conv(geometry_consts):
    xyzs1, _, _ = geometry_consts
    xyz, sampled = xyzs1[1], xyzs1[2]  # 256 -> 128
    feats = np.random.RandomState(7).randn(1, 256, 10).astype(np.float32)
    block = jpc.PointConv(12, norm="batch_norm", k=16)
    variables = block.init(jax.random.PRNGKey(2), j(xyz), j(feats), j(sampled))
    variables = flat_to_tree(perturb_bn(tree_to_flat(variables), 8))
    ref = np.asarray(block.apply(variables, j(xyz), j(feats), j(sampled)))
    torch_block = load_block(tpc.PointConv(10, 12, norm="batch_norm", k=16), variables)
    got = torch_block(t(xyz), t(feats), t(sampled)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_point_conv_dw_and_paired(geometry_consts):
    xyzs1, _, knn32 = geometry_consts
    xyz = xyzs1[2]
    feats = np.random.RandomState(9).randn(1, xyz.shape[1], 6).astype(np.float32)
    conv = jpc.PointConvDW(5, act=None, k=4)
    variables = conv.init(jax.random.PRNGKey(3), j(xyz), j(feats), knn_indices=j(knn32))
    ref = np.asarray(conv.apply(variables, j(xyz), j(feats), knn_indices=j(knn32)))
    torch_conv = load_block(tpc.PointConvDW(6, 5, act=None, k=4), variables)
    got = torch_conv(t(xyz), t(feats), knn_indices=t(knn32))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    # paired, as GRU3D's z and r run: one gather of both MLP outputs (stacked
    # into one packed Linear) times both weights, max over k, split ==
    # two separate calls
    other = load_block(tpc.PointConvDW(6, 5, act=None, k=4), conv.init(
        jax.random.PRNGKey(4), j(xyz), j(feats), knn_indices=j(knn32)))
    with torch.inference_mode():
        pair = (torch_conv, other)
        table = update3d.linear_plain(t(feats), update3d.pack_linears(
            *(c.mlp.convs[0].conv_fn for c in pair)))
        weights = torch.cat([c.compute_weights(t(xyz), knn_indices=t(knn32)) for c in pair], -1)
        both = update3d.dw_max_plain(table, t(knn32), weights)
        other_ref = other(t(xyz), t(feats), knn_indices=t(knn32))
    np.testing.assert_allclose(both[..., :5].numpy(), got.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(both[..., 5:].numpy(), other_ref.numpy(), rtol=1e-6, atol=1e-6)


# --- CamLiRAFT-L submodules, through the model bridge ---------------------


def test_encoder3d(bridged, geometry_consts):
    _, tree, model = bridged
    xyzs1, _, _ = geometry_consts
    knn = jm.encoder_knn_indices([j(x) for x in xyzs1[:3]])
    ref = jm.Encoder3D().apply(sub(tree, "core", "fnet"), [j(x) for x in xyzs1[:3]],
                              knn_indices=knn)
    with torch.inference_mode():
        got = model.core.fnet([t(x) for x in xyzs1[:3]],
                              knn_indices=[t(k) for k in knn])
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_cost_volume_pyramid(geometry_consts):
    _, xyzs2, _ = geometry_consts
    rng = np.random.RandomState(10)
    f1 = rng.randn(1, 128, 16).astype(np.float32)
    f2 = rng.randn(1, 128, 16).astype(np.float32)
    ref = jm.build_cost_volume_pyramid_3d(j(f1), j(f2), [j(x) for x in xyzs2[2:]])
    got = tm.build_cost_volume_pyramid_3d(t(f1), t(f2), [t(x) for x in xyzs2[2:]])
    assert len(got) == len(ref) == 4
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def update_consts(bridged, geometry_consts):
    """Inputs of one refinement iteration, on both sides."""
    xyzs1, xyzs2, knn32 = geometry_consts
    rng = np.random.RandomState(11)
    levels = xyzs2[2:]
    pyramid = rng.randn(1, 128, sum(x.shape[1] for x in levels)).astype(np.float32)
    flow = (0.05 * rng.randn(1, 128, 3)).astype(np.float32)
    h = np.tanh(rng.randn(1, 128, 128)).astype(np.float32)
    x = np.maximum(rng.randn(1, 128, 128), 0).astype(np.float32)
    return {"xyz1": xyzs1[2], "xyzs2": levels, "knn_indices": knn32,
            "pyramid": pyramid, "flow": flow, "h": h, "x": x}


def test_correlation3d(bridged, update_consts):
    _, tree, model = bridged
    c = update_consts
    sizes = tuple(x.shape[1] for x in c["xyzs2"])
    warp = c["xyzs2"][0] + 0.01
    ref = jm.Correlation3D().apply(sub(tree, "core", "update", "correlation"),
                                   j(c["xyz1"]), j(warp), sizes, j(c["pyramid"]))
    with torch.inference_mode():
        got = model.core.correlation(t(c["xyz1"]), t(warp), sizes, t(c["pyramid"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def precomputed(tree, c):
    """JAX UpdateBlock3D.precompute: the hoisted PointConvDW weights."""
    return jm.UpdateBlock3D().apply(
        sub(tree, "core", "update"), j(c["xyz1"]), j(c["knn_indices"]),
        method=jm.UpdateBlock3D.precompute,
    )


def test_update_precompute(bridged, update_consts):
    _, tree, model = bridged
    c = update_consts
    ref = tree_to_flat(jax.tree.map(np.asarray, precomputed(tree, c)))
    with torch.inference_mode():
        got = model.core.update.precompute(t(c["xyz1"]), t(c["knn_indices"]))
    got = {f"{a}/{b}": v.numpy() for a, d in got.items() for b, v in d.items()}
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["motion_encoder", "gru", "flow_head"])
def test_update_submodules(bridged, update_consts, name):
    _, tree, model = bridged
    c = update_consts
    dw = precomputed(tree, c)
    dw_t = {a: {b: t(np.asarray(v)) for b, v in d.items()} for a, d in dw.items()}
    rng = np.random.RandomState(12)
    xyz1, knn = j(c["xyz1"]), j(c["knn_indices"])
    variables = sub(tree, "core", "update", name)
    if name == "motion_encoder":
        corr = rng.randn(1, 128, 128).astype(np.float32)
        ref = jm.MotionEncoder3D().apply(variables, xyz1, j(c["flow"]), j(corr), knn,
                                        dw=dw[name])
        args = (t(c["xyz1"]), t(c["flow"]), t(corr), t(c["knn_indices"]), dw_t[name])
    elif name == "gru":
        x = rng.randn(1, 128, 256).astype(np.float32)
        ref = jm.GRU3D().apply(variables, xyz1, j(c["h"]), j(x), knn, dw=dw[name])
        args = (t(c["xyz1"]), t(c["h"]), t(x), t(c["knn_indices"]), dw_t[name])
    else:
        ref = jm.FlowHead3D().apply(variables, xyz1, j(c["h"]), knn, dw=dw[name])
        args = (t(c["xyz1"]), t(c["h"]), t(c["knn_indices"]), dw_t[name])
    with torch.inference_mode():
        got = getattr(model.core, name)(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_update_block_one_iteration(bridged, update_consts):
    _, tree, model = bridged
    c = update_consts
    consts = {"xyz1": j(c["xyz1"]), "xyzs2": [j(x) for x in c["xyzs2"]],
              "knn_indices": j(c["knn_indices"]), "x": j(c["x"]),
              "pyramid": j(c["pyramid"]), "dw": precomputed(tree, c)}
    (h_ref, flow_ref), _ = jm.UpdateBlock3D().apply(
        sub(tree, "core", "update"), (j(c["h"]), j(c["flow"])), consts
    )
    with torch.inference_mode():
        tconsts = {"xyz1": t(c["xyz1"]), "xyzs2": [t(x) for x in c["xyzs2"]],
                   "knn_indices": t(c["knn_indices"]), "x": t(c["x"]),
                   "pyramid": t(c["pyramid"])}
        tconsts["dw"] = model.core.update.precompute(tconsts["xyz1"], tconsts["knn_indices"])
        tconsts["packed"] = model.core.update.pack()
        h, flow = model.core.update(t(c["h"]), t(c["flow"]), tconsts)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(flow.numpy(), np.asarray(flow_ref), rtol=1e-4, atol=1e-5)


# --- the whole model ------------------------------------------------------


@pytest.mark.parametrize("ids", [False, True])
def test_camliraft_l_matches_jax(bridged, ids):
    """Full CamLiRAFT-L eval forward, IDS on and off: flow_3d to 1e-4 m."""
    flat, tree, _ = bridged
    cfgs = small_cfgs(ids)
    inputs = make_inputs(20 + ids, ids=ids)
    model = jm.CamLiRAFTL(cfgs=cfgs, train_mode=False)
    ref = jax.jit(model.apply)(tree, {k: j(v) for k, v in inputs.items()})
    torch_model = model_factory(cfgs)(cfgs).eval()
    load_jax_variables(torch_model, flat, "camliraft_l")
    with torch.inference_mode():
        got = torch_model({k: t(v) for k, v in inputs.items()})
    assert got["flow_3d"].shape == (2, 512, 3)
    assert got["flow_3d_seq"].shape == (1, 2, 512, 3)
    flow, flow_ref = got["flow_3d"].numpy(), np.asarray(ref["flow_3d"])
    np.testing.assert_allclose(flow, flow_ref, rtol=0, atol=1e-4)
    # random-init flows can be small (~5e-4 m without IDS), so the error is
    # also held to a thousandth of the flow's own scale
    assert np.abs(flow - flow_ref).max() <= 1e-3 * np.abs(flow_ref).max()


def test_domain_alignment_matches_jax(bridged):
    flat, tree, model = bridged
    cfgs = small_cfgs(True)
    inputs = make_inputs(30, ids=True)
    rng = np.random.RandomState(31)
    inputs.update({
        "src_mean": rng.randn(2, 3).astype(np.float32),
        "dst_mean": rng.randn(2, 3).astype(np.float32),
        "src_std": (1 + 0.1 * rng.rand(2, 3)).astype(np.float32),
        "dst_std": (1 + 0.1 * rng.rand(2, 3)).astype(np.float32),
    })
    ref = jax.jit(jm.CamLiRAFTL(cfgs=cfgs, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    with torch.inference_mode():
        got = model({k: t(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got["flow_3d"].numpy(), np.asarray(ref["flow_3d"]),
                               rtol=0, atol=1e-4)


def test_fast_inference_key():
    for mode in ("auto", "off", "on"):  # "on": the fast path, ported
        tm.CamLiRAFTL({**small_cfgs(False), "fast_inference": mode})
    with pytest.raises(ValueError):
        tm.CamLiRAFTL({**small_cfgs(False), "fast_inference": "fast"})
    with pytest.raises(NotImplementedError, match="flownet3d"):  # no such model
        model_factory({"name": "flownet3d"})
