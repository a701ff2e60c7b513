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
"""

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
    """GRU3D and FlowHead3D run their tails through `dw_max` (on the CPU its
    plain version), on weights packed by the caller once per request or by
    the module itself: the same results either way, and the plain chain's."""
    xyz, knn, c = cloud
    _, _, dw, (tgru, thead) = gru_flowhead
    dw = dw_to_torch(dw)
    h, x = t(c["h"]), t(np.concatenate([c["x3d"], c["motion"]], -1))
    with torch.inference_mode():
        gru_params = update3d.prepare_gru_3d_params(tgru)
        head_params = update3d.prepare_flow_head_3d_params(thead)
        h_new = tgru(t(xyz), h, x, t(knn), dw, params=gru_params)
        assert torch.equal(h_new, tgru(t(xyz), h, x, t(knn), dw))
        assert torch.equal(h_new, update3d.gru_3d_plain(h, x, t(knn), dw, gru_params))
        delta = thead(t(xyz), h_new, t(knn), dw, params=head_params)
        assert torch.equal(delta, thead(t(xyz), h_new, t(knn), dw))
        assert torch.equal(delta, update3d.flow_head_3d_plain(h_new, t(knn), dw, head_params))
