"""PyTorch port, CamLiRAFT: the 2D ops, the ResNet encoder, CLFM, the 2D
update chain and the whole model against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and
its counterpart in camliflow_torch; Flax variables are carried into the
port through the weight bridge, with BatchNorm statistics and scales moved
away from 0/1. The JAX side runs its exact path (`fast_inference: off`).
Both sides are f32, so the tolerances cover summation order, except where
a test holds the port against a bf16 Pallas kernel in interpret mode: there
it uses that kernel's own test tolerances (tests/test_pallas_update2d.py).
The CUDA kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py compares them with these plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import camliraft as jm
from camliflow_tpu.models import raft as jraft
from camliflow_tpu.nn import clfm as jclfm
from camliflow_tpu.nn import resnet as jresnet
from camliflow_tpu.ops import correlation as jcorr
from camliflow_tpu.ops import geometry as jgeo
from camliflow_tpu.ops import gridsample as jgs
from camliflow_tpu.ops import ids as jids
from camliflow_tpu.ops import image as jimage
from camliflow_tpu.ops.pallas_update2d import (
    gru_flowhead_2d_pallas,
    motion_encoder_2d_pallas,
    prepare_gru_flowhead_params,
    prepare_motion_encoder_params,
)
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_torch.models import camliraft as tm
from camliflow_torch.models import raft as traft
from camliflow_torch.models.factory import model_factory
from camliflow_torch.nn import clfm as tclfm
from camliflow_torch.nn import resnet as tresnet
from camliflow_torch.ops import correlation as tcorr
from camliflow_torch.ops import gridsample as tgs
from camliflow_torch.ops import ids as tids
from camliflow_torch.ops import image as timage
from camliflow_torch.ops import knn as tknn
from camliflow_torch.ops import update2d
from camliflow_torch.runtime.checkpoint import (
    load_jax_variables,
    relayout,
    state_dict_from_jax,
)
from camliflow_torch.runtime.names import translate_suffix

torch.set_num_threads(2)

N_SAMPLES = [256, 128, 64, 32, 16]


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


def perturb_bn(flat, seed):
    """Move every BatchNorm's statistics and affine parameters away from
    their init values (a BN bias is a bias beside a scale)."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for key, value in flat.items():
        is_bn_bias = key.endswith("/bias") and key[:-5] + "/scale" in flat
        if key.endswith("/mean") or is_bn_bias:
            out[key] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        elif key.endswith("/var"):
            out[key] = (1.0 + rng.rand(*value.shape)).astype(np.float32)
        elif key.endswith("/scale"):
            out[key] = (1.0 + 0.2 * rng.randn(*value.shape)).astype(np.float32)
    return out


def flax_vars(block, seed, *args, perturb=True):
    """Initialised (and BN-perturbed) variables of a standalone Flax block,
    as (flat dict, tree)."""
    from camliflow_tpu.runtime.checkpoint import flat_to_tree

    variables = block.init(jax.random.PRNGKey(seed), *args)
    flat = tree_to_flat(jax.tree.map(np.asarray, variables))
    if perturb:
        flat = perturb_bn(flat, seed)
    return flat, flat_to_tree(flat)


def load_block(block, flat):
    """Carry a standalone Flax block's flat variables into its port."""
    shapes = {k: tuple(v.shape) for k, v in block.state_dict().items()}
    state = {}
    for path, value in flat.items():
        key = translate_suffix(path.split("/", 1)[1])
        value = np.asarray(value, np.float32)
        if path.endswith("/kernel"):
            value = relayout(value, shapes[key])
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    block.load_state_dict(state, strict=True)
    return block.eval()


def close(got, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


# --- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["perspective", "parallel"])
def test_project_pc2image(mode):
    rng = np.random.RandomState(0)
    pc = rng.randn(2, 50, 3).astype(np.float32)
    pc[..., 2] = np.abs(pc[..., 2]) * 10 + 5
    cam = {"projection_mode": mode, "cx": np.float32([479.5, 470.0]),
           "cy": np.float32([269.5, 260.0]), "f": np.float32([1050.0, 1000.0])}
    ref = jids.project_pc2image(j(pc), {k: j(v) if k != "projection_mode" else v
                                        for k, v in cam.items()})
    got = tids.project_pc2image(t(pc), {k: t(v) if k != "projection_mode" else v
                                        for k, v in cam.items()})
    close(got, ref)


def test_grid_sample_points_in_and_out_of_range():
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 9, 13, 5).astype(np.float32)
    # inside, on the border, partly outside and far outside
    uv = np.concatenate([rng.uniform(0, 12, (2, 40, 1)), rng.uniform(0, 8, (2, 40, 1))], -1)
    uv = np.concatenate([uv, rng.uniform(-2, 15, (2, 40, 2)),
                         np.float32([[[0, 0], [12, 8], [-0.5, 3], [12.5, 8.5]]] * 2)], 1)
    uv = uv.astype(np.float32)
    close(tgs.grid_sample_points(t(feat), t(uv)), jgs.grid_sample_points(j(feat), j(uv)))
    idx, w = tgs.bilinear_taps(t(uv[..., 0]), t(uv[..., 1]), 9, 13)
    jidx, jw = jgs.bilinear_taps(j(uv[..., 0]), j(uv[..., 1]), 9, 13)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(w, jw, atol=0, rtol=0)


def test_input_padder_and_mesh_grid():
    x = np.random.RandomState(2).randn(2, 60, 77, 3).astype(np.float32)
    jp, tp = jimage.InputPadder(x.shape, 8), timage.InputPadder(x.shape, 8)
    assert tp._pad == jp._pad == (1, 2, 0, 4)
    (ref,), (got,) = jp.pad(j(x)), tp.pad(t(x))
    assert got.shape == (2, 64, 80, 3)
    close(got, ref, atol=0, rtol=0)
    close(tp.unpad(got), jp.unpad(ref), atol=0, rtol=0)
    close(timage.mesh_grid(2, 5, 7), jimage.mesh_grid(2, 5, 7), atol=0, rtol=0)


def test_convex_upsample():
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 5, 6, 2).astype(np.float32)
    mask = rng.randn(2, 5, 6, 9 * 4 * 4).astype(np.float32)
    ref = jimage.convex_upsample(j(flow), j(mask), 4)
    got = timage.convex_upsample(t(flow), t(mask), 4)
    assert got.shape == (2, 20, 24, 2)
    close(got, ref)


@pytest.fixture(scope="module")
def fmaps():
    rng = np.random.RandomState(4)
    return (rng.randn(2, 9, 15, 16).astype(np.float32),
            rng.randn(2, 9, 15, 16).astype(np.float32))


def test_all_pairs_correlation_pyramid(fmaps):
    f1, f2 = fmaps  # odd sizes: the pools drop the trailing row/column
    ref = jcorr.all_pairs_correlation_pyramid(j(f1), j(f2), 4)
    got = tcorr.all_pairs_correlation_pyramid(t(f1), t(f2), 4)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    for g, r in zip(got, ref):
        close(g, r)


def test_corr_lookup_2d_matches_split_storage(fmaps):
    f1, f2 = fmaps
    rng = np.random.RandomState(5)
    grid = np.asarray(jimage.mesh_grid(2, 9, 15))
    # fractional, negative and far out-of-range coordinates
    coords = grid + rng.uniform(-4, 4, grid.shape).astype(np.float32)
    coords[0, 0, :3] = [[-30.0, 2.5], [40.0, -11.25], [-5.5, -6.75]]
    coords[1, 4, 7] = [14.999, 8.001]
    pyramid = jcorr.all_pairs_correlation_pyramid(j(f1), j(f2), 4)
    ref = jcorr.corr_lookup_2d(pyramid, j(coords), radius=4, storage="split")
    got = tcorr.corr_lookup_2d([t(np.asarray(p)) for p in pyramid], t(coords), radius=4)
    assert got.shape == (2, 9, 15, 4 * 81)
    close(got, ref)


def test_knn_takes_2d_points():
    """CLFM's pixel-grid KNN: the wrapper's 2-D call (plain version on the
    CPU) against the JAX KNN, by the distances it selects."""
    rng = np.random.RandomState(6)
    uv = (rng.rand(2, 100, 2) * [20, 12]).astype(np.float32)
    grid = np.asarray(jimage.mesh_grid(2, 12, 20)).reshape(2, -1, 2)
    d = np.asarray(jgeo.squared_distance(j(grid), j(uv)))
    got = tknn.k_nearest_neighbor(t(uv), t(grid), 3).numpy()
    ref = np.asarray(jgeo.k_nearest_neighbor(j(uv), j(grid), 3))
    np.testing.assert_allclose(np.take_along_axis(d, got.astype(np.int64), -1),
                               np.take_along_axis(d, ref.astype(np.int64), -1),
                               rtol=1e-4, atol=1e-4)


# --- nn blocks -----------------------------------------------------------------


@pytest.mark.parametrize("depth", [50, 18])
def test_resnet_encoder(depth):
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    block = jresnet.ResNetEncoder2D(depth=depth)
    flat, tree = flax_vars(block, 0, j(x))
    ref = block.apply(tree, j(x))
    got = load_block(tresnet.ResNetEncoder2D(depth=depth), flat)(t(x))
    assert got.shape == (2, 8, 8, 128)
    close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("norm,c2d", [("batch_norm", 16), (None, 324)])
def test_clfm(norm, c2d):
    rng = np.random.RandomState(8)
    feat_2d = rng.randn(2, 6, 10, c2d).astype(np.float32)
    feat_3d = rng.randn(2, 40, 12).astype(np.float32)
    uv = (rng.rand(2, 40, 2) * [10, 6] - 0.5).astype(np.float32)
    block = jclfm.CLFM(c2d, 12, norm=norm)
    flat, tree = flax_vars(block, 1, j(uv), j(feat_2d), j(feat_3d))
    ref_2d, ref_3d = block.apply(tree, j(uv), j(feat_2d), j(feat_3d))
    port = load_block(tclfm.CLFM(c2d, 12, norm=norm), flat)
    cache = tclfm.fusion_interp_cache(t(uv), 6, 10)
    got_2d, got_3d = port(t(uv), t(feat_2d), t(feat_3d), cache)
    close(got_2d, ref_2d, atol=1e-5, rtol=1e-4)
    close(got_3d, ref_3d, atol=1e-5, rtol=1e-4)
    # the cache's offsets are the JAX cache's (indices may differ only on ties)
    _, ref_off = jclfm.fusion_interp_cache(j(uv), 6, 10)
    close(torch.linalg.vector_norm(cache[1], dim=-1),
          np.linalg.norm(np.asarray(ref_off), axis=-1))


@pytest.fixture(scope="module")
def update_inputs():
    rng = np.random.RandomState(9)
    shape = (2, 7, 9)
    return {"flow": 2 * rng.randn(*shape, 2), "corr": rng.randn(*shape, 36),
            "h": np.tanh(rng.randn(*shape, 32)), "x2d": np.maximum(rng.randn(*shape, 32), 0),
            "motion": rng.randn(*shape, 32)}


def as32(d):
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def test_motion_encoder_2d_matches_flax_and_pallas(update_inputs):
    c = as32(update_inputs)
    block = jraft.MotionEncoder2D()
    flat, tree = flax_vars(block, 2, j(c["flow"]), j(c["corr"]), perturb=False)
    ref = block.apply(tree, j(c["flow"]), j(c["corr"]))
    port = load_block(traft.MotionEncoder2D(corr_channels=36), flat)
    got = port(t(c["flow"]), t(c["corr"]))
    assert got.shape == (2, 7, 9, 128)
    close(got, ref)
    # the Pallas kernel (bf16 operands), at its own test's tolerance
    pallas = motion_encoder_2d_pallas(j(c["flow"]), j(c["corr"]),
                                      prepare_motion_encoder_params(tree["params"]),
                                      7, 9, interpret=True)
    close(got, pallas, atol=6e-2, rtol=0)
    # the wrapper on CPU tensors is the same plain chain, weights hoisted
    params = update2d.prepare_motion_encoder_params(port)
    close(update2d.motion_encoder_2d(t(c["flow"]), t(c["corr"]), params), got.numpy(),
          atol=0, rtol=0)


def test_gru_flowhead_2d_matches_flax_and_pallas(update_inputs):
    c = as32(update_inputs)
    x = np.concatenate([c["x2d"], c["motion"]], -1)
    gru, head = jraft.GRU2D(hidden_dim=32), jraft.FlowHead2D(hidden_dim=64)
    gflat, gtree = flax_vars(gru, 3, j(c["h"]), j(x), perturb=False)
    hflat, htree = flax_vars(head, 4, j(c["h"]), perturb=False)
    h_ref = gru.apply(gtree, j(c["h"]), j(x))
    d_ref = head.apply(htree, h_ref)
    tgru = load_block(traft.GRU2D(hidden_dim=32, input_dim=64), gflat)
    thead = load_block(traft.FlowHead2D(input_dim=32, hidden_dim=64), hflat)
    h_got = tgru(t(c["h"]), t(x))
    d_got = thead(h_got)
    close(h_got, h_ref)
    close(d_got, d_ref)
    h_pal, d_pal = gru_flowhead_2d_pallas(
        j(c["h"]), j(c["x2d"]), j(c["motion"]),
        prepare_gru_flowhead_params(gtree["params"], htree["params"]), 7, 9, interpret=True)
    close(h_got, h_pal, atol=3e-2, rtol=0)
    close(d_got, d_pal, atol=6e-2, rtol=0)
    params = update2d.prepare_gru_flowhead_params(tgru, thead)
    h_w, d_w = update2d.gru_flowhead_2d(t(c["h"]), t(c["x2d"]), t(c["motion"]), params)
    close(h_w, h_got.numpy(), atol=0, rtol=0)
    close(d_w, d_got.numpy(), atol=0, rtol=0)


def test_convex_upsampler_2d():
    rng = np.random.RandomState(10)
    h = rng.randn(1, 5, 6, 128).astype(np.float32)
    flow = rng.randn(1, 5, 6, 2).astype(np.float32)
    block = jraft.ConvexUpsampler2D()
    flat, tree = flax_vars(block, 5, j(h), j(flow), perturb=False)
    got = load_block(traft.ConvexUpsampler2D(), flat)(t(h), t(flow))
    close(got, block.apply(tree, j(h), j(flow)))


# --- the whole model -------------------------------------------------------------


def small_cfgs(**overrides):
    cfgs = {"name": "camliraft", "backbone": {"depth": 50}, "n_iters_eval": 2,
            "fast_inference": "off", "fuse_fnet": True, "fuse_cnet": True,
            "fuse_corr": True, "fuse_motion": True, "fuse_hidden": False,
            "n_samples_list": N_SAMPLES}
    return {**cfgs, **overrides}


def make_inputs(seed, h=60, w=76, n=512):
    """bench.py's recipe at a small size: 60x76 pads to 64x80."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(1, h, w, 6)).astype(np.float32)
    pc1 = rng.randn(1, n, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(1, n, 3).astype(np.float32)
    return {"images": images, "pcs": np.concatenate([pc1, pc2], -1),
            "intrinsics": np.float32([[100.0, (w - 1) / 2, (h - 1) / 2]])}


def scale_update_heads(flat, factor=4.0):
    """Larger flow-head weights, so that the random-init model predicts
    flows of a few pixels and the comparison is not of near-zeros."""
    out = dict(flat)
    for key in flat:
        if "flow_head" in key and key.endswith("/kernel"):
            out[key] = flat[key] * factor
    return out


@pytest.fixture(scope="module")
def flagship():
    """(flat JAX variables, JAX model, tree) of a small CamLiRAFT."""
    from camliflow_tpu.runtime.checkpoint import flat_to_tree

    cfgs = small_cfgs()
    model = jm.CamLiRAFT(cfgs=cfgs, train_mode=False)
    inputs = make_inputs(0)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    {k: j(v) for k, v in inputs.items()})
    flat = scale_update_heads(perturb_bn(tree_to_flat(jax.tree.map(np.asarray, variables)), 11))
    return flat, model, flat_to_tree(flat)


def test_bridge_lands_every_leaf(flagship):
    flat, _, _ = flagship
    model = tm.CamLiRAFT(small_cfgs())
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = state_dict_from_jax(flat, "camliraft", shapes)
    assert set(state) == set(shapes) and len(state) == len(flat)
    kernel = flat["params/core/update/gru_2d/convz1/kernel"]  # [1, 5, I, O]
    np.testing.assert_array_equal(state["core.branch_2d.gru.convz1.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["core.branch_2d.fnet.layer1.0.downsample.1.running_var"].numpy(),
        flat["batch_stats/core/fnet_2d/layer1_0/downsample_bn/var"])
    # a Dense kernel lands in a Linear, or in a 1x1 Conv2d where asked
    dense = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(relayout(dense), dense.T)
    assert relayout(dense, (3, 2, 1, 1)).shape == (3, 2, 1, 1)
    with pytest.raises(ValueError):
        relayout(dense, (2, 3))


def test_camliraft_matches_jax(flagship):
    """Full eval forward at 60x76 (padded to 64x80), 512 points, 2 iterations:
    flow_2d to 1e-3 px, flow_3d to 1e-4 m."""
    flat, model, tree = flagship
    inputs = make_inputs(1)
    ref = jax.jit(model.apply)(tree, {k: j(v) for k, v in inputs.items()})
    port = model_factory(small_cfgs())(small_cfgs()).eval()
    load_jax_variables(port, flat, "camliraft")
    with torch.inference_mode():
        got = port({k: t(v) for k, v in inputs.items()})
    assert got["flow_2d"].shape == (1, 60, 76, 2)
    assert got["flow_3d"].shape == (1, 512, 3)
    assert got["flow_2d_seq"].shape == (1, 1, 60, 76, 2)
    flow_2d, ref_2d = got["flow_2d"].numpy(), np.asarray(ref["flow_2d"])
    assert np.abs(ref_2d).max() > 0.1  # the comparison is not of near-zeros
    np.testing.assert_allclose(flow_2d, ref_2d, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["flow_3d"].numpy(), np.asarray(ref["flow_3d"]),
                               rtol=0, atol=1e-4)


def test_camliraft_fuse_hidden_runs_the_plain_modules(flagship, monkeypatch):
    """fuse_hidden=True (off in the shipped config): CLFM sits between the
    GRUs and the flow heads, where the JAX package runs the plain modules;
    the port runs GRU2D and FlowHead2D as #8's two halves (`gru_2d`,
    `flow_head_2d`, on weights packed once per request, never the modules'
    own repacking forwards), and matches the JAX model."""
    cfgs = small_cfgs(fuse_hidden=True, n_iters_eval=2)
    model = jm.CamLiRAFT(cfgs=cfgs, train_mode=False)
    inputs = make_inputs(2)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), {k: j(v) for k, v in inputs.items()})
    flat = tree_to_flat(jax.tree.map(np.asarray, variables))
    ref = jax.jit(model.apply)(variables, {k: j(v) for k, v in inputs.items()})
    port = tm.CamLiRAFT(cfgs).eval()
    load_jax_variables(port, flat, "camliraft")
    calls = {"gru_2d": 0, "flow_head_2d": 0, "prepare": 0}

    def counted(key, fn):
        def run(*args):
            calls[key] += 1
            return fn(*args)
        return run

    for key in ("gru_2d", "flow_head_2d"):
        monkeypatch.setattr(update2d, key, counted(key, getattr(update2d, key)))
    monkeypatch.setattr(update2d, "prepare_gru_params",
                        counted("prepare", update2d.prepare_gru_params))
    for module in (traft.GRU2D, traft.FlowHead2D):
        monkeypatch.setattr(module, "forward", lambda *a: pytest.fail("a plain module ran"))
    with torch.inference_mode():
        got = port({k: t(v) for k, v in inputs.items()})
    assert calls == {"gru_2d": 2, "flow_head_2d": 2, "prepare": 1}
    np.testing.assert_allclose(got["flow_2d"].numpy(), np.asarray(ref["flow_2d"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["flow_3d"].numpy(), np.asarray(ref["flow_3d"]),
                               rtol=0, atol=1e-4)


def test_config_keys():
    for mode in ("auto", "off"):
        tm.CamLiRAFT(small_cfgs(fast_inference=mode, backbone={"depth": 18}))
    for storage in ("auto", "split"):
        tm.CamLiRAFT(small_cfgs(lookup_storage=storage, backbone={"depth": 18}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.CamLiRAFT(small_cfgs(fast_inference="on"))
    for storage in ("bf16", "int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.CamLiRAFT(small_cfgs(lookup_storage=storage))
    with pytest.raises(ValueError):
        tm.CamLiRAFT(small_cfgs(lookup_storage="fp8"))
