"""PyTorch port, PWC: the 2D ops it adds (the full Conv2dNormAct,
correlation2d, backwarp_2d, the align-corners resizes), its blocks and the
whole model against the JAX package through the weight bridge, on the CPU.

One JAX PWC per estimator form is given variables once per file
(`jax_variables`: the JAX init's paths and shapes, seeded values, BatchNorm
away from 0/1), which are carried into the port with
`runtime.checkpoint.load_jax_variables`; the test size is 128x192 images,
bs 2. Both sides are f32; tolerances cover summation order only.
"""

import numpy as np
import jax
import pytest
import torch

from camliflow_tpu.models import factory as jfactory
from camliflow_tpu.models import pwc as jm
from camliflow_tpu.nn import layers as jlayers
from camliflow_tpu.ops import correlation as jcorr
from camliflow_tpu.ops import gridsample as jgs
from camliflow_tpu.ops import image as jimage
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_torch.models import factory
from camliflow_torch.models import pwc as tm
from camliflow_torch.models.factory import model_factory
from camliflow_torch.nn import layers as tlayers
from camliflow_torch.ops import correlation as tcorr
from camliflow_torch.ops import gridsample as tgs
from camliflow_torch.ops import image as timage
from camliflow_torch.runtime.checkpoint import load_jax_variables, relayout, state_dict_from_jax
from camliflow_torch.runtime.names import our_path_to_torch, translate_suffix
from test_torch_camliraft_l import j, perturb_bn, sub, t
from tools import port_checkpoint

torch.set_num_threads(2)

H, W = 128, 192


def pwc_cfgs(lite: bool) -> dict:
    """conf/model/pwc.yaml, with the estimator form chosen."""
    return {"name": "pwc", "max_displacement": 4, "lite_estimator": lite,
            "norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                     "context_network": None}}


def make_images(seed, batch=2, h=H, w=W):
    rng = np.random.RandomState(seed)
    return {"images": rng.randint(0, 255, (batch, h, w, 6)).astype(np.float32)}


def jax_variables(module, cfgs, inputs, seed=0) -> dict:
    """A JAX model's flat variables: the paths and shapes of its init, from
    `jax.eval_shape` (tracing the init, not compiling it: a jitted CamLiPWC
    init compiles for ~40 s on the CPU); the values from a seeded generator
    at the JAX init's scale, kernels U(+-1/sqrt(fan_in)) and biases
    U(+-0.1), with BN away from 0/1."""
    model = module(cfgs=cfgs, train_mode=False)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {k: j(v) for k, v in inputs.items()})
    flat = tree_to_flat(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    rng = np.random.RandomState(seed)
    for key in sorted(flat):
        shape = flat[key].shape
        if key.endswith("/kernel"):
            bound = float(np.prod(shape[:-1])) ** -0.5
            flat[key] = rng.uniform(-bound, bound, shape).astype(np.float32)
        elif key.endswith("/bias"):
            flat[key] = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    return perturb_bn(flat, seed + 1)


def init_bridged(module, cfgs, inputs, name, seed=0):
    """(JAX flat variables, their tree, the port's model filled from them
    through `load_jax_variables`)."""
    flat = jax_variables(module, cfgs, inputs, seed)
    torch_model = model_factory(cfgs)(cfgs).eval()
    load_jax_variables(torch_model, flat, name)
    return flat, flat_to_tree(flat), torch_model


def check_bridge(flat, torch_model, name) -> set[str]:
    """Every JAX variable lands on a state_dict key, under the name
    tools/port_checkpoint.py gives it, and fills every key of the model;
    every parameter takes the optimizer group the JAX package gives it.
    Returns the groups."""
    for path in flat:
        rest = path.split("/", 1)[1]
        assert our_path_to_torch(rest, name) == port_checkpoint.our_path_to_torch(rest, name), path
    state = state_dict_from_jax(flat, name)
    assert set(state) == set(torch_model.state_dict())
    assert len(state) == len(flat)
    params = dict(torch_model.named_parameters())
    groups = set()
    for path, value in flat.items():
        if path.startswith("params/"):
            key = our_path_to_torch(path.split("/", 1)[1], name)
            label = jfactory.param_group_label(tuple(path.split("/")[1:]), value)
            assert factory.param_group_label(key, params[key], name) == label, path
            groups.add(label)
    return groups


def load_block(torch_block, flax_vars, prefix=""):
    """Carry a standalone flax block's variables into its torch counterpart
    (kernels relaid out for Conv2d or Linear by their target's shape)."""
    shapes = {k: tuple(v.shape) for k, v in torch_block.state_dict().items()}
    state = {}
    for path, value in tree_to_flat(jax.tree.map(np.asarray, flax_vars)).items():
        key = translate_suffix(path.split("/", 1)[1], prefix)
        value = np.asarray(value, np.float32)
        state[key] = t(relayout(value, shapes[key]) if path.endswith("kernel") else value)
    torch_block.load_state_dict(state, strict=True)
    return torch_block.eval()


def nhwc_call(block, x):
    with torch.inference_mode():
        return tm.nhwc(block(tm.nchw(t(x)))).numpy()


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "lite"])
def bridged(request):
    lite = request.param
    cfgs = pwc_cfgs(lite)
    return (lite, cfgs) + init_bridged(jm.PWC, cfgs, make_images(0), "pwc", seed=int(lite))


# --- ops ------------------------------------------------------------------


@pytest.mark.parametrize("kernel,stride,dilation,norm,act", [
    (3, 2, 1, "batch_norm", "leaky_relu"),  # a pyramid block's strided conv
    (1, 2, 1, "batch_norm", None),  # its shortcut
    (3, 1, 16, None, "leaky_relu"),  # the context network's widest dilation
    (3, 1, 2, "batch_norm", "relu"),
    (1, 1, 1, None, "leaky_relu"),  # an aligner
])
def test_conv2d_norm_act(kernel, stride, dilation, norm, act):
    """Padding dilation*(k-1)//2 on both sides, on odd sizes under stride 2
    and at level 5's 9x15 map with dilation 16; the bias only without a norm."""
    x = np.random.RandomState(3).randn(2, 9, 15, 5).astype(np.float32)
    block = jlayers.Conv2dNormAct(4, kernel, strides=stride, dilation=dilation, norm=norm,
                                  act=act)
    variables = block.init(jax.random.PRNGKey(0), j(x))
    variables = flat_to_tree(perturb_bn(tree_to_flat(variables), 4))
    ref = np.asarray(block.apply(variables, j(x)))
    torch_block = load_block(tlayers.Conv2dNormAct(5, 4, kernel, stride=stride,
                                                   dilation=dilation, norm=norm, act=act),
                             variables)
    assert (torch_block.conv_fn.bias is None) == (norm is not None)
    got = nhwc_call(torch_block, x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def correlation_loops(a, b, d):
    """The definition, one displacement and pixel at a time."""
    batch, h, w, c = a.shape
    span = 2 * d + 1
    out = np.zeros((batch, h, w, span * span), np.float64)
    for i in range(span):
        for jj in range(span):
            for y in range(h):
                for x in range(w):
                    y2, x2 = y + i - d, x + jj - d
                    if 0 <= y2 < h and 0 <= x2 < w:
                        out[:, y, x, i * span + jj] = (a[:, y, x] * b[:, y2, x2]).mean(-1)
    return out


@pytest.mark.parametrize("shape,d", [((2, 7, 11, 5), 4), ((1, 2, 3, 8), 4),
                                     ((1, 6, 5, 3), 2)])
def test_correlation2d(shape, d):
    """Vertical shift major, zero beyond the borders (the 2x3 map is the test
    size's level 5, smaller than the window): against the JAX function and
    the definition."""
    rng = np.random.RandomState(5)
    a, b = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    got = tcorr.correlation2d(t(a), t(b), d).numpy()
    assert got.dtype == np.float32 and got.shape == shape[:3] + ((2 * d + 1) ** 2,)
    np.testing.assert_allclose(got, np.asarray(jcorr.correlation2d(j(a), j(b), d)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, correlation_loops(a, b, d), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_backwarp_2d(mode):
    """Flows that leave the map by up to 3 widths, and some that land on it."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 8, 3).astype(np.float32)
    flow = (4.0 * rng.randn(2, 6, 8, 2)).astype(np.float32)
    flow[0, :2] *= 6.0  # far outside
    got = timage.backwarp_2d(t(x), t(flow), mode).numpy()
    ref = np.asarray(jimage.backwarp_2d(j(x), j(flow), mode))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if mode == "border":  # a far-away pixel takes the border's value
        assert np.abs(got[0, :2]).max() > 0
    with pytest.raises(ValueError, match="padding_mode"):
        tgs.grid_sample_pixel(t(x), t(flow), padding_mode="reflection")


@pytest.mark.parametrize("shape,out", [((2, 5, 7, 3), (9, 13)), ((1, 9, 15, 2), (18, 30)),
                                       ((1, 12, 10, 4), (7, 5)), ((1, 540, 96, 6), (576, 96))])
def test_resize_bilinear_align_corners(shape, out):
    """Up and down; 540 -> 576 is the full-width images' resize."""
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    got = tgs.resize_bilinear_align_corners(t(x), *out).numpy()
    ref = np.asarray(jgs.resize_bilinear_align_corners(j(x), *out))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_resize_to_multiple():
    rng = np.random.RandomState(8)
    images = rng.randint(0, 255, (2, 120, 184, 6)).astype(np.float32)
    target = rng.randn(2, 120, 184, 2).astype(np.float32)
    got, got_target = timage.resize_to_multiple(t(images), t(target), x=64)
    ref, ref_target = jimage.resize_to_multiple(j(images), j(target), x=64)
    assert got.shape == (2, 128, 192, 6) and got_target.shape == (2, 128, 192, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_target.numpy(), np.asarray(ref_target), rtol=1e-5,
                               atol=1e-5)
    same = t(images[:, :64, :128])
    assert timage.resize_to_multiple(same, None, x=64)[0] is same


# --- PWC's blocks -----------------------------------------------------------


def test_residual_block():
    x = np.random.RandomState(9).randn(2, 9, 15, 6).astype(np.float32)
    block = jm.ResidualBlock(8, norm="batch_norm")
    variables = block.init(jax.random.PRNGKey(1), j(x))
    variables = flat_to_tree(perturb_bn(tree_to_flat(variables), 10))
    ref = np.asarray(block.apply(variables, j(x)))
    got = nhwc_call(load_block(tm.ResidualBlock(6, 8, norm="batch_norm"), variables), x)
    assert got.shape == (2, 5, 8, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_feature_pyramid_2d(bridged):
    _, _, _, tree, model = bridged
    image = np.random.RandomState(11).rand(2, H, W, 3).astype(np.float32)
    ref = jm.FeaturePyramid2D(norm="batch_norm").apply(
        sub(tree, "core", "feature_pyramid"), j(image))
    with torch.inference_mode():
        got = model.core.feature_pyramid(t(image))
    assert [g.shape[1:3] for g in got] == [(H >> i, W >> i) for i in range(1, 7)]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_flow_estimator(bridged):
    lite, _, _, tree, model = bridged
    x = np.random.RandomState(12).randn(1, 8, 12, 147).astype(np.float32)
    cls = jm.FlowEstimatorLite2D if lite else jm.FlowEstimatorDense2D
    ref = cls((147, 128, 128, 96, 64, 32)).apply(sub(tree, "core", "flow_estimator"), j(x))
    with torch.inference_mode():
        got = model.core.flow_estimator(t(x))
    assert got[0].shape[-1] == (96 if lite else 595)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_context_network(bridged):
    """At level 5's 9x15 map of the full-width images, where dilation 16
    pads by more than the map."""
    lite, _, _, tree, model = bridged
    cin = (96 if lite else 595) + 2
    x = np.random.RandomState(13).randn(1, 9, 15, cin).astype(np.float32)
    ref = jm.ContextNetwork2D((cin, 128, 128, 128, 96, 64, 32)).apply(
        sub(tree, "core", "context_network"), j(x))
    with torch.inference_mode():
        got = model.core.context_network(t(x))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_up_mask_head(bridged):
    _, _, _, tree, model = bridged
    x = np.random.RandomState(14).randn(2, 8, 12, 32).astype(np.float32)
    ref = jm.UpMaskHead().apply(sub(tree, "core", "up_mask_head"), j(x))
    with torch.inference_mode():
        got = model.core.up_mask_head(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- the bridge and the whole model -----------------------------------------


def test_bridge(bridged):
    _, _, flat, _, model = bridged
    assert check_bridge(flat, model, "pwc") == {"2d_decay", "2d_no_decay"}
    assert isinstance(model.core.pyramid_feature_aligners[0], torch.nn.Identity)
    assert "core.pyramid_feature_aligners.5.conv_fn.weight" in model.state_dict()


@pytest.mark.parametrize("size", [(H, W), (120, 184)], ids=["multiple", "resized"])
def test_pwc_matches_jax(bridged, size):
    """The whole eval forward, bs 2: flow_2d within 1e-3 px; at 120x184 the
    images are resized up to 128x192 and the flow back."""
    _, cfgs, _, tree, model = bridged
    inputs = make_images(20 + size[0], h=size[0], w=size[1])
    ref = jax.jit(jm.PWC(cfgs=cfgs, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    with torch.inference_mode():
        got = model({k: t(v) for k, v in inputs.items()})
    assert set(got) == {"flow_2d"}
    flow, flow_ref = got["flow_2d"].numpy(), np.asarray(ref["flow_2d"])
    assert flow.shape == (2, *size, 2)
    np.testing.assert_allclose(flow, flow_ref, rtol=0, atol=1e-3)
    assert np.abs(flow_ref).max() > 1e-2  # the check is not vacuous
