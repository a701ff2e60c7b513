"""PyTorch port, the building blocks no model uses, against the JAX
package's on the CPU: `InstanceNorm` and `Norm`'s instance_norm,
instance_norm_affine and layer_norm (in `DenseNormAct` and in
`Conv2dNormAct`), `PointNet2`, `FusionAwareInterp` with k > 1 and without a
cache, `FusionAwareInterpCVPR` (its output, and the gradients to its inputs
and weights), and `CLFM` with each `fusion_fn`, in eval and train mode.

The same numpy inputs (from a seed) go through both sides; each JAX
module's variables (its init, every bias, scale and BatchNorm statistic
moved away from its init value) are carried into the port by
`runtime.checkpoint.load_jax_variables(..., model_name=None)`, the weight
bridge for a bare module. Where the port selects neighbours itself, the JAX
side ranks them by the port's per-coordinate distance
(`torch_train_parity.port_selection_rule`), so near-ties pick the same
points. Both sides are f32: outputs and gradients to 1e-5 (summation
order). LayerNorm: Flax takes the variance as E[x^2] - E[x]^2, the port
(`F.layer_norm`) as the mean of squared deviations; on inputs of mean 0.5
and spread 2 the two differ by ~2^-24 (mean^2 + var) / var relative, well
inside 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.nn import clfm as jclfm
from camliflow_tpu.nn import layers as jlayers
from camliflow_tpu.nn import point_conv as jpc
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_torch.nn import clfm as tclfm
from camliflow_torch.nn import layers as tlayers
from camliflow_torch.nn import point_conv as tpc
from camliflow_torch.ops import clfm as tops_clfm
from camliflow_torch.runtime.checkpoint import load_jax_variables
from camliflow_torch.runtime.names import our_path_to_torch
from tools import port_checkpoint
from torch_train_parity import port_selection_rule

torch.set_num_threads(2)

BATCH, HEIGHT, WIDTH, N = 2, 6, 10, 48
TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def moved(flat, seed):
    """Every bias, affine scale and BatchNorm statistic away from its init."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, value in sorted(flat.items()):
        if key.endswith("/var"):
            value = 1.0 + rng.rand(*value.shape)
        elif key.endswith("/scale"):
            value = 1.0 + 0.2 * rng.randn(*value.shape)
        elif key.endswith("/bias") or key.endswith("/mean"):
            value = 0.1 * rng.randn(*value.shape)
        out[key] = np.asarray(value, np.float32)
    return out


def bridged(module, variables, port, seed):
    """(the JAX variables moved, as a tree; the port filled from them)."""
    flat = moved(tree_to_flat(jax.tree.map(np.asarray, variables)), seed)
    load_jax_variables(port, flat, None)
    tree = {}
    for key, value in flat.items():
        node = tree
        *heads, leaf = key.split("/")
        for head in heads:
            node = node.setdefault(head, {})
        node[leaf] = jnp.asarray(value)
    return tree, port


def apply(module, variables, *args, train=False, **kwargs):
    """The JAX module's output and, in train mode, its BatchNorm updates."""
    if train:
        return module.apply(variables, *args, train=True, mutable=["batch_stats"], **kwargs)
    return module.apply(variables, *args, train=False, **kwargs), {}


def check_statistics(port, updates):
    """The port's running statistics after its train forward are the JAX
    module's updates."""
    buffers = dict(port.named_buffers())
    for path, value in tree_to_flat(jax.tree.map(np.asarray, updates)).items():
        key = our_path_to_torch(path.split("/", 1)[1], None)
        np.testing.assert_allclose(buffers[key].numpy(), value, rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# --- norms -------------------------------------------------------------


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("shape", [(BATCH, HEIGHT, WIDTH, 16), (BATCH, N, 16)],
                         ids=["map", "points"])
def test_instance_norm_matches_flax(shape, affine):
    """Per sample over the spatial axes, biased variance, eps 1e-5."""
    rng = np.random.RandomState(1)
    x = (2 * rng.randn(*shape) + 0.5).astype(np.float32)
    module = jlayers.InstanceNorm(affine=affine)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = tlayers.InstanceNorm(16, affine=affine)
    if affine:
        scale, bias = 1 + 0.2 * rng.randn(16), 0.1 * rng.randn(16)
        variables = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                                "bias": jnp.asarray(bias, jnp.float32)}}
        port.load_state_dict({"weight": t(scale).float(), "bias": t(bias).float()})
    else:
        assert not list(port.parameters())
    close(port(t(x)), module.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["instance_norm", "instance_norm_affine", "layer_norm"])
@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_norm_in_a_layer_matches_flax(layer, norm, train):
    """DenseNormAct on channel-last data; Conv2dNormAct (3x3, stride 2) on
    NCHW in the port against NHWC in JAX: the norm over the layer's output
    channels, its affine parameters through the bridge."""
    rng = np.random.RandomState(2)
    x = (2 * rng.randn(BATCH, HEIGHT, WIDTH, 16) + 0.5).astype(np.float32)
    if layer == "dense":
        module = jlayers.DenseNormAct(24, norm=norm)
        port = tlayers.DenseNormAct(16, 24, norm=norm)
        to_port, from_port = (lambda a: a), (lambda a: a)
    else:
        module = jlayers.Conv2dNormAct(24, kernel_size=3, strides=2, norm=norm)
        port = tlayers.Conv2dNormAct(16, 24, kernel_size=3, stride=2, norm=norm)
        to_port, from_port = (lambda a: a.permute(0, 3, 1, 2)), (lambda a: a.permute(0, 2, 3, 1))
    variables = module.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tree, port = bridged(module, variables, port, 4)
    want, updates = apply(module, tree, jnp.asarray(x), train=train)
    assert not updates  # no running statistics
    got = from_port(port.train(train)(to_port(t(x))))
    close(got, want)


def test_norm_names_follow_the_reference_tool():
    """The bridge names the norms' parameters as tools/port_checkpoint.py."""
    for norm in ("instance_norm_affine", "layer_norm"):
        module = jlayers.MLP([8, 8], norm=norm)
        variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 3)))
        for path in tree_to_flat(jax.tree.map(np.asarray, variables)):
            rest = path.split("/", 1)[1]
            assert our_path_to_torch(rest, None) == port_checkpoint.translate_suffix(rest, "")
    with pytest.raises(NotImplementedError):
        tlayers.Norm("group_norm", 8)


# --- PointNet2 -----------------------------------------------------------


def clouds(seed, n=N, m=24, c=10):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(BATCH, n, 3).astype(np.float32)
    return xyz, xyz[:, :m].copy(), rng.randn(BATCH, n, c).astype(np.float32)


@pytest.mark.parametrize("indices", ["given", "selected"])
@pytest.mark.parametrize("norm,train", [(None, False), ("batch_norm", False),
                                        ("batch_norm", True)],
                         ids=["plain", "bn-eval", "bn-train"])
def test_pointnet2_matches_flax(norm, train, indices):
    """MLP over [dxyz, features] of each of 8 neighbours, max over k, at 24
    sampled points of 48; the neighbours given, or selected inside."""
    xyz, sampled, feats = clouds(5)
    module = jpc.PointNet2((16, 32), norm=norm, k=8)
    variables = jax.jit(module.init)(jax.random.PRNGKey(6), jnp.asarray(xyz),
                                     jnp.asarray(feats), jnp.asarray(sampled))
    tree, port = bridged(module, variables, tpc.PointNet2(10, (16, 32), norm=norm, k=8), 7)
    with port_selection_rule():
        from camliflow_tpu.ops.geometry import k_nearest_neighbor

        knn = k_nearest_neighbor(jnp.asarray(xyz), jnp.asarray(sampled), 12)
        kwargs = {"knn_indices": knn} if indices == "given" else {}
        want, updates = jax.jit(lambda *a, **kw: apply(module, tree, *a, train=train, **kw))(
            jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(sampled), **kwargs)
    port_kwargs = {"knn_indices": t(knn)} if indices == "given" else {}
    got = port.train(train)(t(xyz), t(feats), t(sampled), **port_kwargs)
    assert got.shape == (BATCH, 24, 32)
    close(got, want)
    assert bool(updates) == train
    check_statistics(port, updates)


# --- CLFM and its interpolations ----------------------------------------


def fusion_inputs(seed, c2=16, c3=12):
    """Image features, point features and points that project over the map
    (some just outside it)."""
    rng = np.random.RandomState(seed)
    feat_2d = rng.randn(BATCH, HEIGHT, WIDTH, c2).astype(np.float32)
    feat_3d = rng.randn(BATCH, N, c3).astype(np.float32)
    uv = (rng.rand(BATCH, N, 2) * [WIDTH + 2, HEIGHT + 2] - 1).astype(np.float32)
    return uv, feat_2d, feat_3d


@pytest.mark.parametrize("cache", ["given", "built"])
@pytest.mark.parametrize("k", [1, 3])
def test_fusion_aware_interp_matches_flax(k, cache):
    """k nearest points a pixel, their gated features summed; the cache
    passed in, or built by the module (a 2-D KNN of the pixel grid)."""
    uv, feat_2d, feat_3d = fusion_inputs(8)
    args = (jnp.asarray(uv), jnp.asarray(feat_2d), jnp.asarray(feat_3d))
    module = jclfm.FusionAwareInterp(12, k=k)
    with port_selection_rule():
        jcache = jclfm.fusion_interp_cache(args[0], HEIGHT, WIDTH, k)
        variables = jax.jit(module.init)(jax.random.PRNGKey(9), *args, interp_cache=jcache)
        tree, port = bridged(module, variables, tclfm.FusionAwareInterp(12, k=k), 10)
        want = jax.jit(lambda *a, **kw: module.apply(tree, *a, **kw))(
            *args, interp_cache=jcache if cache == "given" else None)
    port_cache = (t(jcache[0]), t(jcache[1])) if cache == "given" else None
    got = port(t(uv), t(feat_2d), t(feat_3d), port_cache)
    if cache == "built":
        idx, offset = tclfm.fusion_interp_cache(t(uv), HEIGHT, WIDTH, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jcache[0]))
        close(offset, jcache[1], 1e-6)
    close(got, want)


@pytest.mark.parametrize("norm,train", [(None, False), ("batch_norm", False),
                                        ("batch_norm", True)],
                         ids=["plain", "bn-eval", "bn-train"])
def test_fusion_aware_interp_cvpr_matches_flax(norm, train):
    """The nearest point's offset, features and image correlation through 3
    layers; the output, the weights' gradients and the inputs' (zero: JAX
    stops them all) of a random projection of the output."""
    uv, feat_2d, feat_3d = fusion_inputs(11)
    args = [jnp.asarray(a) for a in (uv, feat_2d, feat_3d)]
    module = jclfm.FusionAwareInterpCVPR(12, norm=norm)
    variables = jax.jit(module.init)(jax.random.PRNGKey(12), *args)
    tree, port = bridged(module, variables, tclfm.FusionAwareInterpCVPR(16, 12, norm=norm), 13)
    probe = np.random.RandomState(14).randn(BATCH, HEIGHT, WIDTH, 12).astype(np.float32)

    def objective(params, *inputs):
        out, updates = apply(module, {**tree, "params": params}, *inputs, train=train)
        return jnp.sum(out * probe), (out, updates)

    with port_selection_rule():
        (_, (want, updates)), grads = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1, 2, 3), has_aux=True))(tree["params"], *args)
    inputs = [t(a).requires_grad_() for a in (uv, feat_2d, feat_3d)]
    got = port.train(train)(*inputs)
    close(got, want)
    check_statistics(port, updates)
    params = dict(port.named_parameters())
    got_grads = torch.autograd.grad((got * t(probe)).sum(), [*params.values(), *inputs],
                                    allow_unused=True, materialize_grads=True)
    port_grads = dict(zip(params, got_grads))
    for path, g in tree_to_flat(jax.tree.map(np.asarray, grads[0])).items():
        key = our_path_to_torch(path, None)
        want_g = g.T if path.endswith("kernel") else g
        close(port_grads[key], want_g, 1e-4 * (1 + np.abs(want_g).max()))
    for got_g, want_g in zip(got_grads[len(params):], grads[1:]):
        assert not np.any(np.asarray(want_g))
        assert not torch.any(got_g)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fusion_fn", ["add", "concat", "gated", "sk"])
def test_clfm_matches_flax(fusion_fn, train):
    """Both sides' outputs, their BatchNorm updates in train mode, and the
    gradients to both feature inputs (each side's own only: the other
    side's features come in detached) of a random projection."""
    uv, feat_2d, feat_3d = fusion_inputs(15)
    args = [jnp.asarray(a) for a in (uv, feat_2d, feat_3d)]
    module = jclfm.CLFM(16, 12, fusion_fn=fusion_fn, norm="batch_norm")
    with port_selection_rule():
        variables = jax.jit(module.init)(jax.random.PRNGKey(16), *args)
        tree, port = bridged(module, variables,
                             tclfm.CLFM(16, 12, fusion_fn=fusion_fn, norm="batch_norm"), 17)
        rng = np.random.RandomState(18)
        probes = (rng.randn(BATCH, HEIGHT, WIDTH, 16).astype(np.float32),
                  rng.randn(BATCH, N, 12).astype(np.float32))

        def objective(f2d, f3d):
            (o2, o3), updates = apply(module, tree, args[0], f2d, f3d, train=train)
            return jnp.sum(o2 * probes[0]) + jnp.sum(o3 * probes[1]), (o2, o3, updates)

        (_, (want_2d, want_3d, updates)), grads = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(args[1], args[2])
    f2d, f3d = t(feat_2d).requires_grad_(), t(feat_3d).requires_grad_()
    got_2d, got_3d = port.train(train)(t(uv), f2d, f3d)
    close(got_2d, want_2d)
    close(got_3d, want_3d)
    assert bool(updates) == train
    check_statistics(port, updates)
    objective = (got_2d * t(probes[0])).sum() + (got_3d * t(probes[1])).sum()
    for got_g, want_g in zip(torch.autograd.grad(objective, [f2d, f3d]), grads):
        close(got_g, want_g, 1e-4 * (1 + np.abs(np.asarray(want_g)).max()))


def test_clfm_default_is_sk_and_only_sk_packs():
    """The models' CLFM (SK) is the default; the in-loop kernel packs SK
    heads only; an unknown head is refused."""
    assert tclfm.CLFM(16, 12).fusion_fn == "sk"
    assert isinstance(tclfm.CLFM(16, 12).fuse2d, tclfm.SKFusion)
    with torch.no_grad():
        tops_clfm.prepare_clfm_params(tclfm.CLFM(16, 12).requires_grad_(False))
        with pytest.raises(ValueError, match="SK"):
            tops_clfm.prepare_clfm_params(tclfm.CLFM(16, 12, fusion_fn="add"))
    with pytest.raises(ValueError, match="fusion_fn"):
        tclfm.CLFM(16, 12, fusion_fn="max")
