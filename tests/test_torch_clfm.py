"""PyTorch port, kernel #11 (ops/clfm.py, one in-loop CLFM call): the hoisted
operands and `clfm_fused_plain` against the Flax CLFM and against
`clfm_fused_pallas` in interpret mode, on the CPU.

The same numpy inputs (made from a seed) and the same pixel-grid cache (the
JAX one, so that no tie in the 2-D KNN separates the two sides) go through
both; the Flax variables are carried into the port by name. Both sides are
f32, so the fused chain holds to 1e-5. The Pallas kernel computes in bf16:
against it the tolerance is its own test's (tests/test_pallas_clfm.py, atol
5e-2), at a narrow width so that interpret mode stays fast. The CUDA kernel
itself runs only on a card: tests/test_torch_kernels_cuda.py compares it
with the plain version; here its operands are held to the module's weights:
the dense layers' tf32 planes (the tensor-core tile's 3xTF32 split) and the
SK heads' transposed layers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.nn.clfm import CLFM as FlaxCLFM
from camliflow_tpu.nn.clfm import fusion_interp_cache
from camliflow_tpu.ops import pallas_clfm as jclfm
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_torch.nn.clfm import CLFM
from camliflow_torch.ops import clfm, update2d
from camliflow_torch.runtime.names import translate_suffix

BATCH, HEIGHT, WIDTH, N = 2, 8, 12, 64


@pytest.fixture(autouse=True)
def forward_only():
    """The fused kernels' packers and wrappers are forward-only: they refuse
    weights or inputs that require grad while grad mode is on (a gradient
    would be dropped). These tests exercise the eval path, so grad mode is
    off, as it is under the Evaluator's inference_mode."""
    with torch.no_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def make_case(c2, c3, seed):
    """Flax CLFM, its port, inputs (some points project outside the map)
    and the JAX pixel-grid cache."""
    rng = np.random.RandomState(seed)
    feat_2d = jnp.asarray(rng.randn(BATCH, HEIGHT, WIDTH, c2), jnp.float32)
    feat_3d = jnp.asarray(rng.randn(BATCH, N, c3), jnp.float32)
    uv = jnp.asarray(rng.rand(BATCH, N, 2) * [WIDTH + 3, HEIGHT + 3] - 1.5, jnp.float32)
    cache = fusion_interp_cache(uv, HEIGHT, WIDTH)
    block = FlaxCLFM(c2, c3)
    variables = block.init(jax.random.PRNGKey(seed), uv, feat_2d, feat_3d, interp_cache=cache)
    port = CLFM(c2, c3)
    state = {translate_suffix(path.split("/", 1)[1]): t(value.T if path.endswith("kernel")
                                                         else value)
             for path, value in tree_to_flat(jax.tree.map(np.asarray, variables)).items()}
    port.load_state_dict(state, strict=True)
    return block, variables, port.eval(), (uv, feat_2d, feat_3d), cache


def hoisted(port, uv, cache):
    """The port's loop-invariant operands: score, nearest point, taps."""
    score = clfm.hoist_interp_score(port.interp, t(cache[1]))
    return score, t(cache[0]), *clfm.grid_sample_cache(t(uv), HEIGHT, WIDTH)


def test_grid_sample_cache_matches_jax():
    rng = np.random.RandomState(80)
    uv = (rng.rand(BATCH, N, 2) * [WIDTH + 4, HEIGHT + 4] - 2).astype(np.float32)
    idx, weights = clfm.grid_sample_cache(t(uv), HEIGHT, WIDTH)
    ref_idx, ref_w = jclfm.grid_sample_cache(jnp.asarray(uv), HEIGHT, WIDTH)
    assert idx.dtype == torch.int32 and idx.shape == (BATCH, N, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(ref_w))
    assert (weights == 0).any()  # taps outside the map


@pytest.mark.parametrize("c2,c3", [(324, 128), (128, 128)])
def test_clfm_fused_plain_matches_flax(c2, c3):
    block, variables, port, (uv, feat_2d, feat_3d), cache = make_case(c2, c3, 81)
    ref_2d, ref_3d = block.apply(variables, uv, feat_2d, feat_3d, interp_cache=cache)
    with torch.inference_mode():
        params = clfm.prepare_clfm_params(port)
        args = (t(feat_2d), t(feat_3d), *hoisted(port, uv, cache))
        got_2d, got_3d = clfm.clfm_fused_plain(*args, params)
        # the wrapper on CPU tensors is the plain version; the module agrees
        wrapped = clfm.clfm_fused(*args, params)
        mod_2d, mod_3d = port(t(uv), t(feat_2d), t(feat_3d), (t(cache[0]), t(cache[1])))
    assert got_2d.shape == (BATCH, HEIGHT, WIDTH, c2) and got_3d.shape == (BATCH, N, c3)
    np.testing.assert_allclose(got_2d.numpy(), np.asarray(ref_2d), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_3d.numpy(), np.asarray(ref_3d), rtol=1e-5, atol=1e-5)
    assert torch.equal(wrapped[0], got_2d) and torch.equal(wrapped[1], got_3d)
    np.testing.assert_allclose(mod_2d.numpy(), got_2d.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mod_3d.numpy(), got_3d.numpy(), rtol=1e-6, atol=1e-6)


def test_clfm_fused_plain_matches_pallas():
    """Against the TPU kernel (bf16 operands) in interpret mode, each side
    on its own hoisted operands, at C2 = C3 = 16."""
    _, variables, port, (uv, feat_2d, feat_3d), cache = make_case(16, 16, 82)
    params = variables["params"]
    ref_2d, ref_3d = jclfm.clfm_fused_pallas(
        feat_2d, feat_3d, jclfm.hoist_interp_score(params["interp"], cache[1]), cache[0],
        *jclfm.grid_sample_cache(uv, HEIGHT, WIDTH), jclfm.prepare_clfm_params(params),
        interpret=True)
    with torch.inference_mode():
        got_2d, got_3d = clfm.clfm_fused_plain(t(feat_2d), t(feat_3d), *hoisted(port, uv, cache),
                                               clfm.prepare_clfm_params(port))
    np.testing.assert_allclose(got_2d.numpy(), np.asarray(ref_2d), rtol=0, atol=5e-2)
    np.testing.assert_allclose(got_3d.numpy(), np.asarray(ref_3d), rtol=0, atol=5e-2)


def test_prepare_clfm_params_packs_and_rejects_norms():
    params = clfm.prepare_clfm_params(CLFM(324, 128))
    shapes = {key: (params[key].cin, params[key].cout) for key in clfm.DENSE}
    assert shapes == {"out_conv": (128, 128), "align1_2d": (324, 324), "align2_2d": (128, 324),
                      "mlps3d": (324, 324), "align1_3d": (324, 128), "align2_3d": (128, 128)}
    assert params["sk_2d"].mid.shape == (324, 162) and params["sk_2d"].out.shape == (162, 648)
    assert params["mlps3d"].weight.shape == (336, 384)  # padded to the kernel's tiles
    with pytest.raises(ValueError, match="Linear"):
        clfm.prepare_clfm_params(CLFM(16, 16, norm="batch_norm"))


@pytest.mark.parametrize("key", clfm.DENSE)
def test_prepare_clfm_params_splits_each_dense_layer_into_tf32_planes(key):
    """hi and lo are tf32 values (13 low mantissa bits zero), K-major
    ([N_pad, K_pad], the packed f32 weight transposed), zero in the padding,
    hi is the weight rounded to tf32, and hi + lo is the weight to 2^-22
    relative."""
    torch.manual_seed(83)
    conv = clfm.prepare_clfm_params(CLFM(324, 128))[key]
    weight = conv.weight.t()
    assert conv.hi.shape == conv.lo.shape == weight.shape
    assert conv.hi.shape[0] % 64 == 0 and conv.hi.shape[1] % 16 == 0
    assert conv.hi.is_contiguous() and conv.lo.is_contiguous()
    for plane in (conv.hi, conv.lo):
        assert not (plane.view(torch.int32) & 0x1FFF).any()
        assert not plane[conv.cout:].any() and not plane[:, conv.cin:].any()
    assert torch.equal(conv.hi, update2d.tf32_round(weight))
    residue = (conv.hi.double() + conv.lo.double() - weight.double()).abs()
    assert (residue <= 2.0 ** -22 * weight.double().abs()).all()
    assert residue.max() > 0  # lo carries what tf32 drops; hi alone is not the weight


@pytest.mark.parametrize("c2,c3", [(324, 128), (128, 128)])
def test_prepare_clfm_params_transposes_the_sk_heads(c2, c3):
    """The kernel reads fc_mid and fc_out a row of outputs at a time: mid_t
    [C // 2, C] and out_t [2C, C // 2], the Linears' own weights, beside the
    [in, out] layers the plain version multiplies by."""
    port = CLFM(c2, c3)
    params = clfm.prepare_clfm_params(port)
    for key, fusion, c in (("sk_2d", port.fuse2d, c2), ("sk_3d", port.fuse3d, c3)):
        head = params[key]
        assert head.mid_t.shape == (c // 2, c) and head.out_t.shape == (2 * c, c // 2)
        assert head.mid_t.is_contiguous() and head.out_t.is_contiguous()
        assert torch.equal(head.mid_t, head.mid.t()) and torch.equal(head.out_t, head.out.t())
        assert torch.equal(head.mid_t, fusion.fc_mid[0].weight.detach())
        assert torch.equal(head.out_t, fusion.fc_out[0].weight.detach())
