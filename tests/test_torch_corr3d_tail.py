"""PyTorch port, kernel #5 (ops/corr3d.py, the Correlation3D tail): the
port's Correlation3D (#4's plain version, then `corr3d_tail_plain`) against
the Flax Correlation3D on its exact path, and the tail alone against
`corr3d_tail_pallas` in interpret mode, on the CPU.

The same numpy inputs (made from a seed) go through both sides; the Flax
variables are carried into the port by name. Small Gaussian clouds keep the
selection free of near-ties (at IDS scale the JAX package's expanded-form
distances may rank near-ties differently, ROADMAP Queue 3), so both sides
select the same neighbours and the f32 tails agree to 1e-5. Against the
Pallas kernel the tolerances are its own test's (tests/test_pallas_corr3d.py:
rtol 1e-4, atol 1e-5). The CUDA kernel itself runs only on a card:
tests/test_torch_kernels_cuda.py compares it with the plain version.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models.camliraft_l import Correlation3D as FlaxCorrelation3D
from camliflow_tpu.ops.geometry import knn_from_dists, squared_distance
from camliflow_tpu.ops.pallas_corr3d import corr3d_tail_pallas, prepare_corr3d_tail_params
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_torch.models.camliraft_l import Correlation3D
from camliflow_torch.ops import corr3d
from camliflow_torch.runtime.names import translate_suffix

LEVELS = (64, 32, 16)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[(8, 64), (16, 128)], ids=["k8-c64", "k16-c128"])
def case(request):
    """A Flax Correlation3D, its port with the same weights, and inputs."""
    k, out_channels = request.param
    rng = np.random.RandomState(70 + k)
    xyz1 = jnp.asarray(rng.randn(2, 40, 3), jnp.float32)
    xyz2 = jnp.asarray(rng.randn(2, LEVELS[0], 3), jnp.float32)
    pyramid = jnp.asarray(rng.randn(2, 40, sum(LEVELS)), jnp.float32)
    block = FlaxCorrelation3D(out_channels=out_channels, k=k)
    variables = block.init(jax.random.PRNGKey(k), xyz1, xyz2, LEVELS, pyramid)
    port = Correlation3D(n_levels=len(LEVELS), out_channels=out_channels, k=k)
    state = {translate_suffix(path.split("/", 1)[1]): t(value.T if path.endswith("kernel")
                                                         else value)
             for path, value in tree_to_flat(jax.tree.map(np.asarray, variables)).items()}
    port.load_state_dict(state, strict=True)
    return block, variables, port.eval(), (xyz1, xyz2, pyramid)


def test_correlation3d_matches_flax(case):
    block, variables, port, (xyz1, xyz2, pyramid) = case
    ref = block.apply(variables, xyz1, xyz2, LEVELS, pyramid)
    with torch.inference_mode():
        got = port(t(xyz1), t(xyz2), LEVELS, t(pyramid))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_corr3d_tail_plain_matches_pallas(case):
    """The tail alone on one selection: the port's plain version against the
    Pallas kernel (interpret mode), each with its own packing."""
    block, variables, port, (xyz1, xyz2, pyramid) = case
    k = block.k
    dists = squared_distance(xyz1, xyz2)
    idx = jnp.concatenate([knn_from_dists(dists[:, :, :m], k=k) for m in LEVELS], axis=-1)
    offsets = np.repeat(np.cumsum([0] + list(LEVELS[:-1])), k)
    cost = jnp.take_along_axis(pyramid, idx + jnp.asarray(offsets[None, None, :]), axis=2)
    ref = corr3d_tail_pallas(xyz1, xyz2, idx, cost, None,
                             prepare_corr3d_tail_params(variables["params"]), len(LEVELS), k,
                             interpret=True)
    params = corr3d.prepare_corr3d_tail_params(port)
    args = (t(xyz1), t(xyz2), t(idx), t(cost), params, len(LEVELS), k)
    got = corr3d.corr3d_tail_plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(corr3d.corr3d_tail(*args), got)


def test_tail_params_pack_the_module(case):
    _, _, port, _ = case
    params = corr3d.prepare_corr3d_tail_params(port)
    c1, c_out = port.cost_mlp.convs[0].conv_fn.out_features, port.merge.conv_fn.out_features
    assert [tuple(p.shape) for p in params] == [(4, c1), (c1,), (c1, c1), (c1,),
                                                (len(LEVELS) * c1, c_out), (c_out,)]
    assert all(p.is_contiguous() and p.dtype == torch.float32 for p in params)
    np.testing.assert_array_equal(params.wm.numpy(), port.merge.conv_fn.weight.detach().numpy().T)
