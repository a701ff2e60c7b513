"""PyTorch port, kernel #12 (ops/gather.py): the k-major gather's plain
version, `gather_points_fast`, `knn_weighted_sum` and the k-major PointConv
against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through both sides. The gather
moves values without arithmetic, so it is held bit for bit, against the
Pallas kernel in interpret mode too; PointConv's contraction runs over k in
another layout than the Flax module's, so it is held to 1e-5. The CUDA
kernel itself runs only on a card: tests/test_torch_kernels_cuda.py compares
it with these plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.nn.point_conv import PointConv as FlaxPointConv
from camliflow_tpu.ops import geometry as jgeo
from camliflow_tpu.ops import pallas_gather as jgather
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_torch.nn.point_conv import PointConv
from camliflow_torch.ops import gather
from camliflow_torch.runtime.names import translate_suffix

TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32, "bfloat16": torch.bfloat16}


def table(rng, dtype, shape):
    """numpy table of `dtype` values, and the same values as torch."""
    values = jnp.asarray(40 * rng.randn(*shape)).astype(dtype)
    as_torch = torch.from_numpy(np.asarray(values.astype(jnp.float32)))
    return values, as_torch.to(TORCH_DTYPES[dtype])


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4])
def test_gather_kmajor_plain_matches_pallas(dtype, k):
    rng = np.random.RandomState(60 + k)
    data, tdata = table(rng, dtype, (2, 37, 5))
    idx = rng.randint(0, 37, (2, 11, k)).astype(np.int32)
    idx[:, ::3, -1] = idx[:, ::3, 0]  # duplicate neighbours
    ref = jgather.gather_points_kmajor(data, jnp.asarray(idx), interpret=True)
    got = gather.gather_points_kmajor(tdata, torch.from_numpy(idx))
    assert got.dtype == tdata.dtype and got.shape == (2, k, 11, 5)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(got, gather.gather_points_kmajor_plain(tdata, torch.from_numpy(idx)))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_gather_points_fast_and_knn_weighted_sum_match_jax():
    rng = np.random.RandomState(62)
    data = rng.randn(2, 50, 3).astype(np.float32)
    idx = rng.randint(0, 50, (2, 80, 3)).astype(np.int32)
    weights = rng.rand(2, 80, 3).astype(np.float32)
    tdata, tidx = torch.from_numpy(data), torch.from_numpy(idx)
    got = gather.gather_points_fast(tdata, tidx)
    assert got.shape == (2, 80, 3, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jgather.gather_points_fast(jnp.asarray(data),
                                                                        jnp.asarray(idx))))
    ref = jgather.knn_weighted_sum(jnp.asarray(data), jnp.asarray(idx), jnp.asarray(weights))
    np.testing.assert_allclose(
        gather.knn_weighted_sum(tdata, tidx, torch.from_numpy(weights)).numpy(),
        np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batch,m,k,row_bytes,plan", [
    (2, 4096, 16, 396, (48, 396)),  # the encoder's level-0 [xyz, features]
    (2, 2048, 16, 524, (32, 524)),  # level 1
    (8, 4096, 16, 396, (48, 396)),  # the eval CLI's batch
    (2, 4096, 16, 12, (0, 0)),  # xyz: a word a thread
    (1, 8192, 3, 12, (0, 0)),  # the upsample
    (1, 77, 4, 1296, (16, 1296)),  # 324 floats: fewer rows, still 16-byte slabs
    (1, 77, 4, 2000, (12, 2000)),  # too wide for 16 rows
    (1, 10, 4, 100000, (1, gather.SLAB_BYTES)),  # wider than the buffer: pieces
    (1, 1024, 1, 512, (16, 512)),  # few blocks: T lowered to 16
])
def test_gather_plan(batch, m, k, row_bytes, plan):
    """csrc/gather.cu's plan at the main path's calls and at the edges: a
    slab of T >= 16 rows is a whole number of 16-byte chunks and fits the
    staging buffer."""
    got = gather.gather_plan(batch, m, k, row_bytes, 132)
    assert got == plan
    rows, piece = got
    if rows >= 16:
        assert rows % 16 == 0 and rows * piece % 16 == 0
    assert rows * piece <= gather.SLAB_BYTES


def test_probe_cases_on_the_cpu():
    """tools/probe_gather_matrix.py's cases, through the wrapper's plain
    version: the case list itself (the card test runs the kernel on it)."""
    gen = torch.Generator().manual_seed(63)
    for case in gather.PROBE_CASES:
        data, idx, finish, want = gather.probe_case(case, gen, "cpu")
        got = finish(gather.gather_points_kmajor(data, idx))
        assert got.dtype == want.dtype and torch.equal(got, want), case[0]


@pytest.mark.parametrize("norm", [None, "batch_norm"])
def test_point_conv_kmajor_matches_flax(norm):
    """The encoder's PointConv (k-major gathers, contraction "bkmw,bkmc")
    against the Flax PointConv (M-major), 256 -> 128 points, k=16."""
    rng = np.random.RandomState(64)
    xyz = jnp.asarray(rng.randn(1, 256, 3), jnp.float32)
    sampled = xyz[:, :128]
    feats = jnp.asarray(rng.randn(1, 256, 10), jnp.float32)
    knn = jgeo.k_nearest_neighbor(xyz, sampled, 16)
    block = FlaxPointConv(12, norm=norm, k=16)
    variables = block.init(jax.random.PRNGKey(5), xyz, feats, sampled, knn_indices=knn)
    flat = tree_to_flat(jax.tree.map(np.asarray, variables))
    for key in flat:  # BatchNorm statistics away from (0, 1)
        if key.endswith("/mean"):
            flat[key] = (0.1 * rng.randn(*flat[key].shape)).astype(np.float32)
        elif key.endswith("/var"):
            flat[key] = (1 + rng.rand(*flat[key].shape)).astype(np.float32)
    from camliflow_tpu.runtime.checkpoint import flat_to_tree

    ref = block.apply(flat_to_tree(flat), xyz, feats, sampled, knn_indices=knn)
    port = PointConv(10, 12, norm=norm, k=16)
    state = {translate_suffix(path.split("/", 1)[1]):
             torch.from_numpy(np.array(value.T if path.endswith("kernel") else value))
             for path, value in flat.items()}
    port.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = port.eval()(*(torch.from_numpy(np.array(a)) for a in (xyz, feats, sampled)),
                          knn_indices=torch.from_numpy(np.array(knn)))
    assert got.shape == (1, 128, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
