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


# --- the CUDA kernel's order, emulated in numpy -----------------------------

THREADS, GROUP_TAPS, MAX_GROUP = 256, 512, 8  # csrc/corr3d_tail.cu


def fma(a, b, c):
    """f32 a * b + c rounded once, as __fmaf_rn (through float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def tail_emulation(xyz1, xyz2, idx, cost, w1, b1, w2, b2, wm, bm, n_levels, k):
    """csrc/corr3d_tail.cu step by step: queries in groups, each group's
    (query, tap) pairs in chunks of 256 threads; per tap h and h2 by fused
    multiply-adds (W1, W2 zero-padded to 32 channels), the level sums
    carried from chunk to chunk in tap order, then the merge in row order.
    All in f32."""
    batch, n = xyz1.shape[:2]
    taps = n_levels * k
    c1, c_out = w2.shape[0], wm.shape[1]
    lc = n_levels * c1
    w1p = np.zeros((4, 32), np.float32)
    w1p[:, :c1] = w1
    w2p = np.zeros((32, 32), np.float32)
    w2p[:c1, :c1] = w2
    b1p, b2p = np.zeros(32, np.float32), np.zeros(32, np.float32)
    b1p[:c1], b2p[:c1] = b1, b2
    q1, q2 = xyz1.reshape(-1, 3), xyz2.reshape(batch, -1, 3)
    idx, cost = idx.reshape(-1, taps), cost.reshape(-1, taps)
    queries = batch * n
    group = min(max(GROUP_TAPS // taps, 1), MAX_GROUP)
    out = np.empty((queries, c_out), np.float32)
    for q0 in range(0, queries, group):
        nq = min(group, queries - q0)
        pairs = nq * taps
        sums = np.zeros((nq, n_levels, c1), np.float32)
        for c0 in range(0, pairs, THREADS):
            p = np.arange(c0, min(c0 + THREADS, pairs))  # the chunk's threads
            q, tap = q0 + p // taps, p % taps
            rel = (q2[q // n, idx[q, tap]] - q1[q]).astype(np.float32)
            cv = cost[q, tap]
            h = fma(w1p[0], rel[:, :1], b1p)
            h = fma(w1p[1], rel[:, 1:2], h)
            h = fma(w1p[2], rel[:, 2:3], h)
            h = np.maximum(fma(w1p[3], cv[:, None], h), 0)
            h2 = np.broadcast_to(b2p, h.shape).astype(np.float32)
            for i in range(32):
                h2 = fma(w2p[i], h[:, i:i + 1], h2)
            rows = np.maximum(h2, 0)
            # (query, level) sums over the level's taps inside this chunk, in order
            qq, lvl = np.meshgrid(np.arange(nq), np.arange(n_levels), indexing="ij")
            first = qq * taps + lvl * k
            lo, hi = np.maximum(first, c0), np.minimum(first + k, c0 + THREADS)
            for t in range(c0, min(c0 + THREADS, pairs)):
                inside = (lo <= t) & (t < hi)
                sums[inside] = (sums[inside] + rows[t - c0, :c1]).astype(np.float32)
        flat = sums.reshape(nq, lc)
        acc = np.zeros((nq, c_out), np.float32)
        for i in range(lc):
            acc = fma(wm[i], flat[:, i:i + 1], acc)
        v = (acc + bm).astype(np.float32)
        out[q0:q0 + nq] = np.where(v > 0, v, np.float32(0.1) * v)
    return out.reshape(batch, n, c_out)


EMULATION_LEVELS = {16: (64, 48, 32, 16), 8: (64, 32, 16),
                    # 8 levels of 6: 48 taps, so a group's 384 pairs take two
                    # chunks and a level straddles the chunks' border
                    6: (64, 56, 48, 40, 32, 24, 16, 8)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [16, 8, 6])
def test_kernel_order_emulation_meets_the_card_tolerance(k, seed):
    """The tap-parallel kernel's order (per-tap h2, level sums in tap order
    across chunks, merge) against the plain version and the Pallas kernel
    (interpret mode), within the card tests' bound max |d| <= 1e-4 * (1 +
    max |plain|): 20 queries in groups of up to 8, batch 2."""
    levels = EMULATION_LEVELS[k]
    n_levels, c1, c_out = len(levels), 32, 128
    rng = np.random.RandomState(90 + 10 * k + seed)
    xyz1 = rng.randn(2, 10, 3).astype(np.float32)
    xyz2 = rng.randn(2, levels[0], 3).astype(np.float32)
    idx = np.concatenate([rng.randint(0, m, size=(2, 10, k)) for m in levels], -1)
    idx = idx.astype(np.int32)
    cost = rng.randn(2, 10, n_levels * k).astype(np.float32)
    layers = [rng.uniform(-b, b, size=s).astype(np.float32) for s, b in (
        ((4, c1), 0.5), ((c1,), 0.5), ((c1, c1), c1 ** -0.5), ((c1,), c1 ** -0.5),
        ((n_levels * c1, c_out), (n_levels * c1) ** -0.5), ((c_out,), 0.1))]
    got = tail_emulation(xyz1, xyz2, idx, cost, *layers, n_levels, k)
    params = corr3d.TailParams(*(torch.from_numpy(a) for a in layers))
    plain = corr3d.corr3d_tail_plain(t(xyz1), t(xyz2), t(idx), t(cost), params, n_levels,
                                     k).numpy()
    pallas = np.asarray(corr3d_tail_pallas(
        jnp.asarray(xyz1), jnp.asarray(xyz2), jnp.asarray(idx), jnp.asarray(cost), None,
        tuple(jnp.asarray(a) for a in layers), n_levels, k, interpret=True))
    assert got.shape == plain.shape == (2, 10, c_out)
    assert np.abs(plain).max() > 0.1  # not a comparison of near-zeros
    for ref in (plain, pallas):
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 * (1 + float(np.abs(ref).max())), err
