"""PyTorch port, the fast-inference path (`fast_inference: on`, and
`lookup_storage: bf16|int8`) against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function with
its default fast path (its Pallas kernels in interpret mode, as its own
tests run them) and through the port's plain versions, which the CUDA
kernels' fast forms equal on a card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). The whole-model tests pin the JAX package's two gated
switches off, CAMLIFLOW_UPDATE3D=0 and CAMLIFLOW_CLFM=0 (tests/conftest.py
sets CAMLIFLOW_UPDATE3D=1 for the suite, and the port reads both too): both
sides then run the same form, and the fast-vs-JAX-fast bounds are like for
like. The gated forms are tests/test_torch_gated_forms.py's. Each tolerance
is stated beside its comparison. The fast path rounds to bf16 and int8, so
where the two sides' f32 sums differ in their last bit a rounding can flip:
one bf16 step (at most 2^-7 of the value) or one int8 step (the row's
scale).
"""

import flax.linen as fnn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import camliraft as jflag
from camliflow_tpu.models import camliraft_l as jl
from camliflow_tpu.models import raft as jraft
from camliflow_tpu.nn import point_conv as jpc
from camliflow_tpu.ops import correlation as jcorr
from camliflow_tpu.ops import geometry as jgeo
from camliflow_tpu.ops.pallas_corr3d import correlation3d_knn_pallas
from camliflow_tpu.ops.pallas_update2d import (
    gru_flowhead_2d_pallas,
    motion_encoder_2d_pallas,
    prepare_gru_flowhead_params,
    prepare_motion_encoder_params,
    update_2d_pallas,
)
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_torch.models import camliraft as tflag
from camliflow_torch.models import camliraft_l as tl
from camliflow_torch.models import raft as traft
from camliflow_torch.nn import point_conv as tpc
from camliflow_torch.ops import corr3d, update2d, update3d
from camliflow_torch.ops import correlation as tcorr
from camliflow_torch.ops import geometry as tgeo
from camliflow_torch.runtime.checkpoint import load_jax_variables
from tests.test_torch_camliraft_l import load_block as load_point_block
from tests.test_torch_raft import load_block, perturb_bn

torch.set_num_threads(2)

N_SAMPLES = [256, 128, 64, 32, 16]
BF16_STEP = 2.0**-7  # one bf16 rounding step, relative to the value, at most


@pytest.fixture(autouse=True)
def forward_only():
    """The fast forms are forward-only, as the Evaluator runs them."""
    with torch.no_grad():
        yield


def j(a):
    return jnp.asarray(np.asarray(a))


def t(a):
    return torch.from_numpy(np.array(a))


# --- storage ------------------------------------------------------------------------


def test_quantize_rows_int8_matches_jax_bit_for_bit():
    """The int8 values and the scales, bit for bit: random rows of several
    magnitudes, an all-zero row (the 1e-12 floor) and rows whose values
    fall exactly halfway between two steps (ties to even)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(8, 40) * np.float32([[1], [1e-3], [30], [1], [1], [7], [1], [1]])).astype(
        np.float32)
    x[1] = 0.0
    ties = np.float32([-5.5, -4.5, -3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 4.5, 5.5])
    x[3, :] = 0.0
    x[3, 0], x[3, 1:13] = 127.0, ties  # scale exactly 1
    x[4, :] = 0.0
    x[4, 0], x[4, 1:13] = -254.0, 2.0 * ties  # scale exactly 2
    q_ref, s_ref = jgeo.quantize_rows_int8(j(x))
    q, s = tgeo.quantize_rows_int8(t(x))
    assert q.dtype == torch.int8 and s.shape == (8, 1)
    assert np.float32(s[3, 0]) == 1.0 and np.float32(s[4, 0]) == 2.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert not q[1].any() and s[1, 0] > 0  # the floor
    np.testing.assert_array_equal(q[3, 1:13].numpy(), [-6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6])


@pytest.fixture(scope="module")
def features_2d():
    rng = np.random.RandomState(1)
    f1 = rng.randn(2, 10, 13, 16).astype(np.float32)
    f2 = rng.randn(2, 10, 13, 16).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(13), np.arange(10)), -1).astype(np.float32)
    coords = grid[None] + 3.0 * rng.randn(2, 10, 13, 2).astype(np.float32)
    return f1, f2, coords


def _levels_hw(level):
    return level[0].shape[1:3] if isinstance(level, tuple) else level.shape[1:3]


@pytest.mark.parametrize("storage", ["int8", "bf16"])
def test_lookup_storage_matches_jax(features_2d, storage):
    """Each level built against pooled frame-2 features and stored, then the
    windowed lookup, against `padded_pyramid_from_features` and
    `corr_lookup_2d_padded`. int8: each output within one quantisation
    step of its row (a step of a stored value moves a convex blend by at
    most the step); bf16: within 2^-8 of the row's largest magnitude."""
    f1, f2, coords = features_2d
    ref_pyr = jcorr.padded_pyramid_from_features(j(f1), j(f2), 4, 4, storage=storage)
    ref = np.asarray(jcorr.corr_lookup_2d_padded(ref_pyr, j(coords), 4, storage=storage))
    pyr = tcorr.correlation_pyramid(t(f1), t(f2), 4, storage)
    got = tcorr.corr_lookup_2d(pyr, t(coords), 4).numpy()
    assert got.shape == ref.shape == (2, 10, 13, 4 * 81)
    rows = 2 * 10 * 13
    for i, (level, ref_level) in enumerate(zip(pyr, ref_pyr)):
        h, w = _levels_hw(level)
        block = np.s_[..., 81 * i: 81 * (i + 1)]
        diff = np.abs(got[block] - ref[block]).reshape(rows, 81)
        if storage == "int8":
            q, scale = level
            q_ref, scale_ref = (np.asarray(a) for a in ref_level)
            if q_ref.shape[1:] != (h, w):  # the JAX package's w-major layout
                q_ref = q_ref.transpose(0, 2, 1)
            np.testing.assert_allclose(scale.numpy(), scale_ref, rtol=1e-5)
            assert np.abs(q.numpy().reshape(rows, h, w).astype(int) - q_ref).max() <= 1
            assert (diff <= 1.0001 * scale.numpy()[:, None] + 1e-7).all()
        else:
            values = level.float().numpy().reshape(rows, h * w)
            row_max = np.abs(values).max(axis=1)
            assert (diff <= 2.0**-8 * row_max[:, None] + 1e-7).all()
    # the f32 storage is the exact pyramid
    assert tcorr.resolve_lookup_storage("auto", fast=False) == "split"
    assert tcorr.resolve_lookup_storage("auto", fast=True) == "int8"
    assert tcorr.resolve_lookup_storage("bf16", fast=False) == "bf16"
    with pytest.raises(ValueError):
        tcorr.resolve_lookup_storage("fp8")


def test_resolve_fast_inference():
    """`on` is fast in eval only, `auto` is exact off a TPU, `off` exact."""
    assert tgeo.resolve_fast_inference("on", True)
    assert not tgeo.resolve_fast_inference("on", False)
    assert not tgeo.resolve_fast_inference("auto", True)
    assert not tgeo.resolve_fast_inference("off", True)
    with pytest.raises(ValueError):
        tgeo.resolve_fast_inference("fast", True)


# --- the 3D branch ----------------------------------------------------------------


@pytest.fixture(scope="module")
def camliraft_l():
    """(flat JAX variables, JAX tree, exact and fast cfgs) of a small
    CamLiRAFT-L with IDS, its BatchNorms moved away from 0/1."""
    cfgs = {"name": "camliraft_l", "n_iters_eval": 3, "ids": {"enabled": True},
            "fast_inference": "off", "n_samples_list": N_SAMPLES}
    inputs = l_inputs(0)
    model = jl.CamLiRAFTL(cfgs=cfgs, train_mode=False)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    {k: j(v) for k, v in inputs.items()})
    flat = perturb_bn(tree_to_flat(jax.tree.map(np.asarray, variables)), 1)
    return flat, flat_to_tree(flat), cfgs


def l_inputs(seed, batch=2, n=512):
    rng = np.random.RandomState(seed)
    pc1 = rng.randn(batch, n, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(batch, n, 3).astype(np.float32)
    return {"pcs": np.concatenate([pc1, pc2], -1),
            "intrinsics": np.tile([1050.0, 479.5, 269.5], (batch, 1)).astype(np.float32)}


def sub(tree, *path):
    out = {}
    for coll in ("params", "batch_stats"):
        node = tree.get(coll, {})
        for p in path:
            node = node.get(p, {})
        if node:
            out[coll] = node
    return out


def test_correlation3d_fast_matches_jax(camliraft_l):
    """The int8 pyramid: #4's plain version selects the same distances as
    the JAX kernel (distances, not indices: near-ties at the expanded
    distance form can swap two indices) and reads the int8 values exactly;
    Correlation3D fast (#5 with the scale) within 1e-5 of JAX `fast=True`."""
    _, tree, cfgs = camliraft_l
    rng = np.random.RandomState(3)
    xyz1 = rng.randn(1, 128, 3).astype(np.float32)
    warp = rng.randn(1, 128, 3).astype(np.float32)
    sizes = (128, 64, 32, 16)
    pyramid = rng.randn(1, 128, sum(sizes)).astype(np.float32)
    q, scale = tgeo.quantize_rows_int8(t(pyramid))
    idx_ref, cost_ref = correlation3d_knn_pallas(j(xyz1), j(warp), j(q.numpy()), sizes, k=16)
    idx, cost = corr3d.correlation3d_knn(t(xyz1), t(warp), q, sizes, k=16)
    assert cost.dtype == torch.float32

    def selected(index):
        picked = np.take_along_axis(warp[:, None].repeat(128, 1), np.asarray(index)[..., None]
                                    .astype(np.int64).repeat(3, -1), axis=2)
        return np.sort(((picked - xyz1[:, :, None]) ** 2).sum(-1).reshape(1, 128, 4, 16), -1)

    np.testing.assert_allclose(selected(idx.numpy()), selected(idx_ref), rtol=1e-6, atol=1e-9)
    columns = idx.long() + corr3d.level_offsets(sizes, 16)
    np.testing.assert_array_equal(cost.numpy(), torch.gather(q, 2, columns).float().numpy())
    np.testing.assert_array_equal(np.asarray(cost_ref), cost.numpy())

    variables = sub(tree, "core", "update", "correlation")
    ref = jl.Correlation3D().apply(variables, j(xyz1), j(warp), sizes, j(q.numpy()),
                                   fast=True, pyramid_scale=j(scale.numpy()))
    port = tl.CamLiRAFTL(cfgs).eval()
    load_jax_variables(port, tree_to_flat(tree), "camliraft_l")
    got = port.core.correlation(t(xyz1), t(warp), sizes, q, None, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_point_conv_dw_and_paired_fast_match_jax():
    """PointConvDW and paired_dw_conv with `fast`: the MLP output and the
    weights in bf16, bf16 products, max over k, as f32; within one bf16
    step of the JAX values (the f32 MLPs and weight nets round in their
    last bit differently, which can flip one bf16 rounding)."""
    rng = np.random.RandomState(4)
    xyz = rng.randn(1, 96, 3).astype(np.float32)
    feats = rng.randn(1, 96, 6).astype(np.float32)
    knn = np.asarray(jgeo.k_nearest_neighbor(j(xyz), j(xyz), 8))

    class Pair(fnn.Module):
        @fnn.compact
        def __call__(self, xyz, feats, knn, fast=False):
            a = jpc.PointConvDW(5, act=None, k=4, name="a")
            b = jpc.PointConvDW(7, k=4, name="b")
            return jpc.paired_dw_conv(a, b, xyz, feats, knn, fast=fast)

    pair = Pair()
    variables = pair.init(jax.random.PRNGKey(5), j(xyz), j(feats), j(knn))
    ref_a, ref_b = pair.apply(variables, j(xyz), j(feats), j(knn), fast=True)
    conv_a = load_point_block(tpc.PointConvDW(6, 5, act=None, k=4),
                              {"params": variables["params"]["a"]})
    conv_b = load_point_block(tpc.PointConvDW(6, 7, k=4), {"params": variables["params"]["b"]})
    single = conv_a(t(xyz), t(feats), knn_indices=t(knn), fast=True)
    got_a, got_b = tpc.paired_dw_conv(conv_a, conv_b, t(xyz), t(feats), t(knn), fast=True)
    assert single.dtype == torch.float32
    np.testing.assert_array_equal(single.numpy(), got_a.numpy())
    for got, ref in ((got_a, ref_a), (got_b, ref_b)):
        ref = np.asarray(ref)
        assert (np.abs(got.numpy() - ref) <= BF16_STEP * np.abs(ref) + 1e-30).all()
        # the values are bf16 values
        np.testing.assert_array_equal(got.numpy(), got.bfloat16().float().numpy())


def test_update3d_fast_plain_forms(camliraft_l):
    """#6's, #7's and #13's plain fast forms against the PointConvDW chains
    with `fast` (the modules the JAX package runs), on the hoisted weights
    stored bf16 (`to_bf16` keeps the merge conv's padded rows): bit for bit
    where both sides compute the same f32 tables (#13, #7 against its
    unfused chain); #6 within one bf16 step of its largest value, since its
    MLPs there run as the modules' own Linears, whose f32 sums may differ in
    the last bit from the packed ones and flip a bf16 rounding."""
    _, tree, cfgs = camliraft_l
    port = tl.CamLiRAFTL(cfgs).eval()
    load_jax_variables(port, tree_to_flat(tree), "camliraft_l")
    rng = np.random.RandomState(6)
    xyz = rng.randn(1, 128, 3).astype(np.float32)
    knn = tgeo.k_nearest_neighbor(t(xyz), t(xyz), 32)
    dw = port.core.update.precompute(t(xyz), knn, fast=True)
    merge = dw["motion_encoder"]["conv"]
    assert merge.dtype == torch.bfloat16 and merge.stride()[2:] == (128, 1)
    exact = port.core.update.precompute(t(xyz), knn)
    for name in dw:
        for key in dw[name]:
            np.testing.assert_array_equal(dw[name][key].float().numpy(),
                                          exact[name][key].bfloat16().float().numpy())
    flow = t(0.05 * rng.randn(1, 128, 3).astype(np.float32))
    corr = t(rng.randn(1, 128, 128).astype(np.float32))
    me = update3d.prepare_motion_encoder_3d_params(port.core.motion_encoder)
    got = update3d.motion_encoder_3d(flow, corr, knn, dw["motion_encoder"], me)
    encoder = port.core.motion_encoder

    def conv(name, features):
        return getattr(encoder, name)(t(xyz), features, knn_indices=knn,
                                      weights=dw["motion_encoder"][name], fast=True)

    ref = conv("conv", torch.cat([conv("conv_c1", corr), conv("conv_f2", conv("conv_f1", flow))],
                                 -1))
    np.testing.assert_allclose(got[..., :125].numpy(), ref.numpy(), rtol=0,
                               atol=BF16_STEP * float(ref.abs().max()))
    # #13's plain form, and #7's through it
    table = t(rng.randn(1, 128, 64).astype(np.float32))
    weights = t(rng.randn(1, 128, 32, 64).astype(np.float32)).bfloat16()
    out = update3d.dw_max(table, knn, weights)
    gathered = tgeo.gather_points(table.bfloat16(), knn) * weights
    np.testing.assert_array_equal(out.numpy(), gathered.amax(2).float().numpy())
    h = t(np.tanh(rng.randn(1, 128, 128)).astype(np.float32))
    x3d, motion = t(rng.randn(1, 128, 128).astype(np.float32)), t(rng.randn(1, 128, 128)
                                                                   .astype(np.float32))
    gf = update3d.prepare_gru_flowhead_3d_params(port.core.gru, port.core.flow_head)
    gf_dw = {**dw["gru"], **dw["flow_head"]}
    h_got, d_got = update3d.gru_flowhead_3d(h, x3d, motion, knn, gf_dw, gf)
    h_ref = update3d.gru_3d(h, torch.cat([x3d, motion], -1), knn, dw["gru"], gf)
    np.testing.assert_array_equal(h_got.numpy(), h_ref.numpy())
    np.testing.assert_array_equal(
        d_got.numpy(), update3d.flow_head_3d(h_ref, knn, dw["flow_head"], gf).numpy())


# --- the 2D update chain ------------------------------------------------------------


@pytest.fixture(scope="module")
def update_2d():
    """Flax MotionEncoder2D, GRU2D and FlowHead2D at 2 x 7 x 9 (corr 36,
    hidden 128), their ports, and inputs."""
    rng = np.random.RandomState(7)
    shape = (2, 7, 9)
    c = {"flow": 2 * rng.randn(*shape, 2), "corr": rng.randn(*shape, 36),
         "h": np.tanh(rng.randn(*shape, 128)), "x2d": np.maximum(rng.randn(*shape, 128), 0),
         "motion": rng.randn(*shape, 128)}
    c = {k: np.asarray(v, np.float32) for k, v in c.items()}
    encoder, gru, head = jraft.MotionEncoder2D(), jraft.GRU2D(), jraft.FlowHead2D()
    evars = encoder.init(jax.random.PRNGKey(0), j(c["flow"]), j(c["corr"]))
    x = jnp.concatenate([j(c["x2d"]), j(c["motion"])], axis=-1)
    gvars = gru.init(jax.random.PRNGKey(1), j(c["h"]), x)
    hvars = head.init(jax.random.PRNGKey(2), j(c["h"]))
    ports = (load_block(traft.MotionEncoder2D(corr_channels=36), evars),
             load_block(traft.GRU2D(), gvars), load_block(traft.FlowHead2D(), hvars))
    jax_params = (prepare_motion_encoder_params(evars["params"]),
                  prepare_gru_flowhead_params(gvars["params"], hvars["params"]))
    return c, ports, jax_params


def test_update_2d_fast_plain_forms_match_pallas(update_2d):
    """#9, #8 and #10's plain bf16 forms against motion_encoder_2d_pallas,
    gru_flowhead_2d_pallas and update_2d_pallas (interpret mode) with the
    JAX package's bf16 parameters: the same operands rounded at the same
    points, f32 sums in another order. Bounds: 2e-3 on the motion
    features and the hidden state (|h| < 1; a flipped bf16 rounding of an
    intermediate moves them by about one bf16 step of their inputs' scale)
    and 5e-3 on the flow delta (two 3x3 convs of 256 and 128 channels over
    such values); the exact plain chain, by contrast, is 3e-2 and 6e-2
    away (tests/test_torch_camliraft.py)."""
    c, (encoder, gru, head), (me_ref, gf_ref) = update_2d
    me = update2d.prepare_motion_encoder_params(encoder, bf16=True)
    gf = update2d.prepare_gru_flowhead_params(gru, head, bf16=True)
    assert me["conv"].bf16 and gf["zr1"].lo is None
    motion = update2d.motion_encoder_2d(t(c["flow"]), t(c["corr"]), me)
    ref = motion_encoder_2d_pallas(j(c["flow"]), j(c["corr"]), me_ref, 7, 9, interpret=True)
    np.testing.assert_allclose(motion.numpy(), np.asarray(ref), rtol=0, atol=2e-3)

    h, delta = update2d.gru_flowhead_2d(t(c["h"]), t(c["x2d"]), t(c["motion"]), gf)
    h_ref, d_ref = gru_flowhead_2d_pallas(j(c["h"]), j(c["x2d"]), j(c["motion"]), gf_ref, 7, 9,
                                          interpret=True)
    np.testing.assert_array_equal(h.numpy(), h.bfloat16().float().numpy())  # h' is bf16
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=0, atol=2e-3)
    np.testing.assert_allclose(delta.numpy(), np.asarray(d_ref), rtol=0, atol=5e-3)
    # #8's halves in sequence are #8
    h_half = update2d.gru_2d(t(c["h"]), t(c["x2d"]), t(c["motion"]),
                             {k: gf[k] for k in update2d.GRU_CONVS})
    np.testing.assert_array_equal(h_half.numpy(), h.numpy())
    np.testing.assert_array_equal(
        update2d.flow_head_2d(h_half, {k: gf[k] for k in update2d.HEAD_CONVS}).numpy(),
        delta.numpy())

    h10, d10 = update2d.update_2d(t(c["h"]), t(c["x2d"]), t(c["flow"]), t(c["corr"]), me, gf)
    h10_ref, d10_ref = update_2d_pallas(j(c["h"]), j(c["x2d"]), j(c["flow"]), j(c["corr"]),
                                        me_ref, gf_ref, 7, 9, interpret=True)
    np.testing.assert_allclose(h10.numpy(), np.asarray(h10_ref), rtol=0, atol=2e-3)
    np.testing.assert_allclose(d10.numpy(), np.asarray(d10_ref), rtol=0, atol=5e-3)
    # #10 is #9 then #8
    h_s, d_s = update2d.gru_flowhead_2d(t(c["h"]), t(c["x2d"]), motion, gf)
    np.testing.assert_array_equal(h10.numpy(), h_s.numpy())
    np.testing.assert_array_equal(d10.numpy(), d_s.numpy())


# --- whole models ---------------------------------------------------------------------


# the port's fast path against the JAX package's, like for like (both
# switches off): the rounded forms agree to well inside these
# (on the CPU: CamLiRAFT-L 1.8e-4 m, the flagship 1.3e-5 m and 4.1e-4 px,
# RAFT 8.7e-4 px)
LIKE_3D, LIKE_2D = 2e-3, 1e-2  # m, px


@pytest.fixture
def default_switches(monkeypatch):
    """The JAX package's default fast path: its int8 3D chain and its fused
    CLFM kernel off, as both sides read them at each forward (JAX at trace
    time: each test jits its model anew)."""
    monkeypatch.setenv("CAMLIFLOW_UPDATE3D", "0")
    monkeypatch.setenv("CAMLIFLOW_CLFM", "0")


def envelope(got, ref, floor):
    """The JAX package's fast-vs-exact bound: max(floor, 0.02 * scale)."""
    d = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    return d, scale, max(floor, 0.02 * scale)


def like(got, ref, bound):
    """max |got - ref| against an absolute bound (the JAX fast flows)."""
    return float(np.abs(got - ref).max()), float(np.abs(ref).max()), bound


def report(name, *rows):
    for label, (d, scale, bound) in rows:
        print(f"{name} {label}: max |delta| {d:.3e} at scale {scale:.3e} (bound {bound:.3e})")
        assert d <= bound, (name, label, d, bound)


def run_port(model_cls, cfgs, flat, family, inputs):
    port = model_cls(cfgs).eval()
    load_jax_variables(port, flat, family)
    with torch.inference_mode():
        return port({k: t(v) for k, v in inputs.items()})


def test_camliraft_l_fast_matches_jax(camliraft_l, default_switches):
    """CamLiRAFT-L with `fast_inference: on` (512 points, 3 iterations, IDS,
    a batch of 2): the port's fast flow against the JAX fast flow within
    2e-3 m, and against the port's exact flow within max(0.02, 0.02 *
    scale) m."""
    flat, tree, cfgs = camliraft_l
    inputs = l_inputs(1)
    fast_cfgs = {**cfgs, "fast_inference": "on"}
    ref = jax.jit(jl.CamLiRAFTL(cfgs=fast_cfgs, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    got = run_port(tl.CamLiRAFTL, fast_cfgs, flat, "camliraft_l", inputs)["flow_3d"].numpy()
    exact = run_port(tl.CamLiRAFTL, cfgs, flat, "camliraft_l", inputs)["flow_3d"].numpy()
    ref = np.asarray(ref["flow_3d"])
    report("camliraft_l", ("fast vs JAX fast", like(got, ref, LIKE_3D)),
           ("fast vs exact", envelope(got, exact, 0.02)))


@pytest.fixture(scope="module")
def raft():
    cfgs = {"name": "raft", "backbone": {"depth": 18}, "n_iters_eval": 2,
            "fast_inference": "off"}
    model = jraft.RAFT(cfgs=cfgs, train_mode=False)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    {k: j(v) for k, v in raft_inputs(0).items()})
    flat = perturb_bn(tree_to_flat(jax.tree.map(np.asarray, variables)), 51)
    for key in flat:  # flows of a few pixels, not near-zeros
        if "flow_head" in key and key.endswith("/kernel"):
            flat[key] = flat[key] * 4.0
    return flat, flat_to_tree(flat), cfgs


def raft_inputs(seed, h=60, w=76):
    rng = np.random.RandomState(seed)
    return {"images": rng.randint(0, 255, size=(1, h, w, 6)).astype(np.float32)}


def test_raft_fast_matches_jax(raft, default_switches):
    """RAFT with `fast_inference: on` (int8 volume, #10's bf16 form; 60x76,
    2 iterations) against the JAX fast flow within 1e-2 px, and against the
    port's exact flow within max(0.15, 0.02 * scale) px."""
    flat, tree, cfgs = raft
    inputs = raft_inputs(1)
    fast_cfgs = {**cfgs, "fast_inference": "on"}
    ref = jax.jit(jraft.RAFT(cfgs=fast_cfgs, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    got = run_port(traft.RAFT, fast_cfgs, flat, "raft", inputs)["flow_2d"].numpy()
    exact = run_port(traft.RAFT, cfgs, flat, "raft", inputs)["flow_2d"].numpy()
    ref = np.asarray(ref["flow_2d"])
    assert np.abs(exact).max() > 0.1
    report("raft", ("fast vs JAX fast", like(got, ref, LIKE_2D)),
           ("fast vs exact", envelope(got, exact, 0.15)))


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_raft_lookup_storage_on_the_exact_path_matches_jax(raft, storage, default_switches):
    """`lookup_storage: bf16|int8` with `fast_inference: off`: the volume's
    storage alone changes (the output differs from the f32 volume's).
    Against the JAX model with the same keys: within 5e-3 px (a flipped
    int8 or bf16 rounding of one volume entry moves the taps that read it
    by one step, through two iterations and the convex upsample)."""
    flat, tree, cfgs = raft
    inputs = raft_inputs(2)
    stored = {**cfgs, "lookup_storage": storage}
    ref = jax.jit(jraft.RAFT(cfgs=stored, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    got = run_port(traft.RAFT, stored, flat, "raft", inputs)["flow_2d"].numpy()
    split = run_port(traft.RAFT, cfgs, flat, "raft", inputs)["flow_2d"].numpy()
    d, scale, _ = envelope(got, np.asarray(ref["flow_2d"]), 0.0)
    print(f"raft lookup_storage={storage}: max |delta| {d:.3e} at scale {scale:.3e}, "
          f"{np.abs(got - split).max():.3e} from the f32 volume's")
    assert not np.array_equal(got, split)
    assert d <= 5e-3


def flag_cfgs(**overrides):
    cfgs = {"name": "camliraft", "backbone": {"depth": 18}, "n_iters_eval": 2,
            "fast_inference": "off", "fuse_fnet": True, "fuse_cnet": True,
            "fuse_corr": True, "fuse_motion": True, "fuse_hidden": False,
            "n_samples_list": N_SAMPLES}
    return {**cfgs, **overrides}


def flag_inputs(seed, h=60, w=76, n=512):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(1, h, w, 6)).astype(np.float32)
    pc1 = rng.randn(1, n, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(1, n, 3).astype(np.float32)
    return {"images": images, "pcs": np.concatenate([pc1, pc2], -1),
            "intrinsics": np.float32([[100.0, (w - 1) / 2, (h - 1) / 2]])}


@pytest.mark.parametrize("fuse_hidden", [False, True])
def test_camliraft_fast_matches_jax(fuse_hidden, default_switches):
    """CamLiRAFT with `fast_inference: on` (`fuse_hidden` off: #9 and #8 in
    bf16; on: #9 in bf16, GRU2D and FlowHead2D exact, the 3D tails through
    #13's fast form), 60x76, 512 points, 2 iterations: both flows against
    the JAX fast flows within 1e-2 px and 2e-3 m, and against the port's
    exact flows within max(0.15, 0.02 * scale) px and max(0.02, 0.02 *
    scale) m."""
    cfgs = flag_cfgs(fuse_hidden=fuse_hidden)
    inputs = flag_inputs(3)
    model = jflag.CamLiRAFT(cfgs=cfgs, train_mode=False)
    variables = jax.jit(model.init)(jax.random.PRNGKey(2), {k: j(v) for k, v in inputs.items()})
    flat = perturb_bn(tree_to_flat(jax.tree.map(np.asarray, variables)), 11)
    for key in flat:  # flows of a pixel or so and a few tenths of a metre, not near-zeros
        if "flow_head_2d" in key and key.endswith("/kernel"):
            flat[key] = flat[key] * (8.0 if fuse_hidden else 4.0)
        if "flow_head_3d/fc/kernel" in key:
            flat[key] = flat[key] * 3000.0
    fast_cfgs = {**cfgs, "fast_inference": "on"}
    ref = jax.jit(jflag.CamLiRAFT(cfgs=fast_cfgs, train_mode=False).apply)(
        flat_to_tree(flat), {k: j(v) for k, v in inputs.items()})
    got = run_port(tflag.CamLiRAFT, fast_cfgs, flat, "camliraft", inputs)
    exact = run_port(tflag.CamLiRAFT, cfgs, flat, "camliraft", inputs)
    assert np.abs(exact["flow_2d"].numpy()).max() > 0.1
    assert np.abs(exact["flow_3d"].numpy()).max() > 0.05
    name = f"camliraft fuse_hidden={fuse_hidden}"
    report(name,
           ("2D fast vs JAX fast", like(got["flow_2d"].numpy(), np.asarray(ref["flow_2d"]),
                                        LIKE_2D)),
           ("2D fast vs exact", envelope(got["flow_2d"].numpy(), exact["flow_2d"].numpy(), 0.15)),
           ("3D fast vs JAX fast", like(got["flow_3d"].numpy(), np.asarray(ref["flow_3d"]),
                                        LIKE_3D)),
           ("3D fast vs exact", envelope(got["flow_3d"].numpy(), exact["flow_3d"].numpy(), 0.02)))
