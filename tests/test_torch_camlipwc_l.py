"""PyTorch port, CamLiPWC-L: its blocks and the whole model against the JAX
package through the weight bridge, on the CPU.

One JAX CamLiPWC-L is given variables once per file
(tests/test_torch_pwc.py::init_bridged) and carried into the port with
`runtime.checkpoint.load_jax_variables`; the test size is 512 points,
n_samples_list [256..16], bs 2. Both sides are f32;
tolerances cover summation order only. The JAX selections expand the
squared distance on its matrix unit (|q|^2 - 2 q.p + |p|^2), the port's
take it per coordinate (ops/geometry.py), so a near-tie may pick another
neighbour: the block tests feed both sides the same inputs and neighbours.
A block's output is held to 1e-5 of its own scale (max |port - JAX| <=
1e-5 max |JAX|): through five PointConvs the features reach ~60, and
summation order alone moves an element near zero by more than 1e-5 of
itself.
"""

import numpy as np
import jax
import pytest
import torch

from camliflow_tpu.models import camlipwc_l as jm
from camliflow_tpu.ops import geometry as jgeo
from camliflow_torch.models import camlipwc_l as tm
from camliflow_torch.ops import geometry as tgeo
from camliflow_torch.runtime.checkpoint import load_jax_variables
from test_torch_camliraft_l import j, sub, t
from test_torch_pwc import check_bridge, init_bridged

torch.set_num_threads(2)

N_SAMPLES = [256, 128, 64, 32, 16]


def assert_scale_close(got, ref, rel=1e-5):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, (err, scale)


def camlipwc_l_cfgs(ids: bool) -> dict:
    """conf/model/camlipwc_l.yaml at the test's pyramid sizes."""
    return {"name": "camlipwc_l", "ids": {"enabled": ids}, "n_samples_list": N_SAMPLES,
            "norm": {"feature_pyramid": "batch_norm", "correlation": None,
                     "flow_estimator": None}}


def make_clouds(seed, batch=2, n=512, ids=True):
    """Unit-scale clouds (tests/test_torch_camliraft_l.py's recipe); with
    IDS, which takes the log of z, 5-35 m in front of the camera."""
    rng = np.random.RandomState(seed)
    pc1 = rng.randn(batch, n, 3).astype(np.float32)
    if ids:
        pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(batch, n, 3).astype(np.float32)
    return {"pcs": np.concatenate([pc1, pc2], -1),
            "intrinsics": np.tile([1050.0, 479.5, 269.5], (batch, 1)).astype(np.float32)}


@pytest.fixture(scope="module")
def bridged():
    return init_bridged(jm.CamLiPWCL, camlipwc_l_cfgs(True), make_clouds(0), "camlipwc_l")


@pytest.fixture(scope="module")
def pyramid():
    """Both frames' FPS pyramids (the full cloud first) and features of
    level 2 for the decoder's blocks."""
    pcs = make_clouds(2, batch=1)["pcs"]
    xyzs1, xyzs2, _, _ = jgeo.build_pc_pyramid(j(pcs[..., :3]), j(pcs[..., 3:]), N_SAMPLES)
    return [np.asarray(x) for x in xyzs1], [np.asarray(x) for x in xyzs2]


def test_bridge(bridged):
    flat, _, model = bridged
    # no module path of CamLiPWC-L names a 3D branch (the reference's
    # state_dict has no core.branch_3d either): its parameters are all "2d"
    assert check_bridge(flat, model, "camlipwc_l") == {"2d_decay", "2d_no_decay"}
    state = model.state_dict()
    assert "core.feature_pyramid.pyramid_mlps.4.convs.1.conv_fn.weight" in state
    assert "core.correlations.5.feat_aligner.conv_fn.weight" in state
    assert "core.pyramid_feat_aligners.1.conv_fn.bias" in state


def test_feature_pyramid_3d(bridged, pyramid):
    """The point pyramid: 5 PointConvs (KNN k=16 each, the k-major gather
    twice each), BatchNorm on."""
    _, tree, model = bridged
    xyzs1, _ = pyramid
    ref = jm.FeaturePyramid3D().apply(sub(tree, "core", "feature_pyramid"),
                                      [j(x) for x in xyzs1])
    with torch.inference_mode():
        got = model.core.feature_pyramid([t(x) for x in xyzs1])
    assert [g.shape[-1] for g in got] == [16, 32, 64, 96, 128, 192]
    for r, g in zip(ref, got):
        assert_scale_close(g.numpy(), r)


@pytest.mark.parametrize("own_knn", [False, True])
def test_correlation3d_pwc(bridged, pyramid, own_knn):
    """Level 2 (128 points, 64 channels), with the 1-in-1 neighbours given
    (a prefix of k=16 of 20) or selected inside."""
    _, tree, model = bridged
    xyzs1, xyzs2 = pyramid
    rng = np.random.RandomState(3)
    xyz1, xyz2 = xyzs1[2], xyzs2[2] + 0.02
    feat1 = rng.randn(1, 128, 64).astype(np.float32)
    feat2 = rng.randn(1, 128, 64).astype(np.float32)
    knn = None if own_knn else np.asarray(jgeo.k_nearest_neighbor(j(xyz1), j(xyz1), 20))
    ref = jm.Correlation3DPWC(64, align_channels=64).apply(
        sub(tree, "core", "correlation_2"), j(xyz1), j(feat1), j(xyz2), j(feat2),
        None if knn is None else j(knn))
    with torch.inference_mode():
        got = model.core.correlations[2](t(xyz1), t(feat1), t(xyz2), t(feat2),
                                         None if knn is None else t(knn))
    assert got.shape == (1, 128, 64)
    assert_scale_close(got.numpy(), ref)


def test_flow_estimator_3d(bridged, pyramid):
    _, tree, model = bridged
    xyzs1, _ = pyramid
    xyz = xyzs1[1]
    x = np.random.RandomState(4).randn(1, 256, 131).astype(np.float32)
    knn = np.asarray(jgeo.k_nearest_neighbor(j(xyz), j(xyz), 16))
    ref = jm.FlowEstimator3D((131, 128, 128, 64)).apply(
        sub(tree, "core", "flow_estimator"), j(xyz), j(x), j(knn))
    with torch.inference_mode():
        got = model.core.flow_estimator(t(xyz), t(x), t(knn))
    for r, g in zip(ref, got):
        assert_scale_close(g.numpy(), r)


def test_selections_match_jax(pyramid):
    """The decoder's selections on these clouds: the port's KNN picks the
    JAX package's neighbours at the same distances (a near-tie may swap two
    of equal distance), and FPS the same points."""
    xyzs1, xyzs2 = pyramid
    for xyz in xyzs1[1:]:
        ref = np.asarray(jgeo.k_nearest_neighbor(j(xyz), j(xyz), 16))
        got = tgeo.k_nearest_neighbor(t(xyz), t(xyz), 16).numpy()
        dist = lambda idx: np.sort(((xyz[0][idx[0]] - xyz[0][:, None]) ** 2).sum(-1), -1)
        np.testing.assert_allclose(dist(got), dist(ref), rtol=1e-5, atol=1e-7)
    pcs = make_clouds(2, batch=1)["pcs"]
    got = tgeo.build_pc_pyramid(t(pcs[..., :3]), t(pcs[..., 3:]), N_SAMPLES)
    for r, g in zip(xyzs1 + xyzs2, got[0] + got[1]):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("ids", [True, False], ids=["ids", "no_ids"])
def test_camlipwc_l_matches_jax(bridged, ids):
    """The whole eval forward, bs 2, IDS on and off: flow_3d within 1e-4 m."""
    flat, tree, _ = bridged
    cfgs = camlipwc_l_cfgs(ids)
    inputs = make_clouds(20 + ids, ids=ids)
    ref = jax.jit(jm.CamLiPWCL(cfgs=cfgs, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    model = tm.CamLiPWCL(cfgs).eval()
    load_jax_variables(model, flat, "camlipwc_l")
    with torch.inference_mode():
        got = model({k: t(v) for k, v in inputs.items()})
    assert set(got) == {"flow_3d"}
    flow, flow_ref = got["flow_3d"].numpy(), np.asarray(ref["flow_3d"])
    assert flow.shape == (2, 512, 3)
    np.testing.assert_allclose(flow, flow_ref, rtol=0, atol=1e-4)
    assert np.abs(flow_ref).max() > 1e-3  # the check is not vacuous
