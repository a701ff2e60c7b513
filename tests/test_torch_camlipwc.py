"""PyTorch port, CamLiPWC: the whole model against the JAX package through
the weight bridge, on the CPU, with all three fusions (the config's) and
with none and the lite estimator.

One JAX CamLiPWC per configuration is given variables once per file
(tests/test_torch_pwc.py::init_bridged) and carried into the port with
`runtime.checkpoint.load_jax_variables`; the test size is 128x192 images,
512 points, n_samples_list [256..16], bs 2. Its blocks are PWC's and
CamLiPWC-L's (tests/test_torch_pwc.py, tests/test_torch_camlipwc_l.py) and
the CLFM (tests/test_torch_clfm.py); here the core's fusion caches are held
to the JAX package's selection. Both sides are f32.
"""

import numpy as np
import jax
import pytest
import torch

from camliflow_tpu.models import camlipwc as jm
from camliflow_tpu.nn import clfm as jclfm
from camliflow_torch.nn import clfm as tclfm
from test_torch_camliraft_l import j, t
from test_torch_pwc import check_bridge, init_bridged

torch.set_num_threads(2)

H, W = 128, 192
N_SAMPLES = [256, 128, 64, 32, 16]


def camlipwc_cfgs(fusion: bool) -> dict:
    """conf/model/camlipwc.yaml at the test's pyramid sizes; without fusion
    also with the lite 2D estimator."""
    return {
        "name": "camlipwc",
        "freeze_bn": False,
        "n_samples_list": N_SAMPLES,
        "pwc2d": {"norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                           "context_network": None},
                  "max_displacement": 4, "lite_estimator": not fusion, "fixed": False},
        "pwc3d": {"norm": {"feature_pyramid": "batch_norm", "correlation": None,
                           "flow_estimator": None},
                  "fixed": False, "k": 16},
        "fusion": dict.fromkeys(("fuse_pyramid", "fuse_correlation", "fuse_estimator"),
                                fusion),
    }


def make_inputs(seed, batch=2, h=H, w=W, n=512):
    """tests/test_models_forward.py's recipe: clouds 5-35 m deep that
    project into the images (f = 100 px)."""
    rng = np.random.RandomState(seed)
    pc1 = rng.randn(batch, n, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(batch, n, 3).astype(np.float32)
    return {"images": rng.randint(0, 255, (batch, h, w, 6)).astype(np.float32),
            "pcs": np.concatenate([pc1, pc2], -1),
            "intrinsics": np.tile([100.0, (w - 1) / 2, (h - 1) / 2],
                                  (batch, 1)).astype(np.float32)}


@pytest.fixture(scope="module", params=[True, False], ids=["fusion", "no_fusion_lite"])
def bridged(request):
    cfgs = camlipwc_cfgs(request.param)
    return (cfgs,) + init_bridged(jm.CamLiPWC, cfgs, make_inputs(0), "camlipwc")


def test_bridge(bridged):
    cfgs, flat, _, model = bridged
    assert check_bridge(flat, model, "camlipwc") == {"2d_decay", "2d_no_decay", "3d_decay",
                                                     "3d_no_decay"}
    state = model.state_dict()
    fused = cfgs["fusion"]["fuse_pyramid"]
    assert ("core.pyramid_clfms.5.fuse3d.fc_out.0.weight" in state) == fused
    assert ("core.estimator_clfm.interp.out_conv.conv_fn.weight" in state) == fused
    assert ("core.branch_2d_flow_estimator.conv_last.weight" in state) != fused
    assert "core.branch_3d_correlation_aligners.5.conv_fn.bias" in state


@pytest.mark.parametrize("hw", [(32, 48), (2, 3)], ids=["level1", "level5"])
def test_fusion_cache_matches_jax(hw):
    """The pixel grid's nearest projected point, a 2-D k=1 KNN, at level 1's
    and level 5's maps: the same distances as the JAX package's selection
    (an exact tie between two points may keep either) and the same offsets
    where both pick one point."""
    rng = np.random.RandomState(4)
    uv = (rng.rand(2, 256, 2) * [hw[1] - 1.0, hw[0] - 1.0]).astype(np.float32)
    ref_idx, ref_off = (np.asarray(a) for a in jclfm.fusion_interp_cache(j(uv), *hw))
    got_idx, got_off = (a.numpy() for a in tclfm.fusion_interp_cache(t(uv), *hw))
    assert got_idx.shape == ref_idx.shape == (2, hw[0] * hw[1], 1)
    np.testing.assert_allclose(np.linalg.norm(got_off, axis=-1),
                               np.linalg.norm(ref_off, axis=-1), rtol=1e-6, atol=1e-6)
    same = got_idx == ref_idx
    assert same.mean() > 0.99
    np.testing.assert_array_equal(got_off[same[..., 0]], ref_off[same[..., 0]])


def test_camlipwc_matches_jax(bridged):
    """The whole eval forward, bs 2: flow_2d within 1e-3 px, flow_3d within
    1e-4 m."""
    cfgs, _, tree, model = bridged
    inputs = make_inputs(20)
    ref = jax.jit(jm.CamLiPWC(cfgs=cfgs, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    with torch.inference_mode():
        got = model({k: t(v) for k, v in inputs.items()})
    assert set(got) == {"flow_2d", "flow_3d"}
    for key, tol, shape in (("flow_2d", 1e-3, (2, H, W, 2)), ("flow_3d", 1e-4, (2, 512, 3))):
        flow, flow_ref = got[key].numpy(), np.asarray(ref[key])
        assert flow.shape == shape
        np.testing.assert_allclose(flow, flow_ref, rtol=0, atol=tol, err_msg=key)
        assert np.abs(flow_ref).max() > 10 * tol  # the check is not vacuous
