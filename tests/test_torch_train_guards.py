"""PyTorch port, what keeps training honest, on the CPU:

- the fused kernels (#5-#13) and the interpolation (#3) are forward-only:
  each wrapper raises when grad mode is on and an input requires grad, and
  each packer when the module weights it copies do, on either device
  (before, the eval forward under grad returned flows whose gradients never
  reached the update chains, CLFM or the Correlation3D tail, and #3 dropped
  the gradient of the flow it interpolated, without a word); the eval
  forward with grad off is unchanged;
- the interpolation's train form (`geometry.knn_interpolation_train`)
  computes the plain version's output and gradients;
- every family's train mode calls none of the fused wrappers, #3 only on
  detached inputs, and runs the selections #1, #2 and #4 (#4 in its
  index-only form) at their counts;
- #4's index-only form selects what the full form selects, ties included.
"""

import numpy as np
import pytest
import torch

from camliflow_torch.models import camliraft as tm
from camliflow_torch.models import raft as traft
from camliflow_torch.models.camliraft_l import FlowHead3D, GRU3D, MotionEncoder3D
from camliflow_torch.models.factory import model_factory, training_functions
from camliflow_torch.nn.clfm import CLFM
from camliflow_torch.ops import _cuda, clfm, corr3d, fps, gather, geometry, interp, knn
from camliflow_torch.ops import update2d, update3d
from camliflow_torch.runtime.checkpoint import random_weights

torch.set_num_threads(2)

CFGS = {"name": "camliraft", "backbone": {"depth": 18}, "n_iters_eval": 2, "n_iters_train": 2,
        "fast_inference": "auto", "fuse_fnet": True, "fuse_cnet": True, "fuse_corr": True,
        "fuse_motion": True, "fuse_hidden": False, "n_samples_list": [256, 128, 64, 32, 16],
        "loss2d": {"gamma": 0.8, "order": "l2-norm"}, "loss3d": {"gamma": 0.8, "order": "l2-norm"}}


def batch(seed=0, b=1, h=64, w=96, n=512):
    rng = np.random.RandomState(seed)
    pc1 = rng.randn(b, n, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(b, n, 3).astype(np.float32)
    out = {"images": rng.randint(0, 255, size=(b, h, w, 6)).astype(np.float32),
           "pcs": np.concatenate([pc1, pc2], -1),
           "intrinsics": np.tile([100.0, (w - 1) / 2, (h - 1) / 2], (b, 1)).astype(np.float32),
           "flow_2d": np.concatenate([rng.randn(b, h, w, 2), np.ones((b, h, w, 1))], -1),
           "flow_3d": pc2 - pc1}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}


def model(**overrides):
    port = tm.CamLiRAFT({**CFGS, **overrides})
    random_weights(port, 0)
    return port


def test_eval_forward_raises_under_grad_and_is_unchanged_without():
    port = model().eval()
    inputs = batch()
    with pytest.raises(RuntimeError, match="forward-only"):
        port(inputs)
    with torch.no_grad():
        got = port(inputs)
    with torch.inference_mode():
        want = port(inputs)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def g(*shape):
    return torch.randn(*shape, requires_grad=True)


def wrapper_calls():
    """Each fused wrapper (#5-#13) with one input that requires grad; the
    check comes before any other, so the shapes need not fit."""
    idx = torch.zeros(1, 4, 4, dtype=torch.int32)
    return {
        "corr3d_tail": lambda: corr3d.corr3d_tail(g(1, 4, 3), g(1, 4, 3), idx, g(1, 4, 4), None,
                                                  1, 4),
        "motion_encoder_3d": lambda: update3d.motion_encoder_3d(g(1, 4, 3), g(1, 4, 8), idx, {},
                                                                {}),
        "gru_flowhead_3d": lambda: update3d.gru_flowhead_3d(g(1, 4, 8), g(1, 4, 8), g(1, 4, 8),
                                                            idx, {}, {}),
        "gru_3d": lambda: update3d.gru_3d(g(1, 4, 8), g(1, 4, 8), idx, {}, {}),
        "flow_head_3d": lambda: update3d.flow_head_3d(g(1, 4, 8), idx, {}, {}),
        "dw_max": lambda: update3d.dw_max(g(1, 4, 8), idx, g(1, 4, 4, 8)),
        "motion_encoder_2d": lambda: update2d.motion_encoder_2d(g(1, 3, 3, 2), g(1, 3, 3, 8),
                                                                {}),
        "gru_2d": lambda: update2d.gru_2d(g(1, 3, 3, 8), g(1, 3, 3, 8), g(1, 3, 3, 8), {}),
        "flow_head_2d": lambda: update2d.flow_head_2d(g(1, 3, 3, 8), {}),
        "gru_flowhead_2d": lambda: update2d.gru_flowhead_2d(g(1, 3, 3, 8), g(1, 3, 3, 8),
                                                            g(1, 3, 3, 8), {}),
        "update_2d": lambda: update2d.update_2d(g(1, 3, 3, 8), g(1, 3, 3, 8), g(1, 3, 3, 2),
                                                g(1, 3, 3, 8), {}, {}),
        "clfm_fused": lambda: clfm.clfm_fused(g(1, 3, 3, 8), g(1, 4, 8), g(1, 9, 8),
                                              idx[..., :1], idx, g(1, 4, 4), {}),
        "gather_points_kmajor": lambda: gather.gather_points_kmajor(g(1, 4, 8), idx),
    }


@pytest.mark.parametrize("name", sorted(wrapper_calls()))
def test_fused_wrapper_raises_on_an_input_that_requires_grad(name):
    with pytest.raises(RuntimeError, match="forward-only"):
        wrapper_calls()[name]()


def packers():
    return {
        "prepare_corr3d_tail_params": lambda: corr3d.prepare_corr3d_tail_params(
            tm.Correlation3D(n_levels=4)),
        "prepare_motion_encoder_3d_params": lambda: update3d.prepare_motion_encoder_3d_params(
            MotionEncoder3D()),
        "prepare_gru_3d_params": lambda: update3d.prepare_gru_3d_params(GRU3D()),
        "prepare_flow_head_3d_params": lambda: update3d.prepare_flow_head_3d_params(FlowHead3D()),
        "prepare_gru_flowhead_3d_params": lambda: update3d.prepare_gru_flowhead_3d_params(
            GRU3D(), FlowHead3D()),
        "prepare_motion_encoder_params": lambda: update2d.prepare_motion_encoder_params(
            traft.MotionEncoder2D()),
        "prepare_gru_params": lambda: update2d.prepare_gru_params(traft.GRU2D()),
        "prepare_flow_head_params": lambda: update2d.prepare_flow_head_params(traft.FlowHead2D()),
        "prepare_update_2d_params": lambda: update2d.prepare_update_2d_params(
            traft.MotionEncoder2D(), traft.GRU2D(), traft.FlowHead2D()),
        "prepare_clfm_params": lambda: clfm.prepare_clfm_params(CLFM(32, 16)),
    }


@pytest.mark.parametrize("name", sorted(packers()))
def test_packer_raises_on_weights_that_require_grad(name):
    with pytest.raises(RuntimeError, match="forward-only"):
        packers()[name]()
    with torch.no_grad():
        packers()[name]()  # the eval path packs with grad off


def count_wrappers(monkeypatch):
    """Patch the selection wrappers to count their calls, and `_cuda.
    forward_only` (which every forward-only wrapper checks first) to record
    each call: (counts, [(wrapper, whether an input required grad)])."""
    checked = []
    monkeypatch.setattr(_cuda, "forward_only", lambda name, *a: checked.append(
        (name, torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                               for t in a))))
    calls = {"fps": 0, "knn": 0, "interp": 0, "corr3d_index": 0, "corr3d_cost": 0}

    def counted(key, fn):
        def run(*args, **kwargs):
            if key == "corr3d":
                calls["corr3d_index" if kwargs.get("with_cost") is False else "corr3d_cost"] += 1
            else:
                calls[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fps, "furthest_point_sampling",
                        counted("fps", fps.furthest_point_sampling))
    monkeypatch.setattr(knn, "k_nearest_neighbor", counted("knn", knn.k_nearest_neighbor))
    monkeypatch.setattr(interp, "knn_interpolation", counted("interp", interp.knn_interpolation))
    monkeypatch.setattr(corr3d, "correlation3d_knn", counted("corr3d", corr3d.correlation3d_knn))
    return calls, checked


def test_train_mode_runs_no_fused_wrapper_and_the_selections_at_their_counts(monkeypatch):
    """One train step's forward and backward: no fused wrapper (#5-#13,
    #12) is called, #3 only on detached inputs; FPS once, KNN 8 times (2
    encoder levels, the fusion cache, the k=32 neighbours, the upsample's
    k=3, 3 pooling levels), the backwarp's interpolation and #4's index-only
    selection once an iteration, and #4 never with costs."""
    calls, checked = count_wrappers(monkeypatch)
    port = model().train()
    inputs = batch(1, b=2)
    loss, _ = tm.loss_fn(port(inputs), inputs, CFGS)
    loss.backward()
    assert checked == [("knn_interpolation", False)] * 2
    assert calls == {"fps": 1, "knn": 8, "interp": 2, "corr3d_index": 2, "corr3d_cost": 0}
    grads = {name: p.grad for name, p in port.named_parameters()}
    for branch in ("branch_2d", "branch_3d", "clfm_corr", "clfm_motion"):
        assert any(v is not None and v.abs().max() > 0 for k, v in grads.items()
                   if f"core.{branch}." in k), branch


def test_freeze_bn_keeps_every_batchnorm_on_its_running_statistics():
    port = model(freeze_bn=True).train()
    before = {k: v.clone() for k, v in port.named_buffers()}
    port(batch(2))
    assert port.training and port.core.training
    for key, value in port.named_buffers():
        assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("levels", [(64, 32, 16), (128, 64, 32, 16), (96,)])
def test_correlation3d_index_only_selects_what_the_full_form_selects(levels):
    """The plain version and the wrapper (on the CPU, the plain version)
    with `with_cost=False`: the full form's indices bit for bit, on a
    cloud with exact ties (repeated points), and no costs."""
    rng = np.random.RandomState(sum(levels))
    xyz1 = torch.from_numpy(rng.randn(2, 50, 3).astype(np.float32))
    xyz2 = torch.from_numpy(rng.randn(2, levels[0] + 5, 3).astype(np.float32))
    xyz2[:, 10:20] = xyz2[:, :10]  # exact ties across the prefix
    xyz1[:, :5] = xyz2[:, :5]
    pyramid = torch.randn(2, 50, sum(levels))
    idx, cost = corr3d.correlation3d_knn_plain(xyz1, xyz2, pyramid, levels, 16)
    assert cost is not None and idx.shape == (2, 50, 16 * len(levels))
    for fn in (corr3d.correlation3d_knn_plain, corr3d.correlation3d_knn):
        only, none = fn(xyz1, xyz2, None, levels, 16, with_cost=False)
        assert none is None
        assert torch.equal(only, idx)


def interp_inputs(seed=5, dtype=torch.float32, coincide=True):
    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy(rng.randn(2, 40, 3).astype(np.float32))
    feats = torch.from_numpy(rng.randn(2, 40, 7)).to(dtype)
    query = torch.from_numpy(rng.randn(2, 30, 3).astype(np.float32))
    if coincide:
        query[:, :4] = xyz[:, :4]  # queries on a support: distance 0, clamped
    return xyz, feats, query


@pytest.mark.parametrize("which", [0, 1, 2], ids=["input_xyz", "input_features", "query_xyz"])
def test_interpolation_raises_under_grad_and_is_unchanged_without(which):
    """#3's wrapper refuses an input that requires grad under grad mode (its
    kernel has no backward), and with grad off returns the plain version's
    result bit for bit, as before."""
    args = list(interp_inputs())
    want = interp.knn_interpolation_plain(*args, 3)
    args[which] = args[which].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        interp.knn_interpolation(*args, 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        geometry.knn_interpolation(*args)
    with torch.no_grad():
        assert torch.equal(interp.knn_interpolation(*args, 3), want)
    assert torch.equal(interp.knn_interpolation(*(a.detach() for a in args), 3), want)


def test_interpolation_train_form_matches_the_plain_version_under_autograd():
    """`knn_interpolation_train` (#1's selection, then torch ops) against the
    plain version's own autograd: the output and the gradients of all three
    inputs to f32 rounding, float64 features; with queries on supports (the
    1e-8 clamp) the output, and gradients that stay finite (the plain
    version's explicit square root gives NaN there, as the JAX package's
    norm does); its gradient in the features by finite differences in
    float64 (the map is linear in them); and `backwarp_3d(train=True)` gives
    the eval form's warp."""
    xyz, feats, query = interp_inputs(dtype=torch.float64)
    args = [t.clone().requires_grad_(True) for t in (xyz, feats, query)]
    out = geometry.knn_interpolation_train(*args, 3)
    torch.testing.assert_close(out, interp.knn_interpolation_plain(xyz, feats, query, 3),
                               rtol=1e-5, atol=1e-6)
    out.sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in args)
    xyz, feats, query = interp_inputs(dtype=torch.float64, coincide=False)
    grads = []
    for fn in (geometry.knn_interpolation_train, interp.knn_interpolation_plain):
        args = [t.clone().requires_grad_(True) for t in (xyz, feats, query)]
        out = fn(*args, 3)
        out.backward(torch.linspace(-1, 1, out.numel(), dtype=out.dtype).reshape(out.shape))
        grads.append((out.detach(), *(a.grad for a in args)))
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda f: geometry.knn_interpolation_train(xyz, f, query), feats.requires_grad_(True))
    flow = torch.randn(2, 40, 3)
    with torch.no_grad():
        want = geometry.backwarp_3d(xyz, query, flow)
    flow.requires_grad_(True)
    got = geometry.backwarp_3d(xyz, query, flow, train=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    got.sum().backward()
    assert flow.grad.abs().max() > 0


POINTS = [256, 128, 64, 32, 16]
FAMILIES = {
    "camliraft_l": {"n_iters_train": 2, "n_iters_eval": 2, "fast_inference": "auto",
                    "ids": {"enabled": True}, "n_samples_list": POINTS,
                    "loss": {"gamma": 0.8, "order": "l2-norm"}},
    "raft": {"backbone": {"depth": 18}, "n_iters_train": 2, "n_iters_eval": 2,
             "fast_inference": "auto", "loss": {"gamma": 0.8, "order": "l2-norm"}},
    "pwc": {"max_displacement": 4, "lite_estimator": False,
            "norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                     "context_network": None},
            "loss": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"}},
    "camlipwc_l": {"ids": {"enabled": True}, "n_samples_list": POINTS,
                   "norm": {"feature_pyramid": "batch_norm", "correlation": None,
                            "flow_estimator": None},
                   "loss": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"}},
    "camlipwc": {"freeze_bn": False, "n_samples_list": POINTS,
                 "pwc2d": {"norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                                    "context_network": None},
                           "max_displacement": 4, "lite_estimator": False},
                 "pwc3d": {"norm": {"feature_pyramid": "batch_norm", "correlation": None,
                                    "flow_estimator": None}, "k": 16},
                 "fusion": {"fuse_pyramid": True, "fuse_correlation": True,
                            "fuse_estimator": True},
                 "loss2d": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"},
                 "loss3d": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"}},
}
# a train step's selections, derived from the code: CamLiRAFT-L's as the
# flagship's less the fusion cache (2 encoder levels, the k=32 neighbours,
# the upsample's k=3, 3 pooling levels; the backwarp's #3 on the detached
# flow and #4 index-only once an iteration); the PWC family's point side 10
# KNN in the two pyramids, 2 a decoder level (the level's k=16 and
# Correlation3D's), then the train form's k=3 selections: 4 level upsamples,
# 4 backwarps and 5 final upsamples; CamLiPWC 2 fusion caches a level more
FAMILY_CALLS = {
    "camliraft_l": {"fps": 1, "knn": 7, "interp": 2, "corr3d_index": 2, "corr3d_cost": 0},
    "raft": {"fps": 0, "knn": 0, "interp": 0, "corr3d_index": 0, "corr3d_cost": 0},
    "pwc": {"fps": 0, "knn": 0, "interp": 0, "corr3d_index": 0, "corr3d_cost": 0},
    "camlipwc_l": {"fps": 1, "knn": 33, "interp": 0, "corr3d_index": 0, "corr3d_cost": 0},
    "camlipwc": {"fps": 1, "knn": 43, "interp": 0, "corr3d_index": 0, "corr3d_cost": 0},
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_train_mode_runs_no_forward_only_kernel_and_the_selections_at_their_counts(
        name, monkeypatch):
    """One train step's forward and backward of each family the flagship's
    test above does not cover: no fused wrapper (#5-#13, #12), #3 only on
    detached inputs, the selections at their counts; every parameter gets a
    gradient, and every branch the family labels a parameter with a
    nonzero one."""
    from camliflow_torch.runtime.train_state import branch_grad_norms

    calls, checked = count_wrappers(monkeypatch)
    cfgs = {"name": name, **FAMILIES[name]}
    port = model_factory(cfgs)(cfgs)
    random_weights(port, 0)
    port.train()
    inputs = batch(1, b=2)
    loss_fn, _ = training_functions(name)
    loss, _ = loss_fn(port(inputs), inputs, cfgs)
    loss.backward()
    assert checked == [("knn_interpolation", False)] * FAMILY_CALLS[name]["interp"]
    assert calls == FAMILY_CALLS[name]
    assert all(p.grad is not None for p in port.parameters())
    norms = branch_grad_norms(port, name)
    assert float(norms["grad_norm_2d"]) > 0
    assert (float(norms["grad_norm_3d"]) > 0) == (name == "camlipwc")
