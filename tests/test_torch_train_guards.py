"""PyTorch port, what keeps training honest, on the CPU:

- the fused kernels (#5-#13) are forward-only: each wrapper raises when
  grad mode is on and an input requires grad, and each packer when the
  module weights it copies do, on either device (before, the eval forward
  under grad returned flows whose gradients never reached the update
  chains, CLFM or the Correlation3D tail, without a word); the eval
  forward with grad off is unchanged;
- the flagship's train mode calls none of the fused wrappers, and runs
  the selections #1-#4 (#4 in its index-only form) at their counts;
- #4's index-only form selects what the full form selects, ties included.
"""

import numpy as np
import pytest
import torch

from camliflow_torch.models import camliraft as tm
from camliflow_torch.models import raft as traft
from camliflow_torch.models.camliraft_l import FlowHead3D, GRU3D, MotionEncoder3D
from camliflow_torch.nn.clfm import CLFM
from camliflow_torch.ops import _cuda, clfm, corr3d, fps, gather, interp, knn, update2d, update3d
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


def test_train_mode_runs_no_fused_wrapper_and_the_selections_at_their_counts(monkeypatch):
    """One train step's forward and backward: no fused wrapper (every one of
    them checks `_cuda.forward_only` first) is called; FPS once, KNN 8
    times (2 encoder levels, the fusion cache, the k=32 neighbours, the
    upsample's k=3, 3 pooling levels), the backwarp's interpolation and
    #4's index-only selection once an iteration, and #4 never with costs."""
    fused = []
    monkeypatch.setattr(_cuda, "forward_only", lambda name, *a: fused.append(name))
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
    port = model().train()
    inputs = batch(1, b=2)
    loss, _ = tm.loss_fn(port(inputs), inputs, CFGS)
    loss.backward()
    assert fused == []
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


@pytest.mark.parametrize("key", ["loss_in_scan", "remat_scan"])
def test_in_loop_loss_and_remat_are_not_ported(key):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.CamLiRAFT({**CFGS, key: True})


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
