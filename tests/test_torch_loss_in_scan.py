"""PyTorch port, CamLiRAFT's two training switches on the CPU:
`loss_in_scan` (each iteration's sequence-loss terms added to running sums
inside the refinement loop, nothing stacked) and `remat_scan` (each
iteration under `torch.utils.checkpoint`, recomputed in the backward).

At tests/test_loss_in_scan.py's configuration (ResNet-18, 3 iterations,
60x68 images, not multiples of 8, so the 2D target is really padded, 512
points, batch 2; loss2d l2-norm gamma 0.8, loss3d l1 gamma 0.9):
- the port with both switches against the JAX package with both, one
  train step from the same variables through the weight bridge
  (tests/torch_train_parity.py: the loss to 1e-5 relative, every gradient
  within 1e-3 * (1 + max|g_jax|), the BatchNorm statistics to 1e-6, the
  final flows to 1e-5 m / 1e-4 px);
- the port's `loss_in_scan` against its own stacked path (`fuse_hidden`
  off and on): the loss to 1e-5 relative, the gradients within 1e-3 *
  (1 + max|g|), the final flows equal;
- `remat_scan` against no remat, f32 and under bf16 autocast: the loss,
  the flows and every gradient bit for bit, the BatchNorm running
  statistics bit for bit those of the step without remat (the recompute
  moves none: an iteration holds no BatchNorm, and a model whose iteration
  did is refused);
- the selections hoisted out of the checkpointed region: a remat step
  launches #1-#4 as often as a step without it;
- without targets `loss_in_scan` runs the stacked path;
- under `global_means` the in-loop masked means divide by losses.py's
  `_count`, all-reduced once a branch before the loop and never in the
  backward's recompute.
"""

import numpy as np
import pytest
import torch

from camliflow_tpu.models import camliraft as jm
from camliflow_torch.models import camliraft as tm
from camliflow_torch.models import losses
from camliflow_torch.nn.layers import BatchNorm
from camliflow_torch.runtime.checkpoint import random_weights
from test_torch_train_guards import count_wrappers
from torch_train_parity import Steps, make_batch

torch.set_num_threads(4)

CFGS = {"name": "camliraft", "freeze_bn": False, "backbone": {"depth": 18},
        "n_iters_train": 3, "n_iters_eval": 1, "fast_inference": "auto", "fuse_fnet": True,
        "fuse_cnet": True, "fuse_corr": True, "fuse_motion": True, "fuse_hidden": False,
        "n_samples_list": [256, 128, 64, 32, 16],
        "loss2d": {"gamma": 0.8, "order": "l2-norm"}, "loss3d": {"gamma": 0.9, "order": "l1"}}
BOTH = {**CFGS, "loss_in_scan": True, "remat_scan": True}
# conf/training/flyingthings3d_subset/camliraft.yaml
TRAINING = {"opt": "adamw", "lr_2d": 2e-4, "lr_3d": 2e-3, "weight_decay": 1e-6,
            "grad_max_norm": 1, "epochs": 150, "warmup_epochs": 2, "warmup_lr": 1e-5,
            "min_lr": 1e-5}
SHAPE = {"batch": 2, "h": 60, "w": 68, "n": 512}


def inputs(seed=0, targets=True):
    batch = {k: torch.from_numpy(v) for k, v in make_batch(seed, **SHAPE).items()}
    if not targets:
        batch = {k: v for k, v in batch.items() if k not in ("flow_2d", "flow_3d")}
    return batch


def step(cfgs, batch, seed=0, precision=None):
    """One forward and backward in train mode from seeded weights:
    (loss, outputs, {name: grad}, {name: buffer after the step})."""
    cfgs = {**cfgs, "compute_dtype": precision}
    port = tm.CamLiRAFT(cfgs)
    random_weights(port, seed)
    port.train()
    outputs = port(batch)
    loss, _ = tm.loss_fn(outputs, batch, cfgs)
    loss.backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    return loss.detach(), outputs, grads, {k: v.clone() for k, v in port.named_buffers()}


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's step with both switches against the port's."""
    return Steps(jm, jm.CamLiRAFT, tm, tm.CamLiRAFT, "camliraft", BOTH, TRAINING,
                 make_batch(0, **SHAPE), points=False)


def test_both_switches_match_the_jax_package(jax_steps):
    jax_steps.check_loss()
    jax_steps.check_gradients()
    jax_steps.check_batchnorm_statistics()
    jax_steps.check_branch_grad_norms(("2d", "3d"))


def test_both_switches_give_the_jax_package_s_final_flows(jax_steps):
    """The outputs carry the last iteration's flows (the metrics' inputs)
    and the two loss terms, and no sequence."""
    with torch.no_grad():
        outputs = jax_steps.bridged(BOTH).train()(jax_steps.torch_batch())
    assert "flow_2d_seq" not in outputs and {"loss_2d", "loss_3d"} <= set(outputs)
    want = jax_steps.ref["flows"]
    assert outputs["flow_2d"].shape == (2, 60, 68, 2) and outputs["flow_3d"].shape == (2, 512, 3)
    np.testing.assert_allclose(outputs["flow_2d"].numpy(), want["flow_2d"], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(outputs["flow_3d"].numpy(), want["flow_3d"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(outputs["loss_2d"] + outputs["loss_3d"]),
                               jax_steps.ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("fuse_hidden", [False, True], ids=["fuse_hidden-off", "fuse_hidden-on"])
def test_loss_in_scan_matches_the_stacked_path(fuse_hidden):
    cfgs = {**CFGS, "fuse_hidden": fuse_hidden}
    batch = inputs(1)
    loss, out, grads, _ = step(cfgs, batch)
    loss_in, out_in, grads_in, _ = step({**cfgs, "loss_in_scan": True}, batch)
    np.testing.assert_allclose(float(loss_in), float(loss), rtol=1e-5)
    assert "flow_2d_seq" in out and "flow_2d_seq" not in out_in
    for key in ("flow_2d", "flow_3d"):
        assert torch.equal(out_in[key], out[key]), key
    for key, g in grads.items():
        bound = 1e-3 * (1 + float(g.abs().max()))
        assert float((grads_in[key] - g).abs().max()) <= bound, key


@pytest.mark.parametrize("loss_in_scan", [False, True], ids=["stacked", "loss_in_scan"])
@pytest.mark.parametrize("precision", [None, "bfloat16"], ids=["f32", "bf16"])
def test_remat_is_bit_for_bit_no_remat(precision, loss_in_scan):
    cfgs = {**CFGS, "loss_in_scan": loss_in_scan}
    batch = inputs(2)
    loss, out, grads, buffers = step(cfgs, batch, precision=precision)
    loss_r, out_r, grads_r, buffers_r = step({**cfgs, "remat_scan": True}, batch,
                                             precision=precision)
    assert torch.isfinite(loss) and torch.equal(loss_r, loss)
    for key in ("flow_2d", "flow_3d"):
        assert torch.equal(out_r[key], out[key]), key
    for key, g in grads.items():
        assert torch.equal(grads_r[key], g), key
    moved = 0
    start = tm.CamLiRAFT(cfgs)
    random_weights(start, 0)
    for key, value in start.named_buffers():
        assert torch.equal(buffers_r[key], buffers[key]), key
        moved += not torch.equal(buffers[key], value)
    assert moved  # the train-mode BatchNorms did move, once


def test_remat_hoists_the_selections(monkeypatch):
    """A remat step launches #1 8 times, #2 once and #3 and #4's index-only
    form once an iteration, as a step without remat: the selections run
    before each checkpointed iteration, and its recompute runs none."""
    calls, checked = count_wrappers(monkeypatch)
    batch = inputs(3)
    counts = []
    for remat in (False, True):
        for key in calls:
            calls[key] = 0
        checked.clear()
        step({**CFGS, "loss_in_scan": True, "remat_scan": remat}, batch)
        counts.append(dict(calls))
        assert checked == [("knn_interpolation", False)] * 3
    assert counts[0] == counts[1] == {"fps": 1, "knn": 8, "interp": 3, "corr3d_index": 3,
                                      "corr3d_cost": 0}


def test_without_targets_loss_in_scan_runs_the_stacked_path():
    batch = inputs(4, targets=False)
    outputs = []
    for cfgs in (CFGS, {**CFGS, "loss_in_scan": True}):
        port = tm.CamLiRAFT(cfgs)
        random_weights(port, 0)
        with torch.no_grad():
            outputs.append(port.train()(batch))
    assert set(outputs[1]) == {"flow_2d", "flow_3d", "flow_2d_seq", "flow_3d_seq"}
    assert outputs[1]["flow_2d_seq"].shape[0] == CFGS["n_iters_train"]
    for key, value in outputs[0].items():
        assert torch.equal(outputs[1][key], value), key


def test_in_loop_means_go_through_global_means(monkeypatch):
    """Under `global_means` (one rank here: the all-reduce is a counted
    identity) each branch's count is taken by losses.py's `_count` and
    all-reduced once, before the loop; the loss is the local one."""
    batch = inputs(5)
    loss, _, _, _ = step({**CFGS, "loss_in_scan": True}, batch)
    reduced, counted = [], []
    count = losses._count

    def all_reduce(tensor, *args, **kwargs):
        reduced.append(torch.is_grad_enabled())
        return None

    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    monkeypatch.setattr(losses, "_count", lambda s: counted.append(1) or count(s))
    cfgs = {**CFGS, "loss_in_scan": True, "remat_scan": True}
    port = tm.CamLiRAFT(cfgs)
    random_weights(port, 0)
    port.train()
    with losses.global_means():
        outputs = port(batch)
        assert len(reduced) == len(counted) == 2
        got, _ = tm.loss_fn(outputs, batch, cfgs)
        got.backward()
    assert len(reduced) == len(counted) == 2
    assert torch.equal(got.detach(), loss)


def test_remat_refuses_an_iteration_with_a_batchnorm(monkeypatch):
    """A recomputed BatchNorm would move its running statistics twice."""
    tm.CamLiRAFT({**CFGS, "remat_scan": True})
    monkeypatch.setattr(tm.CamLiRAFTCore, "in_loop_modules", lambda self: [BatchNorm(4)])
    with pytest.raises(ValueError, match="BatchNorm"):
        tm.CamLiRAFT({**CFGS, "remat_scan": True})
    tm.CamLiRAFT(CFGS)
