"""PyTorch port, one train step of CamLiPWC against the JAX package on the
CPU (tests/torch_train_parity.py): conf/model/camlipwc.yaml (all three
fusions) on 128x192 images and 512 points, n_samples_list
[256, 128, 64, 32, 16], batch 2, f32, the optimizer of
conf/training/flyingthings3d_subset/camlipwc.yaml; and `freeze_bn`, which
keeps every BatchNorm on its running statistics in train mode. Also the
KITTI fine-tune's step (`freeze_bn`, conf/training/kitti/camlipwc.yaml's
optimizer without warm-up, KITTI's targets: a 3D validity channel, no
occlusion mask) at 128x160, a width the model resizes to 192, as KITTI's
1242 to 1280, and the pyramid loss resizes every level's flow back to 160
against the target. (At 64x96
the 2D pyramid's 1/64 level is 1x2: BatchNorm statistics over 4 samples,
where flax's E[x^2] - E[x]^2 variance cancels, move by more than the
bounds.)"""

import numpy as np
import pytest
import torch

from camliflow_tpu.models import camlipwc as jm
from camliflow_torch.models import camlipwc as tm
from camliflow_torch.nn.layers import BatchNorm
from torch_train_parity import N_SAMPLES, Steps, make_batch

torch.set_num_threads(2)

CFGS = {"name": "camlipwc", "freeze_bn": False, "n_samples_list": N_SAMPLES,
        "pwc2d": {"norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                           "context_network": None},
                  "max_displacement": 4, "lite_estimator": False, "fixed": False},
        "pwc3d": {"norm": {"feature_pyramid": "batch_norm", "correlation": None,
                           "flow_estimator": None},
                  "fixed": False, "k": 16},
        "fusion": {"fuse_pyramid": True, "fuse_correlation": True, "fuse_estimator": True},
        "loss2d": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"},
        "loss3d": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"}}
TRAINING = {"opt": "adamw", "lr_2d": 5e-4, "lr_3d": 1e-3, "weight_decay": 1e-6,
            "grad_max_norm": 20, "epochs": 600, "warmup_epochs": 2, "warmup_lr": 1e-5,
            "min_lr": 1e-5}
# conf/training/kitti/camlipwc.yaml (and its `override: model: freeze_bn: true`)
KITTI_TRAINING = {"opt": "adamw", "lr_2d": 1e-4, "lr_3d": 2e-4, "weight_decay": 1e-6,
                  "grad_max_norm": 20, "epochs": 1000, "warmup_epochs": 0, "warmup_lr": 1e-5,
                  "min_lr": 1e-5}


def kitti_batch():
    """KITTI's targets: the 3D flow with a validity channel of ones, no
    occlusion mask."""
    batch = make_batch(0, h=128, w=160)
    flow_3d = batch.pop("flow_3d")
    del batch["occ_mask_3d"]
    return {**batch, "flow_3d": np.concatenate([flow_3d, np.ones_like(flow_3d[..., :1])], -1)}


CASES = {"things": (CFGS, TRAINING, lambda: make_batch(0, h=128, w=192)),
         "kitti": ({**CFGS, "freeze_bn": True}, KITTI_TRAINING, kitti_batch)}


@pytest.fixture(scope="module")
def cache():
    return {}


def run_steps(case, cache):
    if case not in cache:
        cfgs, training, batch = CASES[case]
        cache[case] = Steps(jm, jm.CamLiPWC, tm, tm.CamLiPWC, "camlipwc", cfgs, training,
                            batch())
    return cache[case]


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request, cache):
    return run_steps(request.param, cache)


@pytest.fixture
def things(cache):
    return run_steps("things", cache)


def test_train_step_loss(steps):
    steps.check_loss()


def test_train_step_loss_under_the_jax_selection_rule(steps):
    steps.check_loss_under_the_jax_selection_rule()


def test_train_step_gradients(steps):
    steps.check_gradients()


def test_train_step_branch_grad_norms(steps):
    steps.check_branch_grad_norms({"2d", "3d"})


def test_train_step_batchnorm_statistics(steps):
    steps.check_batchnorm_statistics()


def test_train_step_parameters_after_the_clipped_adamw_step(steps):
    steps.check_parameters_after_the_step()


def test_train_step_amp_losses_are_close_to_f32(things):
    out = things.check_amp()
    assert [tuple(f.shape) for f in out["flows_2d"]] == [(2, 128, 192, 2), (2, 64, 96, 2),
                                                        (2, 32, 48, 2), (2, 16, 24, 2),
                                                        (2, 8, 12, 2)]
    assert [tuple(f.shape) for f in out["flows_3d"]] == [(2, n, 3) for n in [512] + N_SAMPLES[:4]]


def test_freeze_bn_keeps_every_batchnorm_still(things):
    """With `freeze_bn` the train step moves no running statistic, and its
    BatchNorms normalise with them: its loss is the eval-mode normalisation's
    (the JAX package's `train=False`), not the batch statistics' one."""
    cfgs = {**CFGS, "freeze_bn": True}
    port = things.bridged(cfgs).train()
    assert port.training and port.core.training
    assert all(not m.training for m in port.modules() if isinstance(m, BatchNorm))
    before = {k: v.clone() for k, v in port.named_buffers()}
    inputs = things.torch_batch()
    loss, _ = tm.loss_fn(port(inputs), inputs, cfgs)
    loss.backward()
    for key, value in port.named_buffers():
        assert torch.equal(value, before[key]), key
    assert all(p.grad is not None for p in port.parameters())
    assert not np.isclose(float(loss.detach()), things.loss, rtol=1e-3)
