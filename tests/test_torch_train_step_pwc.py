"""PyTorch port, one train step of PWC against the JAX package on the CPU
(tests/torch_train_parity.py): conf/model/pwc.yaml on 128x192 images (the
1/64 level 2x3), batch 2, f32, the optimizer of
conf/training/flyingthings3d_subset/pwc.yaml (Adam, its weight decay an L2
term). The feature pyramid's BatchNorms take batch statistics, each
frame's call updating the running ones in turn; every parameter is 2D. (At
64x96 the 1/64 level is 1x2: BatchNorm statistics over 4 samples, where
flax's E[x^2] - E[x]^2 variance cancels, move by more than the bounds.)"""

import pytest
import torch

from camliflow_tpu.models import pwc as jm
from camliflow_torch.models import pwc as tm
from torch_train_parity import Steps, make_batch

torch.set_num_threads(2)

CFGS = {"name": "pwc", "max_displacement": 4, "lite_estimator": False,
        "norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                 "context_network": None},
        "loss": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"}}
TRAINING = {"opt": "adam", "lr": 1e-3, "weight_decay": 1e-6, "eps": 1e-7, "grad_max_norm": 20.0,
            "epochs": 200, "warmup_epochs": 10, "warmup_lr": 1e-4, "min_lr": 1e-5}


@pytest.fixture(scope="module")
def steps():
    return Steps(jm, jm.PWC, tm, tm.PWC, "pwc", CFGS, TRAINING,
                 make_batch(0, h=128, w=192, points=False), points=False)


def test_train_step_loss(steps):
    steps.check_loss()


def test_train_step_gradients(steps):
    steps.check_gradients()


def test_train_step_branch_grad_norms(steps):
    steps.check_branch_grad_norms({"2d"})


def test_train_step_batchnorm_statistics(steps):
    steps.check_batchnorm_statistics()


def test_train_step_parameters_after_the_clipped_adam_step(steps):
    steps.check_parameters_after_the_step()


def test_train_step_amp_losses_are_close_to_f32(steps):
    out = steps.check_amp()
    assert [tuple(f.shape) for f in out["flows_2d"]] == [(2, 128, 192, 2), (2, 64, 96, 2),
                                                        (2, 32, 48, 2), (2, 16, 24, 2),
                                                        (2, 8, 12, 2)]
    assert out["flow_2d"].shape == (2, 128, 192, 2)
