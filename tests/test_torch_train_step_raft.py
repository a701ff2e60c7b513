"""PyTorch port, one train step of RAFT against the JAX package on the CPU
(tests/torch_train_parity.py): conf/model/raft.yaml's ResNet-50 on 64x96
images, 2 iterations, batch 2, f32, the optimizer of
conf/training/flyingthings3d_subset/raft.yaml. The backbone's BatchNorms
keep their running statistics in training; every parameter is 2D."""

import pytest
import torch

from camliflow_tpu.models import raft as jm
from camliflow_torch.models import raft as tm
from torch_train_parity import Steps, make_batch

torch.set_num_threads(2)

CFGS = {"name": "raft", "backbone": {"depth": 50, "pretrained": None}, "n_iters_train": 2,
        "n_iters_eval": 2, "fast_inference": "auto", "loss": {"gamma": 0.8, "order": "l2-norm"}}
TRAINING = {"opt": "adamw", "lr": 2e-4, "weight_decay": 1e-6, "grad_max_norm": 1,
            "epochs": 200, "warmup_epochs": 5, "warmup_lr": 1e-5, "min_lr": 0}


@pytest.fixture(scope="module")
def steps():
    return Steps(jm, jm.RAFT, tm, tm.RAFT, "raft", CFGS, TRAINING,
                 make_batch(0, points=False), points=False)


def test_train_step_loss(steps):
    steps.check_loss()


def test_train_step_gradients(steps):
    steps.check_gradients()


def test_train_step_branch_grad_norms(steps):
    steps.check_branch_grad_norms({"2d"})


def test_train_step_batchnorm_statistics(steps):
    steps.check_batchnorm_statistics()


def test_train_step_parameters_after_the_clipped_adamw_step(steps):
    steps.check_parameters_after_the_step()


def test_train_step_amp_losses_are_close_to_f32(steps):
    out = steps.check_amp()
    assert out["flow_2d_seq"].shape == (2, 2, 64, 96, 2)
