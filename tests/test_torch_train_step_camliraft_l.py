"""PyTorch port, one train step of CamLiRAFT-L against the JAX package on
the CPU (tests/torch_train_parity.py): 512 points, n_samples_list
[256, 128, 64, 32, 16], 2 iterations, IDS on, batch 2, f32, the optimizer
of conf/training/flyingthings3d_subset/camliraft_l.yaml. The JAX package
labels every CamLiRAFT-L parameter 2D, so the 3D branch's norm is 0."""

import pytest
import torch

from camliflow_tpu.models import camliraft_l as jm
from camliflow_torch.models import camliraft_l as tm
from torch_train_parity import N_SAMPLES, Steps, make_batch

torch.set_num_threads(2)

CFGS = {"name": "camliraft_l", "n_iters_train": 2, "n_iters_eval": 2, "fast_inference": "auto",
        "ids": {"enabled": True}, "n_samples_list": N_SAMPLES,
        "loss": {"gamma": 0.8, "order": "l2-norm"}}
TRAINING = {"opt": "adamw", "lr": 2e-3, "weight_decay": 1e-6, "grad_max_norm": 1,
            "epochs": 100, "warmup_epochs": 2, "warmup_lr": 1e-5, "min_lr": 1e-5}


@pytest.fixture(scope="module")
def steps():
    return Steps(jm, jm.CamLiRAFTL, tm, tm.CamLiRAFTL, "camliraft_l", CFGS, TRAINING,
                 make_batch(0, images=False))


def test_train_step_loss(steps):
    steps.check_loss()


def test_train_step_loss_under_the_jax_selection_rule(steps):
    steps.check_loss_under_the_jax_selection_rule()


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
    assert out["flow_3d_seq"].shape == (2, 2, 512, 3)
