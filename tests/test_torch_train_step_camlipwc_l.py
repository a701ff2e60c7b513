"""PyTorch port, one train step of CamLiPWC-L against the JAX package on
the CPU (tests/torch_train_parity.py): 512 points, n_samples_list
[256, 128, 64, 32, 16], IDS on, batch 2, f32, the optimizer of
conf/training/flyingthings3d_subset/camlipwc_l.yaml. Every interpolation
of the flow (the level upsamples, the backwarps, the five levels' final
upsamples) runs in its differentiable train form; the pyramid's
BatchNorms take batch statistics per frame. The JAX package labels every
CamLiPWC-L parameter 2D."""

import pytest
import torch

from camliflow_tpu.models import camlipwc_l as jm
from camliflow_torch.models import camlipwc_l as tm
from torch_train_parity import N_SAMPLES, Steps, make_batch

torch.set_num_threads(2)

CFGS = {"name": "camlipwc_l", "ids": {"enabled": True}, "n_samples_list": N_SAMPLES,
        "norm": {"feature_pyramid": "batch_norm", "correlation": None, "flow_estimator": None},
        "loss": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"}}
TRAINING = {"opt": "adamw", "lr": 1e-3, "weight_decay": 1e-6, "grad_max_norm": 20,
            "epochs": 300, "warmup_epochs": 2, "warmup_lr": 1e-5, "min_lr": 1e-5}


@pytest.fixture(scope="module")
def steps():
    return Steps(jm, jm.CamLiPWCL, tm, tm.CamLiPWCL, "camlipwc_l", CFGS, TRAINING,
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
    assert [tuple(f.shape) for f in out["flows_3d"]] == [(2, n, 3) for n in [512] + N_SAMPLES[:4]]
    assert [tuple(i.shape) for i in out["sample_indices1"]] == [(2, n) for n in
                                                                 [512] + N_SAMPLES]
