"""One training step: forward, loss, backward, clip, optimizer step (the
port's counterpart of camliflow_tpu/runtime/train_state.py's jitted
`train_step`). Parameters and optimizer state stay f32; the model's train
forward computes under its own `compute_dtype` (bf16 autocast with amp).
bf16 has f32's exponent range, so no loss scaling is needed. A model
class with `CONV_BENCHMARK` set (the PWC family) takes the whole step,
backward included, under `autotuned_convolutions`: cuDNN's heuristics
alone pick pathological algorithms for some of its convolutions.

`model` may be the Trainer's DistributedDataParallel wrapper: names and
class attributes are read from the module inside it, and with more than
one rank the losses' masked means are the global batch's
(`models/losses.py::global_means`) and the loss returned is the global
loss, the mean over the ranks."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..models.factory import param_group_label, set_learning_rates
from ..models.losses import global_means
from ..parallel import dist
from ..utils.torch_setup import autotuned_convolutions


def branch_grad_norms(model: nn.Module, model_name: str) -> dict[str, torch.Tensor]:
    """The gradient's norm over the 2D and over the 3D branch's parameters
    (the optimizer's partition), before clipping; on the device."""
    squares = {"2d": [], "3d": []}
    for name, param in dist.unwrap(model).named_parameters():
        if param.grad is not None:
            branch = param_group_label(name, param, model_name)[:2]
            squares[branch].append(param.grad.float().square().sum())
    return {f"grad_norm_{branch}": torch.sqrt(torch.stack(sums).sum()) if sums
            else torch.zeros(()) for branch, sums in squares.items()}


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict, loss_fn,
               cfgs, step: int, model_name: str = "camliraft"):
    """One update of `model` (in train mode) on `batch` (tensors on the
    model's device). `step` is the update's number, from 0, which sets the
    learning rates. Returns (loss, this rank's (sum, count) metrics,
    telemetry), every value a tensor on the device, so the caller chooses
    when to wait."""
    optimizer.zero_grad(set_to_none=True)
    tuned = getattr(dist.unwrap(model), "CONV_BENCHMARK", False)
    with (autotuned_convolutions() if tuned else contextlib.nullcontext(),
          global_means(dist.spread())):
        outputs = model(batch)
        loss, metrics = loss_fn(outputs, batch, cfgs)
        loss.backward()
    telemetry = branch_grad_norms(model, model_name)
    if optimizer.max_norm is not None:
        torch.nn.utils.clip_grad_norm_(
            [p for group in optimizer.param_groups for p in group["params"]],
            optimizer.max_norm)
    set_learning_rates(optimizer, step)
    optimizer.step()
    metrics = {key: (s.detach(), c.detach()) for key, (s, c) in metrics.items()}
    return dist.mean_over_ranks(loss.detach()), metrics, telemetry
