"""Model registry and optimizer factory: the port's counterpart of
camliflow_tpu/models/factory.py. Ported so far: CamLiRAFT, CamLiRAFT-L and
RAFT (all three for eval, CamLiRAFT for training).

The optimizer realises the reference's 4-group partition (2D/3D x
decay/no-decay) with per-branch learning rates as 4 param groups of one
`torch.optim.AdamW` (or `Adam`, whose weight decay is L2 added to the
gradient before the moments, as optax's `add_decayed_weights` before
`adam`), under the timm-style cosine schedule with warm-up, epoch-granular
and evaluated at every step.
"""

from __future__ import annotations

import functools
import math
import re

import torch
from torch import nn

from ..runtime.names import PREFIX_TABLES
from . import camliraft, camliraft_l, raft

_REGISTRY: dict[str, type[nn.Module]] = {
    "camliraft": camliraft.CamLiRAFT,
    "camliraft_l": camliraft_l.CamLiRAFTL,
    "raft": raft.RAFT,
}
# loss and model-selection functions of the models the port trains
_TRAINING = {"camliraft": (camliraft.loss_fn, camliraft.is_better)}
GROUPS = ("2d_decay", "3d_decay", "2d_no_decay", "3d_no_decay")
# a JAX module-path component of the 3D branch (camliflow_tpu's rule)
_3D_COMPONENT = re.compile(r"^(branch_3d.*|.*_3d|correlation3d.*|fnet3d.*|corr3d.*)$")


def model_factory(cfgs) -> type[nn.Module]:
    """Look up a model class by `cfgs["name"]` (or a bare name)."""
    name = cfgs["name"] if isinstance(cfgs, dict) else cfgs
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"Unknown or not yet ported model: {name} (ported: "
            f"{sorted(_REGISTRY)}; see ROADMAP.md Queue 1)"
        )
    return _REGISTRY[name]


def training_functions(name: str):
    """(loss_fn, is_better) of a model the port trains."""
    if name not in _TRAINING:
        raise NotImplementedError(
            f"training {name} is not ported (ported: {sorted(_TRAINING)}; see ROADMAP.md "
            "Queue 1, item 9)")
    return _TRAINING[name]


def jax_module_path(name: str, model_name: str) -> tuple[str, ...]:
    """The JAX module path (its components, without the leaf's own name's
    suffix) under which the JAX package holds the parameter the port
    names `name`: the weight bridge's prefix table read backwards."""
    for jax_prefix, torch_prefix in sorted(PREFIX_TABLES[model_name],
                                           key=lambda kv: -len(kv[1])):
        if name.startswith(torch_prefix):
            return tuple(jax_prefix.strip("/").split("/"))
    raise KeyError(f"parameter {name} has no JAX module path in the {model_name} table")


def param_group_label(name: str, param: torch.Tensor, model_name: str) -> str:
    """One of the 4 optimizer groups, as the JAX package labels the same
    parameter: 3D iff a component of its JAX module path belongs to the 3D
    branch; no decay for 1-dim parameters and biases."""
    return _label(name, param.dim(), model_name)


@functools.lru_cache(maxsize=None)
def _label(name: str, ndim: int, model_name: str) -> str:
    is_3d = any(_3D_COMPONENT.match(c) for c in jax_module_path(name, model_name))
    no_decay = ndim <= 1 or name.endswith(".bias")
    return f"{'3d' if is_3d else '2d'}_{'no_decay' if no_decay else 'decay'}"


def timm_cosine_schedule(base_lr: float, epochs: int, steps_per_epoch: int,
                         warmup_epochs: int = 0, warmup_lr: float = 1e-5,
                         min_lr: float = 0.0):
    """step -> learning rate: timm's CosineLRScheduler stepped once an epoch
    (warmup_prefix=False), so the rate is constant over an epoch; linear
    warm-up in the epoch index, then the cosine over all `epochs`."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if epoch < warmup_epochs:
            return warmup_lr + (base_lr - warmup_lr) * epoch / max(warmup_epochs, 1)
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1.0 + math.cos(math.pi * epoch / max(epochs, 1)))

    return schedule


def optimizer_factory(cfgs, model: nn.Module, steps_per_epoch: int,
                      model_name: str = "camliraft") -> torch.optim.Optimizer:
    """The 4-group Adam/AdamW with per-branch rates of `cfgs` (the training
    group). Each param group carries its `label`; `optimizer.schedules`
    holds one schedule per group (`set_learning_rates` applies them);
    `optimizer.max_norm` is the global gradient-norm clip (None: off)."""
    lr = cfgs.get("lr", None)
    base = {"2d": float(cfgs.get("lr_2d", lr)), "3d": float(cfgs.get("lr_3d", lr))}
    weight_decay = float(cfgs.get("weight_decay", 0.0))
    members = {label: [] for label in GROUPS}
    for name, param in model.named_parameters():
        if param.requires_grad:
            members[param_group_label(name, param, model_name)].append(param)
    groups = [{"params": members[label], "label": label, "lr": base[label[:2]],
               "weight_decay": 0.0 if label.endswith("no_decay") else weight_decay}
              for label in GROUPS if members[label]]
    opt = str(cfgs.get("opt", "adamw"))
    if opt not in ("adamw", "adam"):
        raise ValueError(f"training.opt must be adamw or adam, got {opt!r}")
    cls = torch.optim.AdamW if opt == "adamw" else torch.optim.Adam
    optimizer = cls(groups, eps=float(cfgs.get("eps", 1e-8)))
    optimizer.schedules = [
        timm_cosine_schedule(group["lr"], int(cfgs.get("epochs", 100)), steps_per_epoch,
                             int(cfgs.get("warmup_epochs", 0)),
                             float(cfgs.get("warmup_lr", 1e-5)), float(cfgs.get("min_lr", 0.0)))
        for group in optimizer.param_groups
    ]
    max_norm = cfgs.get("grad_max_norm", None)
    optimizer.max_norm = float(max_norm) if max_norm else None
    return optimizer


def set_learning_rates(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Each group's rate at update number `step` (0 for the first)."""
    for group, schedule in zip(optimizer.param_groups, optimizer.schedules):
        group["lr"] = schedule(step)
