"""The ranks of tests/test_torch_parallel.py: functions that
`camliflow_torch.parallel.dist.spawn` runs in processes of their own, on the
CPU over gloo (not collected as tests).

A spawned process imports the module that holds its function, so this one
imports torch and the port only, never JAX: the test computes the JAX side
in its own process, and the two exchange arrays through `.npz` files in a
work directory. Each function writes its rank's results there as
`<case>.rank<r>.npz` (or `.json`).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from camliflow_torch import eval as torch_eval
from camliflow_torch import train as torch_train
from camliflow_torch.data.datasets import batches, dataset_factory
from camliflow_torch.models import losses
from camliflow_torch.models.factory import model_factory, optimizer_factory, training_functions
from camliflow_torch.nn.layers import BatchNorm
from camliflow_torch.parallel import dist
from camliflow_torch.runtime.checkpoint import load_jax_variables, load_npz, load_weights
from camliflow_torch.runtime.evaluator import Evaluator
from camliflow_torch.runtime.train_state import train_step
from camliflow_torch.utils.config import compose


def my_slice(array: np.ndarray, axis: int = 0) -> np.ndarray:
    """This rank's contiguous slice of a global batch."""
    return np.split(array, dist.world_size(), axis)[dist.rank()]


def train_steps(device, work: str, cases: list[str]) -> None:
    """For each case: the port's model from `<case>.variables.npz` (flat JAX
    variables, through the weight bridge) in DDP, one `train_step` on this
    rank's slice of `<case>.batch.npz`, with the model and optimizer config
    of `<case>.json`; writes the global loss, the telemetry, every gradient,
    parameter and buffer after the step."""
    torch.set_num_threads(1)
    work = Path(work)
    for case in cases:
        spec = json.loads((work / f"{case}.json").read_text())
        cfgs, name = spec["cfgs"], spec["cfgs"]["name"]
        model = model_factory(cfgs)(cfgs)
        load_jax_variables(model, load_npz(work / f"{case}.variables.npz"), name)
        model.to(device).train()
        optimizer = optimizer_factory(spec["training"], model, steps_per_epoch=4,
                                      model_name=name)
        batch = {k: torch.from_numpy(my_slice(v))
                 for k, v in load_npz(work / f"{case}.batch.npz").items()}
        loss_fn, _ = training_functions(name)
        loss, _, telemetry = train_step(dist.wrap(model, device), optimizer, batch, loss_fn,
                                        cfgs, 0, name)
        out = {"loss": loss.numpy()}
        out.update({f"telemetry/{k}": v.numpy() for k, v in telemetry.items()})
        for key, param in model.named_parameters():
            out[f"grad/{key}"] = param.grad.numpy()
            out[f"param/{key}"] = param.detach().numpy()
        out.update({f"buffer/{k}": v.numpy() for k, v in model.named_buffers()})
        np.savez(work / f"{case}.rank{dist.rank()}.npz", **out)


LOSSES = ("sequence_3d", "pyramid_2d", "pyramid_3d")


def loss_inputs(kind: str, seed: int = 0) -> dict:
    """A loss's predictions and target at batch 4, whose validity masks give
    each half of the batch a different count (dense in the first half,
    sparse in the second)."""
    rng = np.random.RandomState(seed)
    density = np.repeat([0.9, 0.2], 2)
    if kind == "pyramid_2d":
        valid = rng.rand(4, 32, 48) < density[:, None, None]
        target = np.concatenate([rng.randn(4, 32, 48, 2), valid[..., None]], -1)
        preds = [rng.randn(4, 32 >> i, 48 >> i, 2) for i in range(3)]
        return {"target": target, **{f"pred{i}": p for i, p in enumerate(preds)}}
    valid = rng.rand(4, 256) < density[:, None]
    target = np.concatenate([rng.randn(4, 256, 3), valid[..., None]], -1)
    if kind == "sequence_3d":
        return {"target": target, "pred0": rng.randn(3, 4, 256, 3)}
    out = {"target": target}
    for i, n in enumerate((256, 128, 64)):
        out[f"pred{i}"] = rng.randn(4, n, 3)
        out[f"index{i}"] = np.stack([rng.permutation(256)[:n] for _ in range(4)])
    return out


def loss_of(kind: str, arrays: dict, preds: list):
    """The port's loss of `kind` on `preds` (tensors) and `arrays`' target."""
    target = torch.as_tensor(arrays["target"], dtype=torch.float32)
    if kind == "sequence_3d":
        return losses.calc_sequence_loss(preds[0], target, gamma=0.8, order="l2-norm")
    if kind == "pyramid_2d":
        return losses.calc_pyramid_loss_2d(preds, target, [4.0, 2.0, 1.0], "robust")
    indices = [torch.as_tensor(arrays[f"index{i}"]) for i in range(3)]
    return losses.calc_pyramid_loss_3d(preds, target, [4.0, 2.0, 1.0], "l2-norm", indices)


def global_losses(device, work: str) -> None:
    """Each loss on this rank's slice under `global_means`: the mean of the
    ranks' losses and this rank's prediction gradients over the world size
    (the global loss's, as DDP would average them)."""
    torch.set_num_threads(1)
    out = {}
    for kind in LOSSES:
        arrays = {k: my_slice(v, int(kind == "sequence_3d" and k == "pred0"))
                  for k, v in loss_inputs(kind).items()}
        preds = [torch.tensor(arrays[f"pred{i}"], dtype=torch.float32, requires_grad=True)
                 for i in range(3) if f"pred{i}" in arrays]
        with losses.global_means():
            loss = loss_of(kind, arrays, preds)
        loss.backward()
        out[f"{kind}/loss"] = dist.mean_over_ranks(loss.detach()).numpy()
        for i, pred in enumerate(preds):
            out[f"{kind}/grad{i}"] = pred.grad.numpy() / dist.world_size()
    np.savez(Path(work) / f"losses.rank{dist.rank()}.npz", **out)


def batchnorm_inputs(channel_dim: int, seed: int = 0) -> np.ndarray:
    """Batch 4, channel means of about 1, the channels at dim 1 (NCHW) or
    last."""
    rng = np.random.RandomState(seed)
    shape = (4, 6, 5, 7) if channel_dim == 1 else (4, 33, 6)
    return (1.0 + rng.randn(*shape)).astype(np.float32)


def batchnorm_run(channel_dim: int, x: np.ndarray, seed: int = 1) -> dict:
    """A train-mode BatchNorm (perturbed weights and running statistics) on
    `x`: its output, the gradients of sum(out * w) for seeded w, and the
    running statistics after."""
    rng = np.random.RandomState(seed)
    norm = BatchNorm(6, channel_dim=channel_dim).train()
    with torch.no_grad():
        for t, scale in ((norm.weight, 0.1), (norm.bias, 0.1), (norm.running_mean, 0.1)):
            t.add_(torch.from_numpy(scale * rng.randn(6).astype(np.float32)))
    weights = rng.randn(*batchnorm_inputs(channel_dim).shape).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out = norm(xt)
    (out * torch.from_numpy(my_slice(weights))).sum().backward()
    return {"out": out.detach().numpy(), "x_grad": xt.grad.numpy(),
            "weight_grad": norm.weight.grad.numpy(), "bias_grad": norm.bias.grad.numpy(),
            "running_mean": norm.running_mean.numpy(), "running_var": norm.running_var.numpy()}


def global_batchnorm(device, work: str) -> None:
    """`batchnorm_run` on this rank's slice, for both channel layouts."""
    torch.set_num_threads(1)
    out = {}
    for channel_dim in (-1, 1):
        run = batchnorm_run(channel_dim, my_slice(batchnorm_inputs(channel_dim)))
        out.update({f"{channel_dim}/{k}": v for k, v in run.items()})
    np.savez(Path(work) / f"batchnorm.rank{dist.rank()}.npz", **out)


def evaluate(device, work: str, argv: list[str]) -> None:
    """The eval entry point (`things`, global batches of 8) on `argv`, and
    the scene-flow protocol's two sums (per point, per sample) through the
    Evaluator on the same set in global batches of 2, in this rank's group;
    writes the totals."""
    torch.set_num_threads(1)
    out = {"things": torch_eval.main(argv)}
    keys = [arg.partition("=")[0] for arg in argv]
    groups = {k: arg.partition("=")[2] for k, arg in zip(keys, argv)
              if k in ("model", "testset", "protocol", "device")}
    cfgs = compose(torch_eval.CONF_DIR, model=groups["model"], testset=groups["testset"],
                   overrides=[arg for k, arg in zip(keys, argv) if k not in groups])
    model = model_factory(cfgs.model)(cfgs.model.to_dict())
    load_weights(model, cfgs.ckpt.path, cfgs.model.name)
    evaluator = Evaluator(model, device)
    dataset = dataset_factory(cfgs.testset)
    for per_sample in (False, True):
        out[f"sf_per_sample={per_sample}"] = evaluator.run_sf_protocol(
            batches(dataset, 2, dist.rank(), dist.world_size()), per_sample, False)
    (Path(work) / f"eval.rank{dist.rank()}.json").write_text(
        json.dumps({k: {m: float(v) for m, v in r.items()} for k, r in out.items()}))


def train_cli(device, work: str, argv: list[str]) -> None:
    """`camliflow_torch.train.main(argv)` in this rank's group; writes the
    losses of the last epoch's steps and the state after."""
    torch.set_num_threads(1)
    trainer = torch_train.main(argv)
    np.savez(Path(work) / f"train_cli.rank{dist.rank()}.npz",
             losses=np.array([h["loss"] for h in trainer.history]),
             **{f"state/{k}": v.numpy() for k, v in trainer.model.state_dict().items()})


def two_rank_cases(device, work: str, cases: list[str], eval_argv: list[str]) -> None:
    """Every two-rank case of the test in one group: the train steps, the
    losses, BatchNorm, then the evaluation."""
    train_steps(device, work, cases)
    global_losses(device, work)
    global_batchnorm(device, work)
    evaluate(device, work, eval_argv)
