"""Weight bridge (JAX variables -> the port's state_dict), the trainer's
checkpoints, and ImageNet backbone weights.

The JAX package stores its variables as '/'-joined paths (`params/...`,
`batch_stats/...`; `camliflow_tpu/runtime/checkpoint.py::tree_to_flat`, and
the flat `.npz` files it writes). The port's modules carry the reference
PyTorch state_dict names, so `names.our_path_to_torch` names each key. Each
tensor takes the inverse of the reference->JAX relayout:
- a Conv kernel [kh, kw, I, O] becomes a Conv2d weight [O, I, kh, kw];
- a Dense kernel [I, O] becomes a Linear weight [O, I], or a 1x1 Conv2d
  weight [O, I, 1, 1] where the port's module is a Conv2d;
- BatchNorm scale/bias/mean/var become weight/bias/running_mean/running_var
  (the names carry that; the values keep their shape).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..parallel.dist import unwrap
from .names import our_path_to_torch


def relayout(array: np.ndarray, target_shape: tuple | None = None) -> np.ndarray:
    """A JAX kernel in the port's layout; `target_shape` (the port
    parameter's shape) tells a Dense kernel headed for a 1x1 Conv2d."""
    if array.ndim == 4:
        out = array.transpose(3, 2, 0, 1)
    elif array.ndim == 2:
        out = array.T
        if target_shape is not None and len(target_shape) == 4:
            out = out[:, :, None, None]
    else:
        raise ValueError(f"cannot relayout a kernel of shape {array.shape}")
    if target_shape is not None and tuple(out.shape) != tuple(target_shape):
        raise ValueError(f"kernel {array.shape} does not fit {tuple(target_shape)}")
    return out


def state_dict_from_jax(flat: dict[str, np.ndarray], model_name: str | None,
                        shapes: dict[str, tuple] | None = None) -> dict:
    """Map every JAX leaf to a state_dict entry; raise if one does not land.
    `shapes` (state_dict key -> shape) lets 2-D kernels land in 1x1 convs."""
    out = {}
    for path, value in flat.items():
        _, rest = path.split("/", 1)
        key = our_path_to_torch(rest, model_name)
        if key is None:
            raise KeyError(f"JAX leaf {path} has no state_dict name")
        if key in out:
            raise KeyError(f"JAX leaves collide on state_dict key {key}")
        array = np.asarray(value, dtype=np.float32)
        if path.endswith("/kernel"):
            array = relayout(array, None if shapes is None else shapes.get(key))
        out[key] = torch.tensor(np.ascontiguousarray(array))
    return out


def load_jax_variables(model: nn.Module, flat: dict, model_name: str | None) -> None:
    """Fill `model` from flat JAX variables. Strict: every JAX leaf must land
    and every parameter and buffer of the model must be filled. With
    `model_name` None, `model` is a building block (a CLFM, a PointNet2,
    ...) and `flat` its JAX module's own variables."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(state_dict_from_jax(flat, model_name, shapes), strict=True)


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Read a flat `.npz` of JAX variables (as the JAX package saves them)."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def random_weights(model: nn.Module, seed: int) -> None:
    """Fill every parameter and buffer from one seeded generator: Linear and
    Conv2d U(+-1/sqrt(fan_in)), fan_in = I*kh*kw, as torch initialises
    them; every BatchNorm (the backbone's too) perturbed from (1, 0, 0, 1)
    so that the normalisation does real work."""
    from ..nn.layers import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    filled = set()
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, BatchNorm):
                module.weight.copy_(1.0 + 0.1 * torch.randn(module.weight.shape, generator=gen))
                module.bias.copy_(0.1 * torch.randn(module.bias.shape, generator=gen))
                module.running_mean.copy_(0.1 * torch.randn(module.running_mean.shape,
                                                            generator=gen))
                module.running_var.copy_(1.0 + 0.5 * torch.rand(module.running_var.shape,
                                                                generator=gen))
            elif isinstance(module, (nn.Linear, nn.Conv2d)):
                bound = module.weight[0].numel() ** -0.5
                for t in (module.weight, module.bias):
                    if t is not None:
                        t.copy_((2 * torch.rand(t.shape, generator=gen) - 1) * bound)
            else:
                continue
            filled.update(f"{name}.{key}" for key in module.state_dict())
    missing = set(model.state_dict()) - filled
    if missing:
        raise RuntimeError(f"random_weights left these unfilled: {sorted(missing)[:5]}")


# --- the trainer's checkpoints -------------------------------------------


def save_train_checkpoint(path: str | Path, model: nn.Module, optimizer: torch.optim.Optimizer,
                          last_epoch: int, step: int) -> None:
    """The model's state, the optimizer's state (the JAX trainer keeps it
    too; the reference drops it), the last finished epoch and the update
    count, in one `torch.save` file, written under a temporary name first,
    so a reader sees a whole file or none. A DDP wrapper's module is saved,
    so the names carry no `module.`: a run of any number of ranks reads it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save({"model": unwrap(model).state_dict(), "optimizer": optimizer.state_dict(),
                "last_epoch": int(last_epoch), "step": int(step)}, tmp)
    tmp.replace(path)


def load_train_checkpoint(path: str | Path) -> dict:
    """A `save_train_checkpoint` file, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(model: nn.Module, path: str | Path, model_name: str) -> None:
    """Fill `model` from `path`: the JAX package's flat `.npz` through the
    weight bridge, or a trainer checkpoint of the port (strict both)."""
    model = unwrap(model)
    if Path(path).suffix == ".npz":
        load_jax_variables(model, load_npz(path), model_name)
    else:
        model.load_state_dict(load_train_checkpoint(path)["model"], strict=True)


def load_backbone_pretrained(model: nn.Module, path: str | Path) -> int:
    """ImageNet ResNet weights (a torchvision-named state_dict in a `.pth`/
    `.pt`, or the same names in an `.npz`) into every 2D backbone of the
    model (its `ResNetEncoder2D`s, whose names are torchvision's), the align
    conv excepted. Returns the number of tensors loaded."""
    from ..nn.resnet import ResNetEncoder2D

    path = Path(path)
    if path.suffix == ".npz":
        source = {k: torch.from_numpy(v) for k, v in load_npz(path).items()}
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        source = payload.get("state_dict", payload)
    loaded = 0
    with torch.no_grad():
        for module in model.modules():
            if not isinstance(module, ResNetEncoder2D):
                continue
            for name, tensor in module.state_dict().items():
                src = source.get(name)
                if name.startswith("align.") or src is None or src.shape != tensor.shape:
                    continue
                tensor.copy_(src)
                loaded += 1
    return loaded
