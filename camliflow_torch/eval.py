"""Evaluation entry point of the port (counterpart of the repo's eval.py).

    python -m camliflow_torch.eval protocol=things testset=flyingthings3d_subset \\
        model=camliraft ckpt.path=<JAX variables .npz> [device=cpu] [key=value ...]

Composes the same `conf/` tree as eval.py, loads the JAX package's variables
through the weight bridge, and runs the `things` protocol. It runs on the
CUDA card unless `device=cpu` is given (there the kernels' plain versions
run); without a card and without `device=cpu` it raises. Ported so far:
`protocol=things` with `model=camliraft`, `model=camliraft_l` or
`model=raft`.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import torch

CONF_DIR = Path(__file__).resolve().parents[1] / "conf"
BATCH_SIZE = 8  # eval.py's Evaluator default


def resolve_device(name: str) -> torch.device:
    """`cuda` (the default) or `cpu`; never falls back from one to the other."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"device must be cuda|cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA card is visible; pass "
                           "device=cpu to run the plain versions on the CPU")
    return torch.device("cuda")


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    groups = {"testset": None, "model": None, "protocol": "things", "device": "cuda"}
    overrides = []
    for arg in argv:
        key, _, value = arg.partition("=")
        if key in groups:
            groups[key] = value
        else:
            overrides.append(arg)
    if groups["model"] is None:
        raise SystemExit("missing required group: model=<name>")
    if groups["protocol"] != "things":
        raise NotImplementedError(
            f"protocol={groups['protocol']} is not ported; see ROADMAP.md "
            "Queue 1 item 8 (eval protocols)"
        )
    device = resolve_device(groups["device"])

    from .data.datasets import batches, dataset_factory
    from .models.factory import model_factory
    from .runtime.checkpoint import load_jax_variables, load_npz
    from .runtime.evaluator import Evaluator
    from .utils.config import compose
    from .utils.torch_setup import setup_torch

    cfgs = compose(CONF_DIR, model=groups["model"], testset=groups["testset"],
                   overrides=overrides)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    setup_torch()
    logging.getLogger("camliflow_torch").info("device: %s", device)

    model = model_factory(cfgs.model)(cfgs.model.to_dict())
    if cfgs.ckpt.path is None:
        raise SystemExit("missing ckpt.path=<JAX variables .npz>")
    load_jax_variables(model, load_npz(cfgs.ckpt.path), cfgs.model.name)
    dataset = dataset_factory(cfgs.testset)
    return Evaluator(model, device).run_things(batches(dataset, BATCH_SIZE))


if __name__ == "__main__":
    main()
