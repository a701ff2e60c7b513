"""Data parallelism over processes, one rank a card: the port's counterpart
of camliflow_tpu/parallel/mesh.py.

The JAX package builds a 1-D mesh over its devices, replicates parameters
and optimizer state, and shards each global batch over the mesh; XLA then
inserts the gradient all-reduce, and BatchNorm's statistics and every
masked-mean loss are taken over the global batch. The port runs one
process a card (`torch.distributed` and `DistributedDataParallel`) and
computes the same: N ranks at a global batch B take the step the mesh takes
at B. `nn/layers.py::BatchNorm` all-reduces its sums in train mode,
`models/losses.py` divides by the all-reduced masks' counts
(`global_means`), `data/loader.py` gives each rank a contiguous slice of
every global batch, and the Evaluator sums its accumulators over the ranks
(`all_reduce_sums`).

Joining a group: `join` (a rank given its number, the world's size and a
rendezvous), `join_from_env` (torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT), or `spawn`, which starts the ranks on this
host with a localhost rendezvous. The backend is NCCL where each rank has a
card of its own, gloo on the CPU and where ranks share a card. Nothing
comes from the config tree: the world is the environment's, or the number
of visible cards, as the JAX mesh is `jax.devices()`.
"""

from __future__ import annotations

import logging
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("camliflow_torch")

_device: torch.device | None = None  # the rank's device, set by join


def is_active() -> bool:
    """A process group has been joined (of any size, one rank included)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def is_main() -> bool:
    """Rank 0, or a process outside any group: the one that writes files."""
    return rank() == 0


def spread() -> bool:
    """More than one rank: the global batch is split over processes."""
    return world_size() > 1


def device() -> torch.device:
    """The device `join` gave this rank."""
    if _device is None:
        raise RuntimeError("no process group joined")
    return _device


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """A rank's device: the CPU, or card local_rank modulo the visible cards
    (ranks beyond the cards share them), made the current one: the kernel
    wrappers check that their inputs lie on the current device."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device must be cuda|cpu, got {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA card is visible; pass device=cpu to "
                           "run the plain versions on the CPU")
    card = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(card)
    return card


def choose_backend(device_type: str, world: int) -> str:
    """NCCL when every rank has a card of its own (NCCL refuses two ranks on
    one card); gloo on the CPU and when ranks share a card."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def join(rank: int, world: int, init_method: str, device_type: str = "cuda",
         local_rank: int | None = None) -> torch.device:
    """Join the group as `rank` of `world` through `init_method` (`env://`,
    `tcp://host:port`, `file://path`); returns the rank's device."""
    global _device
    _device = rank_device(device_type, rank if local_rank is None else local_rank)
    backend = choose_backend(device_type, world)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    if rank == 0:
        logger.info("process group: %d rank(s), backend %s, rank 0 on %s", world, backend,
                    _device)
    return _device


def join_from_env(device_type: str = "cuda") -> torch.device:
    """Join torchrun's group (its RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
    and MASTER_PORT)."""
    rank_ = int(os.environ["RANK"])
    return join(rank_, int(os.environ["WORLD_SIZE"]), "env://", device_type,
                int(os.environ.get("LOCAL_RANK", rank_)))


def shutdown() -> None:
    global _device
    if is_active():
        dist.destroy_process_group()
    _device = None


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, fn, world: int, init_method: str, device_type: str,
               args: tuple) -> None:
    device_ = join(local_rank, world, init_method, device_type, local_rank)
    try:
        fn(device_, *args)
    finally:
        shutdown()


def spawn(fn, nprocs: int, args: tuple = (), device_type: str = "cuda",
          init_method: str | None = None, timeout: float | None = None) -> None:
    """Run `fn(device, *args)` in `nprocs` new processes, one rank each, on
    this host (`tcp://127.0.0.1:<free port>` unless `init_method` says
    otherwise); wait for all of them. A rank that raises or dies ends the
    others and raises here; so does a wait past `timeout` seconds (a hung
    collective). `fn` must be importable by name from a new interpreter."""
    import torch.multiprocessing as mp

    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    context = mp.start_processes(_rank_main, args=(fn, nprocs, init_method, device_type, args),
                                 nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not context.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for process in context.processes:
                if process.is_alive():
                    process.kill()
            for process in context.processes:
                process.join()
            raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} still ran "
                               f"after {timeout} s")


def _rerun(device_: torch.device, entry: str, argv: list[str]) -> None:
    import importlib

    importlib.import_module(entry).main(argv)


def in_ranks(device_type: str, entry: str, argv: list[str], run, *args):
    """How an entry point (`entry`, a module whose `main(argv)` parsed
    `argv`) runs `run(device, *args)`:
    - in a process that has joined a group already (a rank that `spawn`
      started, or a caller's), on the rank's device;
    - under torchrun, after joining its group, which it leaves at the end;
    - with device=cuda and more than one visible card, one rank a card,
      started here, each running `entry.main(argv)`; returns None;
    - else in this process alone, on the device `eval.resolve_device` gives
      (raising without a card unless device=cpu)."""
    if is_active():
        return run(device(), *args)
    if launched_by_torchrun():
        device_ = join_from_env(device_type)
        try:
            return run(device_, *args)
        finally:
            shutdown()
    if device_type == "cuda" and torch.cuda.device_count() > 1:
        spawn(_rerun, torch.cuda.device_count(), (entry, argv))
        return None
    from ..eval import resolve_device

    return run(resolve_device(device_type), *args)


def _comm_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def all_reduce_sums(values: dict, keys: tuple) -> dict:
    """{key: float64 sum over the ranks of values[key]} for each of `keys`,
    a tuple every rank passes the same (the counterpart of the JAX
    Evaluator's `_reduce_sums`): a key absent on a rank counts 0 there, so
    no rank waits on a ragged collective. Outside a group, the values as
    float64."""
    local = [np.float64(values.get(key, 0.0)) for key in keys]
    if not spread():
        return dict(zip(keys, local))
    vec = torch.tensor(local, dtype=torch.float64, device=_comm_device())
    dist.all_reduce(vec)
    return dict(zip(keys, vec.cpu().numpy()))


def reduce_metrics(metrics: dict) -> dict:
    """(sum, count) metrics summed over the ranks in float64, over the
    union of the ranks' keys (a rank whose shard held no batch has none)."""
    if not spread():
        return metrics
    gathered = [None] * world_size()
    dist.all_gather_object(gathered, sorted(metrics))
    keys = tuple(sorted(set().union(*gathered)))
    flat = {f"{k}/{i}": float(metrics[k][i]) for k in metrics for i in (0, 1)}
    sums = all_reduce_sums(flat, tuple(f"{k}/{i}" for k in keys for i in (0, 1)))
    return {k: (sums[f"{k}/0"], sums[f"{k}/1"]) for k in keys}


def mean_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The mean of a tensor over the ranks (a copy; itself outside a group)."""
    if not spread():
        return value
    out = value.detach().clone()
    dist.all_reduce(out)
    return out / world_size()


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value):
        out = value.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def sum_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor over the ranks, differentiable: the backward sums
    the ranks' gradients of the sum (what
    `torch.distributed.nn.functional.all_reduce` does, which newer PyTorch
    deprecates)."""
    return _SumOverRanks.apply(value)


def wrap(model: torch.nn.Module, device_: torch.device) -> torch.nn.Module:
    """`model` (on `device_`) in `DistributedDataParallel` when a group is
    joined, else itself. Every parameter of each family's train step gets a
    gradient (tests/test_torch_train_step_*.py hold each one's against
    JAX), so `find_unused_parameters` stays off for all six families; DDP
    raises at the next step if that ever changes. Buffers are broadcast
    from rank 0 before each train forward (DDP's default); the global
    BatchNorm keeps them equal on every rank anyway."""
    if not is_active():
        return model
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        model, device_ids=[device_.index] if device_.type == "cuda" else None)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a DDP wrapper (its names carry no `module.`)."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model
