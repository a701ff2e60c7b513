"""Evaluation entry point of the port (counterpart of the repo's eval.py).

    python -m camliflow_torch.eval protocol=things testset=flyingthings3d_subset \\
        model=camliraft ckpt.path=<JAX variables .npz | trainer checkpoint .pt> \\
        [device=cpu] [key=value ...]

Composes the same `conf/` tree as eval.py, loads the JAX package's variables
through the weight bridge (a `.npz`) or a checkpoint of the port's trainer
(`python -m camliflow_torch.train`), and runs one protocol in batches of 8:
    things        eval_things.py        (2D and 3D metrics)
    sintel        eval_sintel.py        (per-scene 2D AEPE; testset=sintel)
    things_noc_sf eval_things_noc_sf.py (HPLFlowNet's protocol;
                                         testset=flyingthings3d_subset_hpl)
    things_occ_sf eval_things_occ_sf.py (FlowNet3D's protocol;
                                         testset=flyingthings3d_subset_flownet3d)
    kitti_occ_sf  eval_kitti_occ_sf.py  (FlowNet3D's KITTI protocol)
    kitti_noc_sf  eval_kitti_noc_sf.py  (PointPWC's KITTI protocol)
With `save_results=true`, `things` also writes each sample's predictions
under prediction/things (flow_2d/%07d.png, flow_3d/%07d.npy), as eval.py
does. The two KITTI protocols read their sets from the reference's relative roots
under datasets/kitti_scene_flow/training, as eval.py does, with the
testset's n_points (8192 without a testset). It runs on the CUDA card
unless `device=cpu` is given (there the kernels' plain versions run);
without a card and without `device=cpu` it raises. Ported models: all six
families, `model=camliraft`, `camliraft_l`, `raft`, `camlipwc`, `camlipwc_l`
and `pwc`.

With more than one visible card (and no torchrun environment) it starts
one rank a card on this host; under torchrun each process joins torchrun's
group (`device=cpu`: on the CPU over gloo). Each rank evaluates its
contiguous slice of every batch of 8 and the protocols' sums are added
over the ranks (`camliflow_torch/parallel/dist.py`), so the totals are one
process's; rank 0 logs them, and `save_results` writes each rank's own
samples. With one card, or `device=cpu` outside torchrun, one process runs.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import torch

CONF_DIR = Path(__file__).resolve().parents[1] / "conf"
BATCH_SIZE = 8  # eval.py's Evaluator default


# the scene-flow protocols' (per_sample_average, use_noc_mask); None: its own run
PROTOCOLS = {
    "things": None,
    "sintel": None,
    "things_noc_sf": (False, False),
    "things_occ_sf": (True, True),
    "kitti_occ_sf": (True, False),
    "kitti_noc_sf": (True, False),
}


def protocol_dataset(protocol: str, cfgs):
    """The test set a protocol reads: its own reader for the scene-flow
    protocols, else the testset's."""
    from .data import protocol_datasets as pd
    from .data.datasets import dataset_factory

    testset = cfgs.get("testset") or {}
    if protocol == "things_noc_sf":
        return pd.FlyingThings3DSubsetHPL(cfgs.testset)
    if protocol == "things_occ_sf":
        return pd.FlyingThings3DSubsetFlowNet3D(cfgs.testset)
    if protocol == "kitti_occ_sf":
        return pd.KITTIFlowNet3D(n_points=int(testset.get("n_points", 8192)))
    if protocol == "kitti_noc_sf":
        return pd.KITTIPointPWC(n_points=int(testset.get("n_points", 8192)))
    return dataset_factory(cfgs.testset)


def resolve_device(name: str) -> torch.device:
    """`cuda` (the default) or `cpu`; never falls back from one to the other."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"device must be cuda|cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA card is visible; pass "
                           "device=cpu (--device cpu) to run the plain versions on "
                           "the CPU")
    return torch.device("cuda")


def main(argv: list[str] | None = None) -> dict | None:
    """The protocol's results (None where it started one rank a card)."""
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
    protocol = groups["protocol"]
    if protocol not in PROTOCOLS:
        raise SystemExit(f"unknown protocol: {protocol}")
    from .parallel.dist import in_ranks

    return in_ranks(groups["device"], __spec__.name, argv, evaluate, groups, overrides)


def evaluate(device: torch.device, groups: dict, overrides: list[str]) -> dict:
    from .data.datasets import batches
    from .models.factory import model_factory
    from .parallel import dist
    from .runtime.checkpoint import load_weights
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
        raise SystemExit("missing ckpt.path=<JAX variables .npz or trainer checkpoint .pt>")
    load_weights(model, cfgs.ckpt.path, cfgs.model.name)
    evaluator = Evaluator(model, device)
    protocol = groups["protocol"]
    loader = batches(protocol_dataset(protocol, cfgs), BATCH_SIZE, dist.rank(), dist.world_size())
    if protocol == "things":
        return evaluator.run_things(loader, save_results=bool(cfgs.get("save_results", False)))
    if protocol == "sintel":
        return evaluator.run_sintel(loader)
    per_sample_average, use_noc_mask = PROTOCOLS[protocol]
    return evaluator.run_sf_protocol(loader, per_sample_average, use_noc_mask)


if __name__ == "__main__":
    main()
