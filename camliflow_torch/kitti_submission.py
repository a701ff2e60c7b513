"""KITTI scene-flow submission entry point of the port (counterpart of the
repo's kitti_submission.py).

    python -m camliflow_torch.kitti_submission model=camliraft \\
        ckpt.path=<JAX variables .npz> [testset=kitti] [device=cpu] [key=value ...]

Composes the same `conf/` tree (evaluator.yaml, the testset's KITTI test
split: root_dir, disp_provider, max_depth, n_points, zero_padding), loads
the JAX package's variables through the weight bridge, and writes
submission/testing/{disp_0,flow_initial,disp_1_initial,occ} under the
working directory (`runtime/submission.py`), in batches of
`model.batch_size`. It runs on the CUDA card unless `device=cpu` is given,
and raises without a card otherwise.
"""

from __future__ import annotations

import logging
import sys

from .eval import CONF_DIR, resolve_device


def configure(argv: list[str]):
    """(cfgs, device) from the command line's groups and overrides."""
    groups = {"testset": "kitti", "model": None, "device": "cuda"}
    overrides = []
    for arg in argv:
        key, _, value = arg.partition("=")
        if key in groups:
            groups[key] = value
        else:
            overrides.append(arg)
    if groups["model"] is None:
        raise SystemExit("missing required group: model=<name>")
    device = resolve_device(groups["device"])

    from .utils.config import compose

    cfgs = compose(CONF_DIR, testset=groups["testset"], model=groups["model"],
                   base="evaluator.yaml", overrides=overrides)
    return cfgs, device


def main(argv: list[str] | None = None):
    """Run the submission; returns the SubmissionWriter (its `frame_ms`)."""
    cfgs, device = configure(sys.argv[1:] if argv is None else argv)

    from .models.factory import model_factory
    from .runtime.checkpoint import load_jax_variables, load_npz
    from .runtime.submission import SubmissionWriter

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logging.getLogger("camliflow_torch").info("device: %s", device)
    if cfgs.ckpt.path is None:
        raise SystemExit("missing ckpt.path=<JAX variables .npz>")
    model = model_factory(cfgs.model)(cfgs.model.to_dict())
    load_jax_variables(model, load_npz(cfgs.ckpt.path), cfgs.model.name)
    writer = SubmissionWriter(cfgs, model, device)
    writer.run()
    return writer


if __name__ == "__main__":
    main()
