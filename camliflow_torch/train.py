"""Training entry point of the port (counterpart of the repo's train.py).

    python -m camliflow_torch.train trainset=flyingthings3d_subset \\
        valset=flyingthings3d_subset model=camliraft [device=cpu] [key=value ...]
    python -m camliflow_torch.train trainset=kitti valset=kitti \\
        model=camliraft|camlipwc [device=cpu] [key=value ...]

Composes the same `conf/` tree as train.py (trainer.yaml, the three groups,
then conf/training/<trainset>/<model>.yaml with its `override:` block, then
the dotted overrides) and runs the port's Trainer: `log.dir` receives
train.log, metrics.jsonl, tb/ (TensorBoard events; `log.tensorboard=false`
turns them off), images/ (with `log.save_image_summary=true`),
best_metrics.json and the checkpoints (`ckpt.resume=true` continues from
the newest). It trains on the CUDA card unless `device=cpu` is given;
without a card and without `device=cpu` it raises. Every model family
trains on FlyingThings3D (`model=camliraft`, `camliraft_l`, `raft`, `pwc`,
`camlipwc_l` or `camlipwc`, each with its
conf/training/flyingthings3d_subset/<model>.yaml); CamLiRAFT and CamLiPWC
also fine-tune on KITTI's training160 split, validated on training40
(conf/training/kitti/<model>.yaml: `freeze_bn`, no warm-up, colour jitter,
horizontal flip and random scale). A checkpoint it writes is read back by
`python -m camliflow_torch.eval ... ckpt.path=<log.dir>/ckpts/<epoch>.pt`.
"""

from __future__ import annotations

import sys
from pathlib import Path

CONF_DIR = Path(__file__).resolve().parents[1] / "conf"


def parse_cli(argv: list[str]) -> tuple[dict, list[str]]:
    groups = {"trainset": None, "valset": None, "model": None, "device": "cuda"}
    overrides = []
    for arg in argv:
        key, _, value = arg.partition("=")
        if key in groups:
            groups[key] = value
        else:
            overrides.append(arg)
    return groups, overrides


def main(argv: list[str] | None = None):
    groups, overrides = parse_cli(sys.argv[1:] if argv is None else argv)
    for key in ("trainset", "valset", "model"):
        if groups[key] is None:
            raise SystemExit(f"missing required group: {key}=<name>")
    from .eval import resolve_device
    from .runtime.trainer import Trainer
    from .utils.config import compose

    device = resolve_device(groups["device"])
    cfgs = compose(CONF_DIR, trainset=groups["trainset"], valset=groups["valset"],
                   model=groups["model"], base="trainer.yaml", overrides=overrides)
    accum = int(cfgs.training.get("accum_iter", 1))
    if accum > 1:  # the batch divided by accum_iter, as train.py does
        cfgs.model.batch_size = cfgs.model.batch_size // accum
    trainer = Trainer(cfgs, device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
