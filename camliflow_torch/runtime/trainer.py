"""Training runtime: the port's counterpart of camliflow_tpu/runtime/
trainer.py, for one process on one device (DDP and SyncBatchNorm are not
ported; see ROADMAP.md).

`Trainer(cfgs, device)` builds the datasets and loaders, the model (random
weights from `cfgs.seed`, the ImageNet backbone where
`model.backbone.pretrained` names a file that exists, else a warning, as
the JAX trainer does), the 4-group optimizer and the schedule; `run`
trains `training.epochs` epochs, validates every `log.val_interval`
epochs (and after the last), keeps the best checkpoint by the model's
`is_better`, and saves a checkpoint after every epoch. `training.amp` runs
the train forward under bf16 autocast; validation stays f32.

The log directory holds train.log, metrics.jsonl (one line per train and
val epoch summary), tb/ (a TensorBoard event file: each summary's scalars
as "<train|val>/<name>" at step = epoch; unless `log.tensorboard` is
false, on when missing, as in the JAX trainer), images/flow2d_epochNNN.png
(with `log.save_image_summary`: the flow image of the first validation
batch's first sample, also a "val/flow2d" event; models without a 2D flow
write none), best_metrics.json, ckpts/<epoch>.pt (the newest
`ckpt.max_to_keep`) and ckpts_best/<epoch>.pt (the best one).
`ckpt.resume=true` continues from the newest of ckpts/.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import dataset_factory
from ..data.loader import DataLoader
from ..data.png import write_png
from ..models.factory import model_factory, optimizer_factory, training_functions
from ..models.metrics import finalize_metrics, merge_metrics
from ..utils.profiling import BadLossChecker
from ..utils.tensorboard import EventWriter
from ..utils.torch_setup import setup_torch
from ..utils.visualization import viz_optical_flow
from .checkpoint import load_backbone_pretrained, load_train_checkpoint, save_train_checkpoint
from .evaluator import _HOST_KEYS, Evaluator
from .train_state import train_step

logger = logging.getLogger("camliflow_torch")


def init_logging(log_path: Path | None = None) -> None:
    handlers = [logging.StreamHandler()]
    if log_path is not None:
        handlers.append(logging.FileHandler(log_path))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s",
                        handlers=handlers, force=True)


def device_batch(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on `device` (from pinned memory, without
    making the host wait, on a CUDA device)."""
    out = {}
    for key, value in batch.items():
        if not isinstance(value, np.ndarray) or key in _HOST_KEYS:
            continue
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        out[key] = tensor
    return out


class Trainer:
    """Epoch-based trainer with validation and best-checkpoint selection."""

    def __init__(self, cfgs, device: torch.device | str):
        setup_torch()
        self.cfgs = cfgs
        self.device = torch.device(device)
        self.log_dir = Path(cfgs.log.dir)
        self.ckpt_dir = self.log_dir / "ckpts"
        self.best_dir = self.log_dir / "ckpts_best"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        init_logging(self.log_dir / "train.log")
        seed = int(cfgs.get("seed", 0))
        batch_size = int(cfgs.model.batch_size)

        self.train_set = dataset_factory(cfgs.trainset, seed)
        self.val_set = dataset_factory(cfgs.valset, seed)
        self.train_loader = DataLoader(self.train_set, batch_size, shuffle=True,
                                       num_workers=int(cfgs.trainset.get("n_workers", 4)),
                                       drop_last=True, seed=seed)
        self.val_loader = DataLoader(self.val_set, batch_size, shuffle=False,
                                     num_workers=int(cfgs.valset.get("n_workers", 4)),
                                     drop_last=False, seed=seed)
        if len(self.train_loader) == 0:
            raise ValueError(f"the training set's {len(self.train_set)} samples make no "
                             f"batch of {batch_size}")

        self.model_name = str(cfgs.model.name)
        model_cfgs = cfgs.model.to_dict()
        if bool(cfgs.training.get("amp", True)) and "compute_dtype" not in model_cfgs:
            model_cfgs["compute_dtype"] = "bfloat16"
        self.model_cfgs = model_cfgs
        self.loss_fn, self.is_better = training_functions(self.model_name)
        torch.manual_seed(seed)
        self.model = model_factory(model_cfgs)(model_cfgs)
        pretrained = cfgs.model.get("backbone", {}).get("pretrained")
        if pretrained and Path(pretrained).exists():
            n = load_backbone_pretrained(self.model, pretrained)
            logger.info("loaded %d pretrained backbone tensors from %s", n, pretrained)
        elif pretrained:
            logger.warning("backbone.pretrained=%s not found, training from scratch", pretrained)
        # a coarse-to-fine model's validation reads every level's flow, as
        # the pyramid loss does
        if hasattr(self.model, "with_pyramid"):
            self.model.with_pyramid = True
        self.model.to(self.device).train()
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("#parameters: %.2fM on %s", n_params / 1e6, self.device)

        self.optimizer = optimizer_factory(cfgs.training, self.model, len(self.train_loader),
                                           self.model_name)
        self.step = 0
        self.start_epoch = 0
        self.best_metrics = None
        # the last epoch's per-step telemetry: dicts of epoch, step, loss,
        # grad_norm_2d, grad_norm_3d
        self.history: list[dict] = []
        self.tb = EventWriter(self.log_dir / "tb") if cfgs.log.get("tensorboard", True) else None
        if cfgs.ckpt.get("resume", False) and self.latest_ckpt() is not None:
            self.load_ckpt(self.latest_ckpt())

    def run(self) -> None:
        epochs = int(self.cfgs.training.epochs)
        val_interval = int(self.cfgs.log.get("val_interval", 1))
        try:
            for epoch in range(self.start_epoch, epochs):
                self.train_one_epoch(epoch)
                if (epoch + 1) % val_interval == 0 or epoch == epochs - 1:
                    metrics = self.validate(epoch)
                    if self.is_better(metrics, self.best_metrics):
                        self.best_metrics = metrics
                        self.save_ckpt(epoch, best=True)
                self.save_ckpt(epoch)
        finally:
            if self.tb is not None:
                self.tb.close()
        logger.info("training finished")

    def train_one_epoch(self, epoch: int) -> dict:
        """One pass over the training set; returns the epoch's summary.
        Step i's loss, metrics and gradient norms are read on the host
        only after step i + 1 has been enqueued, so the card runs the next
        step while the host sums and logs (the abort on a diverging loss
        fires a step late, which does not change what it detects)."""
        logger.info("epoch %d begins", epoch + 1)
        self.history = []
        self.train_loader.set_epoch(epoch)
        self.model.train()
        epoch_metrics: dict = {}
        bad_loss = BadLossChecker()
        print_interval = int(self.cfgs.log.get("print_interval", 50))
        start = time.time()

        def consume(index, loss, metrics, telemetry):
            nonlocal epoch_metrics
            epoch_metrics = merge_metrics(
                epoch_metrics, {k: (s.cpu(), c.cpu()) for k, (s, c) in metrics.items()})
            record = {"epoch": epoch, "step": index, "loss": float(loss),
                      **{k: float(v) for k, v in telemetry.items()}}
            self.history.append(record)
            if bad_loss.check(record["loss"]):
                raise RuntimeError(f"loss diverged for {bad_loss.patience} consecutive steps "
                                   f"(last: {record['loss']}); aborting")
            if index % print_interval == 0:
                logger.info("E %d S %d loss %.4f g2d %.3f g3d %.3f %.2fs/it mem %.2fGB",
                            epoch + 1, index, record["loss"], record["grad_norm_2d"],
                            record["grad_norm_3d"], (time.time() - start) / (index + 1),
                            self._peak_memory_gb())

        pending = None
        for index, batch in enumerate(self.train_loader):
            outputs = train_step(self.model, self.optimizer, device_batch(batch, self.device),
                                 self.loss_fn, self.cfgs.model, self.step, self.model_name)
            self.step += 1
            if pending is not None:
                consume(*pending)
            pending = (index, *outputs)
        if pending is not None:
            consume(*pending)
        summary = finalize_metrics(epoch_metrics)
        logger.info("train epoch %d: %s", epoch + 1, _fmt(summary))
        self._dump_scalars("train", epoch, summary)
        return summary

    def validate(self, epoch: int) -> dict:
        """The model's loss and metrics over the validation set, through the
        port's Evaluator (f32, the eval forward, one batch ahead); the model
        returns to train mode after. With `log.save_image_summary`, the
        first batch's flow image follows."""
        logger.info("validating epoch %d", epoch + 1)
        evaluator = Evaluator(self.model, self.device)
        agg: dict = {}
        first_batch = None
        for batch, outputs in evaluator.batches(self.val_loader):
            if first_batch is None:
                first_batch = batch
            inputs = device_batch(batch, torch.device("cpu"))
            outputs = {k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                       else torch.from_numpy(v) for k, v in outputs.items()}
            _, metrics = self.loss_fn(outputs, inputs, self.cfgs.model)
            agg = merge_metrics(agg, metrics)
        summary = finalize_metrics(agg)
        logger.info("val epoch %d: %s", epoch + 1, _fmt(summary))
        self._dump_scalars("val", epoch, summary)
        if self.cfgs.log.get("save_image_summary", False):
            self._save_image_summary(epoch, first_batch)
        self.model.train()
        return summary

    def _save_image_summary(self, epoch: int, batch: dict | None) -> None:
        """The flow image (utils/visualization.py) of sample 0's `flow_2d`
        from one eval forward of `batch`: images/flow2d_epoch<epoch>.png and
        a "val/flow2d" event. A model without a 2D flow writes nothing. A
        failed file write is logged and training goes on; a failed forward
        raises."""
        if batch is None or "images" not in batch:
            return
        outputs = Evaluator(self.model, self.device).forward(batch)
        if "flow_2d" not in outputs:
            return
        viz = viz_optical_flow(outputs["flow_2d"][0])
        try:
            out_dir = self.log_dir / "images"
            out_dir.mkdir(exist_ok=True)
            write_png(out_dir / f"flow2d_epoch{epoch:03d}.png", viz)
            if self.tb is not None:
                self.tb.add_image("val/flow2d", viz, epoch)
                self.tb.flush()
        except Exception as exc:  # a summary must not end a training run
            logger.warning("image summary failed: %s", exc)

    def _dump_scalars(self, tag: str, epoch: int, summary: dict) -> None:
        with open(self.log_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps({"tag": tag, "epoch": epoch, **summary}) + "\n")
        if self.tb is not None:
            for name, value in summary.items():
                self.tb.add_scalar(f"{tag}/{name}", float(value), epoch)
            self.tb.flush()

    def save_ckpt(self, epoch: int, best: bool = False) -> Path:
        """ckpts/<epoch>.pt (the newest `ckpt.max_to_keep` are kept), or
        ckpts_best/<epoch>.pt (one kept); best_metrics.json beside them."""
        folder, keep = ((self.best_dir, 1) if best
                        else (self.ckpt_dir, int(self.cfgs.ckpt.get("max_to_keep", 3))))
        path = folder / f"{epoch}.pt"
        save_train_checkpoint(path, self.model, self.optimizer, epoch, self.step)
        for old in sorted(folder.glob("*.pt"), key=lambda p: int(p.stem))[:-keep]:
            old.unlink()
        if self.best_metrics is not None:
            with open(self.log_dir / "best_metrics.json", "w") as f:
                json.dump(dict(self.best_metrics), f)
        return path

    def latest_ckpt(self) -> Path | None:
        found = sorted(self.ckpt_dir.glob("*.pt"), key=lambda p: int(p.stem))
        return found[-1] if found else None

    def load_ckpt(self, path: Path) -> None:
        """Resume from a checkpoint: weights, optimizer state, update count,
        and the epoch after the saved one; best_metrics.json if present."""
        payload = load_train_checkpoint(path)
        self.model.load_state_dict(payload["model"], strict=True)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        self.start_epoch = int(payload["last_epoch"]) + 1
        best_path = self.log_dir / "best_metrics.json"
        self.best_metrics = json.loads(best_path.read_text()) if best_path.exists() else None
        logger.info("resumed from %s: epoch %d, step %d", path, self.start_epoch, self.step)

    def _peak_memory_gb(self) -> float:
        if self.device.type != "cuda":
            return 0.0
        return torch.cuda.max_memory_allocated(self.device) / 2**30


def _fmt(summary: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in sorted(summary.items()))
