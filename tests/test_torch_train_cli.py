"""PyTorch port, the training CLI on the CPU: `python -m
camliflow_torch.train ... device=cpu` trains the flagship (cut to a small
size) for 2 epochs on tools/make_synthetic_dataset.py's output, resumes to
a third, and `camliflow_torch.eval` restores its checkpoint. A resumed run
takes, step for step, the losses an uninterrupted run takes. CamLiPWC-L
and PWC train an epoch, validate (on every level's flow, the pyramid loss)
and save their checkpoints the same way.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from camliflow_torch import eval as torch_eval
from camliflow_torch import train as torch_train

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def root_logger_restored():
    """The Trainer sets up the root logger (`logging.basicConfig`: INFO, a
    stream handler and one on its train.log); undo that after each test, so
    that later tests in the process log as they would alone."""
    root = logging.getLogger()
    level, before = root.level, root.handlers[:]
    yield
    for handler in root.handlers[:]:
        if type(handler) in (logging.StreamHandler, logging.FileHandler) and handler not in before:
            root.removeHandler(handler)
            handler.close()
    root.setLevel(level)

SMALL = ["trainset.n_points=512", "valset.n_points=512", "testset.n_points=512",
         "'model.n_samples_list=[256,128,64,32,16]'", "model.batch_size=2",
         "model.n_iters_train=2", "model.n_iters_eval=2",
         'model.backbone={"depth": 18, "pretrained": null}', "trainset.n_workers=2",
         "valset.n_workers=2", "log.val_interval=1", "log.print_interval=1"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft3d")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
                    "--out", str(root), "--n", "4", "--height", "64", "--width", "96",
                    "--n_points", "600"], check=True, capture_output=True, timeout=120)
    return [f"trainset.root_dir={root}", f"valset.root_dir={root}",
            f"testset.root_dir={root}"] + [a.strip("'") for a in SMALL]


def train(args, log_dir, *extra):
    return torch_train.main(["trainset=flyingthings3d_subset", "valset=flyingthings3d_subset",
                             "model=camliraft", "device=cpu", f"log.dir={log_dir}",
                             *args, *extra])


def test_train_cli_two_epochs_then_resume_and_eval(synthetic, tmp_path):
    log_dir = tmp_path / "run"
    first = train(synthetic, log_dir, "training.epochs=2")
    lines = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(x["tag"], x["epoch"]) for x in lines] == [("train", 0), ("val", 0), ("train", 1),
                                                       ("val", 1)]
    for x in lines:
        assert all(isinstance(v, float) for k, v in x.items() if k not in ("tag", "epoch"))
        assert {"loss", "epe2d", "epe3d", "acc3d_5cm"} <= set(x)
    assert sorted(p.name for p in (log_dir / "ckpts").glob("*.pt")) == ["0.pt", "1.pt"]
    assert len(list((log_dir / "ckpts_best").glob("*.pt"))) == 1
    assert json.loads((log_dir / "best_metrics.json").read_text())["epe2d"] > 0
    assert first.step == 4 and len(first.history) == 2  # 4 pairs, batches of 2
    assert all(h["grad_norm_2d"] > 0 and h["grad_norm_3d"] > 0 for h in first.history)

    resumed = train(synthetic, log_dir, "training.epochs=3", "ckpt.resume=true")
    assert resumed.start_epoch == 2 and resumed.step == 6
    assert [h["epoch"] for h in resumed.history] == [2, 2]
    lines = (log_dir / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines][-2:] == [2, 2]

    ckpt = log_dir / "ckpts" / "2.pt"
    got = torch_eval.main(["protocol=things", "testset=flyingthings3d_subset",
                           "model=camliraft", "device=cpu", f"ckpt.path={ckpt}",
                           'model.fast_inference="off"'] + synthetic)
    assert {"EPE2d", "EPE3d"} <= set(got)
    # the eval CLI's model holds the trainer's weights
    from camliflow_torch.models.factory import model_factory
    from camliflow_torch.runtime.checkpoint import load_weights

    restored = model_factory("camliraft")(resumed.model_cfgs)
    load_weights(restored, ckpt, "camliraft")
    for key, value in resumed.model.state_dict().items():
        assert torch.equal(restored.state_dict()[key], value), key


def test_resumed_run_takes_the_uninterrupted_losses(synthetic, tmp_path):
    """Augmentation off: the epoch-1 steps of a run resumed after epoch 0
    give the losses of the run that went on (to 1e-5 relative; the same
    batches, weights and optimizer state)."""
    args = synthetic + ["trainset.augmentation.enabled=false", "log.val_interval=5"]
    straight = train(args, tmp_path / "straight", "training.epochs=2")
    train(args, tmp_path / "split", "training.epochs=1")
    resumed = train(args, tmp_path / "split", "training.epochs=2", "ckpt.resume=true")
    want = [h["loss"] for h in straight.history if h["epoch"] == 1]
    got = [h["loss"] for h in resumed.history]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)


def test_train_cli_needs_a_card_unless_told_cpu(synthetic, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    args = ["trainset=flyingthings3d_subset", "valset=flyingthings3d_subset",
            "model=camliraft", f"log.dir={tmp_path}"] + synthetic
    with pytest.raises(RuntimeError, match="device=cpu"):
        torch_train.main(args)
    with pytest.raises(SystemExit, match="model"):
        torch_train.main(args[:2])
    # KITTI fine-tuning, as any run, wants the card unless told the CPU
    with pytest.raises(RuntimeError, match="device=cpu"):
        torch_train.main(["trainset=kitti", "valset=kitti", "model=camlipwc",
                          f"log.dir={tmp_path}", "trainset.root_dir=.", "valset.root_dir=."])


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """A synthetic set of 2400 points a cloud, read as 2048. CamLiPWC-L's
    estimators take each coarser level's flow with the points' IDS
    coordinates, so at a random init its flow grows level by level with the
    neighbours' spacing: at 512 random points a cloud it overflows f32 in
    most draws (as the JAX package's does from its own init); at 2048 and
    at the card check's 8192 it stays finite."""
    root = tmp_path_factory.mktemp("ft3d_dense")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
                    "--out", str(root), "--n", "4", "--height", "64", "--width", "96",
                    "--n_points", "2400"], check=True, capture_output=True, timeout=120)
    return [f"trainset.root_dir={root}", f"valset.root_dir={root}", "trainset.n_points=2048",
            "valset.n_points=2048", "model.n_samples_list=[1024,512,256,128,64]",
            "model.batch_size=2", "trainset.n_workers=2", "valset.n_workers=2",
            "log.val_interval=1", "log.print_interval=1"]


@pytest.mark.parametrize("model,metrics", [("camlipwc_l", {"loss3d", "epe3d", "acc3d_5cm"}),
                                           ("pwc", {"loss2d", "epe2d", "acc2d_1px"})])
def test_coarse_to_fine_families_train_an_epoch(synthetic, dense, tmp_path, model, metrics):
    """One epoch of the family's own config (conf/training/...), cut to the
    synthetic set's size, then validation on the pyramid loss and the
    checkpoints; the model the eval CLI builds holds the trainer's weights."""
    from camliflow_torch.models.factory import model_factory
    from camliflow_torch.runtime.checkpoint import load_weights

    args = dense if model == "camlipwc_l" else [
        a for a in synthetic if not a.startswith(("model.n_iters", "model.backbone"))]
    log_dir = tmp_path / model
    trainer = torch_train.main(["trainset=flyingthings3d_subset",
                                "valset=flyingthings3d_subset", f"model={model}",
                                "device=cpu", f"log.dir={log_dir}", "training.epochs=1",
                                *args])
    assert trainer.model_cfgs["compute_dtype"] == "bfloat16"  # the config's amp
    lines = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(x["tag"], x["epoch"]) for x in lines] == [("train", 0), ("val", 0)]
    for x in lines:
        assert metrics <= set(x) and all(np.isfinite(v) for k, v in x.items()
                                         if k not in ("tag", "epoch"))
    assert trainer.step == 2 and all(np.isfinite(h["loss"]) and h["grad_norm_2d"] > 0
                                     for h in trainer.history)
    assert [p.name for p in (log_dir / "ckpts").glob("*.pt")] == ["0.pt"]
    assert len(list((log_dir / "ckpts_best").glob("*.pt"))) == 1
    restored = model_factory(model)(trainer.model_cfgs)
    load_weights(restored, log_dir / "ckpts" / "0.pt", model)
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(restored.state_dict()[key], value), key


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_imagenet_backbone_loads_into_both_2d_encoders(tmp_path, suffix):
    """`model.backbone.pretrained` (torchvision names, as an ImageNet ResNet
    checkpoint has them): every tensor of both ResNet encoders but the align
    conv comes from the file; names the model lacks are ignored."""
    import numpy as np

    from camliflow_torch.models.camliraft import CamLiRAFT
    from camliflow_torch.nn.resnet import ResNetEncoder2D
    from camliflow_torch.runtime.checkpoint import load_backbone_pretrained

    gen = torch.Generator().manual_seed(3)
    source = {k: torch.randn(v.shape, generator=gen)
              for k, v in ResNetEncoder2D(depth=18).state_dict().items()
              if not k.startswith("align.")}
    source["fc.weight"] = torch.randn(1000, 512, generator=gen)  # the classifier: not ours
    path = tmp_path / f"resnet18{suffix}"
    if suffix == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in source.items()})
    else:
        torch.save({"state_dict": source}, path)
    model = CamLiRAFT({"name": "camliraft", "backbone": {"depth": 18}, "n_iters_eval": 1,
                       "fuse_fnet": True, "fuse_cnet": True, "fuse_corr": True,
                       "fuse_motion": True, "fuse_hidden": False,
                       "n_samples_list": [256, 128, 64, 32, 16]})
    align = model.core.branch_2d.fnet.align.conv_fn.weight.clone()
    assert load_backbone_pretrained(model, path) == 2 * (len(source) - 1)
    for encoder in (model.core.branch_2d.fnet, model.core.branch_2d.cnet):
        for key, value in encoder.state_dict().items():
            if not key.startswith("align."):
                assert torch.equal(value, source[key]), key
    assert torch.equal(model.core.branch_2d.fnet.align.conv_fn.weight, align)
