"""PyTorch port, the training CLI on the CPU: `python -m
camliflow_torch.train ... device=cpu` trains the flagship (cut to a small
size) for 2 epochs on tools/make_synthetic_dataset.py's output, resumes to
a third, and `camliflow_torch.eval` restores its checkpoint. A resumed run
takes, step for step, the losses an uninterrupted run takes.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from camliflow_torch import eval as torch_eval
from camliflow_torch import train as torch_train

REPO = Path(__file__).resolve().parents[1]

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
    with pytest.raises(NotImplementedError, match="camliraft_l"):
        torch_train.main([a.replace("model=camliraft", "model=camliraft_l") for a in args]
                         + ["device=cpu"])


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
