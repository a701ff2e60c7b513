"""PyTorch port, KITTI fine-tuning on the CPU: the KITTI reader's training
half (data/datasets.py::KITTI with augmentation) against the JAX reader,
the loader's epochs, the two KITTI training configs' optimizer schedule
against the JAX package's, and `python -m camliflow_torch.train
trainset=kitti valset=kitti model=camliraft device=cpu` end to end.

The JAX reader draws its augmentation and points from numpy's global
random state, the port's from `RandomState([seed, epoch, index])`: the
global state is set to that RandomState's, so both draw the same stream and
the port's sample must equal the JAX one bit for bit. The files are
tests/test_torch_data.py's KITTI writer's (the JAX package's writers).
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camliflow_tpu.data import datasets as jd
from camliflow_tpu.models import factory as jfactory
from camliflow_tpu.utils.config import Config
from camliflow_tpu.utils.config import compose as jax_compose
from camliflow_torch import train as torch_train
from camliflow_torch.data import datasets as td
from camliflow_torch.data import loader as tl
from camliflow_torch.models import factory
from camliflow_torch.models.factory import training_functions
from camliflow_torch.nn.layers import BatchNorm
from camliflow_torch.runtime.checkpoint import random_weights
from camliflow_torch.utils.config import compose, load_yaml
from test_tensorboard import parse_fields, read_records
from test_torch_data import write_kitti_training
from test_torch_train_guards import FAMILIES, batch, count_wrappers

CONF = torch_train.CONF_DIR
# conf/trainset/kitti.yaml's augmentation; `crop` (off there) for the ops alone
KITTI_AUGMENTATION = load_yaml(CONF / "trainset" / "kitti.yaml").trainset.augmentation.to_dict()
OPS = {"color_jitter": "color_jitter", "flip_lr": "random_horizontal_flip",
       "flip_ud": "random_vertical_flip", "crop": "random_crop", "scale": "random_scale"}


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


def augmentation(case):
    aug = {k: (dict(v) if isinstance(v, dict) else v) for k, v in KITTI_AUGMENTATION.items()}
    aug["random_crop"] = {"enabled": False, "crop_size": [1100, 340], "drop_pc": True}
    if case != "kitti.yaml":
        for op in OPS.values():
            aug[op]["enabled"] = op == OPS[case]
    return aug


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    write_kitti_training(root, indices=range(6))
    return root


def reader_cfgs(root, split="training160", aug=None, n_points=512):
    return Config({"name": "kitti", "root_dir": str(root), "split": split,
                   "n_points": n_points, "max_depth": 90,
                   "augmentation": aug or {"enabled": False}})


def same_sample(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        if isinstance(ref[key], np.ndarray):
            assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            assert got[key] == ref[key], key


@pytest.mark.parametrize("seed,epoch", [(0, 0), (3, 2)])
@pytest.mark.parametrize("case", ["kitti.yaml", *OPS])
def test_kitti_training_sample_matches_jax(kitti, case, seed, epoch):
    """The augmented sample (after the zero padding to 376x1242: colour
    jitter, the flips, crop and scale as configured, then pc1's and pc2's
    points) with the JAX reader's global state set to the port's
    RandomState([seed, epoch, index]): every array bit for bit."""
    cfgs = reader_cfgs(kitti, aug=augmentation(case))
    jax_set, port_set = jd.KITTI(cfgs), td.KITTI(cfgs, seed)
    port_set.set_epoch(epoch)
    size = (340, 1100) if case == "crop" else (376, 1242)
    for i in (0, 1):
        np.random.set_state(np.random.RandomState([seed, epoch, i]).get_state())
        ref = jax_set[i]
        got = port_set[i]
        assert got["images"].shape == (*size, 6) and got["flow_3d"].shape == (512, 4)
        same_sample(got, ref)


def test_kitti_training_draws_by_seed_epoch_and_index(kitti):
    """A sample draws from RandomState((seed, epoch, index)): the same
    sample whichever thread reads it, another one next epoch or seed."""
    port_set = td.KITTI(reader_cfgs(kitti, aug=augmentation("kitti.yaml")), seed=3)
    first = port_set[1]
    same_sample(port_set[1], first)
    same_sample(port_set.sample(1, np.random.RandomState([3, 0, 1])), first)
    port_set.set_epoch(1)
    assert not np.array_equal(port_set[1]["pcs"], first["pcs"])
    other = td.KITTI(reader_cfgs(kitti, aug=augmentation("kitti.yaml")), seed=4)
    assert not np.array_equal(other[1]["pcs"], first["pcs"])


@pytest.mark.parametrize("split", ["training40", "training160"])
def test_kitti_eval_samples_are_unchanged(kitti, split):
    """Without augmentation the reader samples with the fixed RandomState
    (23333): the JAX sample bit for bit, whatever the seed and epoch."""
    cfgs = reader_cfgs(kitti, split)
    jax_set, port_set = jd.KITTI(cfgs), td.dataset_factory(cfgs, seed=7)
    port_set.set_epoch(5)
    for i in (0, 1):
        same_sample(port_set[i], jax_set[i])


def test_loader_reads_kitti_the_same_on_any_thread(kitti):
    """`set_epoch` reaches the KITTI reader through the loader; a batch is
    the same read on 3 worker threads or in the calling thread."""
    port_set = td.KITTI(reader_cfgs(kitti, aug=augmentation("kitti.yaml")), seed=1)
    port_set.indices = port_set.indices[:4]
    batches = {}
    for workers in (0, 3):
        loader = tl.DataLoader(port_set, 2, shuffle=True, num_workers=workers, seed=1)
        loader.set_epoch(2)
        assert port_set.epoch == 2
        batches[workers] = list(loader)
    assert len(batches[0]) == 2
    for a, b in zip(batches[0], batches[3]):
        same_sample(a, b)


@pytest.mark.parametrize("model", ["camliraft", "camlipwc"])
def test_kitti_configs_match_jax_and_schedule_without_warmup(model):
    """conf/training/kitti/<model>.yaml as both packages compose it
    (`freeze_bn` on, no warm-up), and each optimizer group's rate from the
    first step on against the JAX package's schedule for the same base rate:
    no warm-up, so step 0 already runs at lr_2d / lr_3d."""
    cfgs = compose(CONF, trainset="kitti", valset="kitti", model=model, base="trainer.yaml")
    ref = jax_compose(CONF, trainset="kitti", valset="kitti", model=model, base="trainer.yaml")
    assert cfgs.to_dict() == ref.to_dict()
    training = cfgs.training
    assert cfgs.model.freeze_bn and training.warmup_epochs == 0
    assert (training.lr_2d, training.lr_3d, training.grad_max_norm) == {
        "camliraft": (1e-4, 1e-3, 1), "camlipwc": (1e-4, 2e-4, 20)}[model]
    steps_per_epoch = 160 // cfgs.model.batch_size
    net = factory.model_factory(cfgs.model.to_dict())(cfgs.model.to_dict())
    optimizer = factory.optimizer_factory(training, net, steps_per_epoch, model)
    assert optimizer.max_norm == training.grad_max_norm
    assert {g["label"] for g in optimizer.param_groups} == {
        "2d_decay", "2d_no_decay", "3d_decay", "3d_no_decay"}
    for group, schedule in zip(optimizer.param_groups, optimizer.schedules):
        base = training[f"lr_{group['label'][:2]}"]
        assert group["weight_decay"] == (0.0 if "no_decay" in group["label"]
                                         else training.weight_decay)
        want = jfactory.timm_cosine_schedule(
            base_lr=base, epochs=training.epochs, steps_per_epoch=steps_per_epoch,
            warmup_epochs=training.warmup_epochs, warmup_lr=training.warmup_lr,
            min_lr=training.min_lr)
        assert schedule(0) == base
        for step in (0, 1, steps_per_epoch - 1, steps_per_epoch, 10 * steps_per_epoch + 3,
                     (training.epochs // 2) * steps_per_epoch, training.epochs * steps_per_epoch):
            # the JAX schedule computes in f32, the port's in float64
            np.testing.assert_allclose(schedule(step), float(want(jnp.asarray(step))),
                                       rtol=1e-6, atol=1e-10)


# a KITTI fine-tune step's selections, as on FlyingThings3D (the counts do
# not depend on the image size or freeze_bn): CamLiRAFT FPS once, KNN 8 (2
# encoder levels, the fusion cache, the k=32 neighbours, the upsample's k=3,
# 3 pooling levels), #3 on the detached flow and #4 index-only once an
# iteration (2 here, 10 in conf/model/camliraft.yaml); CamLiPWC FPS once, KNN
# 43 (10 in the pyramids, 2 a decoder level, 10 fusion caches, 13 k=3
# selections of the interpolation's train form)
KITTI_STEP = {
    "camliraft": ({"name": "camliraft", "backbone": {"depth": 18}, "n_iters_eval": 2,
                   "n_iters_train": 2, "fast_inference": "auto", "fuse_fnet": True,
                   "fuse_cnet": True, "fuse_corr": True, "fuse_motion": True,
                   "fuse_hidden": False, "n_samples_list": [256, 128, 64, 32, 16],
                   "loss2d": {"gamma": 0.8, "order": "l2-norm"},
                   "loss3d": {"gamma": 0.8, "order": "l2-norm"}}, (64, 90),
                  {"fps": 1, "knn": 8, "interp": 2, "corr3d_index": 2, "corr3d_cost": 0}),
    "camlipwc": ({"name": "camlipwc", **FAMILIES["camlipwc"]}, (128, 160),
                 {"fps": 1, "knn": 43, "interp": 0, "corr3d_index": 0, "corr3d_cost": 0}),
}


@pytest.mark.parametrize("model", sorted(KITTI_STEP))
def test_kitti_train_step_runs_the_selections_at_their_counts(model, monkeypatch):
    """One KITTI-config train step (`freeze_bn`, a width the model pads or
    resizes, KITTI's 3D validity channel) calls the selection wrappers as a
    FlyingThings3D step does and no forward-only kernel on an input that
    requires grad; the BatchNorms' statistics stay where they were."""
    calls, checked = count_wrappers(monkeypatch)
    cfgs, (h, w), want = KITTI_STEP[model]
    cfgs = {**cfgs, "freeze_bn": True}
    port = factory.model_factory(cfgs)(cfgs)
    random_weights(port, 0)
    port.train()
    before = {k: v.clone() for k, v in port.named_buffers()}
    inputs = batch(1, b=2, h=h, w=w)
    inputs["flow_3d"] = torch.cat([inputs["flow_3d"], torch.ones_like(inputs["flow_3d"][..., :1])],
                                  -1)
    loss_fn, _ = training_functions(model)
    outputs = port(inputs)
    assert outputs["flow_2d"].shape == (2, h, w, 2)
    loss, _ = loss_fn(outputs, inputs, cfgs)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert checked == [("knn_interpolation", False)] * want["interp"]
    assert calls == want
    for key, value in port.named_buffers():
        assert torch.equal(value, before[key]), key


def test_kitti_cli_fine_tunes_with_frozen_batchnorm(kitti, tmp_path, monkeypatch):
    """`python -m camliflow_torch.train trainset=kitti valset=kitti
    model=camliraft device=cpu` at a small width (ResNet-18, 512 points,
    2 iterations), KITTI's splits cut to 2 training and 1 validation frames
    by a patch of the reader: an augmented epoch, validation, checkpoints
    and tb/ events; every BatchNorm's running statistics as initialised."""
    original = td.KITTI.__init__

    def cut(self, cfgs, seed=0):
        original(self, cfgs, seed)
        self.indices = self.indices[:2 if cfgs.split == "training160" else 1]

    monkeypatch.setattr(td.KITTI, "__init__", cut)
    log_dir = tmp_path / "run"
    small = ["trainset.n_points=512", "valset.n_points=512",
             "model.n_samples_list=[256,128,64,32,16]", "model.batch_size=2",
             "model.n_iters_train=2", "model.n_iters_eval=2",
             'model.backbone={"depth": 18, "pretrained": null}', "trainset.n_workers=2",
             "valset.n_workers=2"]
    trainer = torch_train.main([
        "trainset=kitti", "valset=kitti", "model=camliraft", "device=cpu", f"log.dir={log_dir}",
        f"trainset.root_dir={kitti}", f"valset.root_dir={kitti}", "training.epochs=1",
        "log.val_interval=1", "log.print_interval=1", *small])
    assert isinstance(trainer.train_set, td.KITTI) and trainer.train_set.cfgs.augmentation.enabled
    assert trainer.model.freeze_bn and trainer.model_cfgs["compute_dtype"] == "bfloat16"
    assert trainer.step == 1 and len(trainer.history) == 1
    record = trainer.history[0]
    assert np.isfinite(record["loss"]) and record["grad_norm_2d"] > 0 and record["grad_norm_3d"] > 0
    lines = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(x["tag"], x["epoch"]) for x in lines] == [("train", 0), ("val", 0)]
    assert all(np.isfinite(v) for x in lines for k, v in x.items() if k not in ("tag", "epoch"))
    assert {"epe2d", "epe3d", "loss"} <= set(lines[1])
    assert [p.name for p in (log_dir / "ckpts").glob("*.pt")] == ["0.pt"]
    assert len(list((log_dir / "ckpts_best").glob("*.pt"))) == 1
    (events,) = (log_dir / "tb").glob("events.out.tfevents.*")
    tags = [parse_fields(parse_fields(parse_fields(r)[5][0])[1][0])[1][0].decode()
            for r in read_records(events)[1:]]
    assert tags == [f"{x['tag']}/{k}" for x in lines for k in x if k not in ("tag", "epoch")]

    torch.manual_seed(0)
    fresh = factory.model_factory("camliraft")(trainer.model_cfgs)
    fresh_buffers = dict(fresh.named_buffers())
    norms = [name for name, m in trainer.model.named_modules() if isinstance(m, BatchNorm)]
    assert norms
    for name, value in trainer.model.named_buffers():
        if name.rsplit(".", 1)[0] in norms:
            assert torch.equal(value, fresh_buffers[name]), name
