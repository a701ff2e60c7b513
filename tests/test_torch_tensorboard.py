"""PyTorch port, TensorBoard events on the CPU: utils/tensorboard.py against
the JAX package's writer, and the trainer's records against the JAX
trainer's.

With the clock, the host name and the process id patched (both modules
read them from `time`, `socket` and `os`), a scalar event file is the JAX
writer's byte for byte; image events carry PNGs from different encoders
(the JAX writer prefers OpenCV's, the port uses data/png.py), so they are
held pixel for pixel. The files are parsed back with
tests/test_tensorboard.py's decoders (TFRecord framing with its masked
CRCs, the Event/Summary wire format).
"""

import json
import logging
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from camliflow_tpu.runtime.trainer import Trainer as JaxTrainer
from camliflow_tpu.utils import tensorboard as jtb
from camliflow_torch import train as torch_train
from camliflow_torch.data import png
from camliflow_torch.runtime.evaluator import Evaluator
from camliflow_torch.runtime.trainer import Trainer
from camliflow_torch.utils import tensorboard as ttb
from camliflow_torch.utils.visualization import viz_optical_flow
from test_tensorboard import parse_fields, read_records

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


@pytest.fixture
def fixed_clock(monkeypatch):
    """time.time, the host name and the pid as constants, for both writers."""
    monkeypatch.setattr(time, "time", lambda: 1789012345.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    monkeypatch.setattr(os, "getpid", lambda: 4321)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32c_and_masked_crc_match_jax(seed):
    rng = np.random.RandomState(seed)
    for n in (0, 1, 7, 8, 12, 255, 4096):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert ttb.crc32c(data) == jtb.crc32c(data)
        assert ttb.masked_crc(data) == jtb._masked_crc(data)


SCALARS = [("train/loss", 1.5, 0), ("train/epe2d", -0.125, 3), ("val/acc3d_5cm", 1e-9, 127),
           ("val/epe3d", 3.4e38, 128), ("val/outlier2d", 0.3333333333, 2 ** 40)]


def test_scalar_events_match_jax_byte_for_byte(tmp_path, fixed_clock):
    files = []
    for name, module in (("jax", jtb), ("port", ttb)):
        with module.EventWriter(tmp_path / name) as writer:
            for tag, value, step in SCALARS:
                writer.add_scalar(tag, value, step)
            files.append(writer.path)
    assert files[0].name == files[1].name == "events.out.tfevents.1789012345.host.4321.0"
    assert files[1].read_bytes() == files[0].read_bytes()
    records = read_records(files[1])
    assert parse_fields(records[0])[3] == [b"brain.Event:2"]
    assert len(records) == 1 + len(SCALARS)


def image_events(path):
    """[(tag, step, height, width, colorspace, png bytes)] of the file's
    image events."""
    out = []
    for record in read_records(path)[1:]:
        event = parse_fields(record)
        value = parse_fields(parse_fields(event[5][0])[1][0])
        if 4 in value:
            image = parse_fields(value[4][0])
            out.append((value[1][0].decode(), event[2][0], image[1][0], image[2][0],
                        image[3][0], image[4][0]))
    return out


def scalar_events(path):
    """[(tag, step, value)] of the file's scalar events."""
    out = []
    for record in read_records(path)[1:]:
        event = parse_fields(record)
        value = parse_fields(parse_fields(event[5][0])[1][0])
        if 2 in value:
            out.append((value[1][0].decode(), event[2][0], value[2][0]))
    return out


@pytest.mark.parametrize("shape", [(8, 6), (47, 156), (3, 1)])
def test_image_events_decode_to_the_same_pixels(tmp_path, fixed_clock, shape):
    rng = np.random.RandomState(shape[0])
    rgb = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    events = []
    for name, module in (("jax", jtb), ("port", ttb)):
        with module.EventWriter(tmp_path / name) as writer:
            writer.add_scalar("val/epe2d", 0.5, 2)
            writer.add_image("val/flow2d", rgb, 2)
        events.append(image_events(writer.path))
    (jax_event,), (port_event,) = events
    assert port_event[:5] == jax_event[:5] == ("val/flow2d", 2, shape[0], shape[1], 3)
    np.testing.assert_array_equal(png.decode(port_event[5]), rgb)
    np.testing.assert_array_equal(png.decode(jax_event[5]), rgb)


def test_trainer_records_match_jax(tmp_path, fixed_clock):
    """The JAX Trainer's `_dump_scalars` and the port's, on stubs holding each
    package's writer, write the same metrics.jsonl and the same event file,
    tag for tag, step for step, bit for bit."""
    summaries = [("train", 0, {"loss": 3.25, "epe2d": 1.0 / 3, "acc3d_5cm": 0.0}),
                 ("val", 0, {"epe2d": 2.5, "epe3d": 0.125, "outlier2d": 0.75}),
                 ("train", 1, {"loss": 2.0 ** -20, "epe2d": 7.0})]
    paths = []
    for name, trainer, module in (("jax", JaxTrainer, jtb), ("port", Trainer, ttb)):
        stub = SimpleNamespace(is_main=True, log_dir=tmp_path / name,
                               tb=module.EventWriter(tmp_path / name / "tb"))
        for tag, epoch, summary in summaries:
            trainer._dump_scalars(stub, tag, epoch, summary)
        stub.tb.close()
        paths.append(stub.tb.path)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    assert ((tmp_path / "port" / "metrics.jsonl").read_text()
            == (tmp_path / "jax" / "metrics.jsonl").read_text())
    assert [(tag, step) for tag, step, _ in scalar_events(paths[1])] == [
        (f"{tag}/{name}", epoch) for tag, epoch, summary in summaries for name in summary]


class Raising(torch.nn.Module):
    def forward(self, inputs):
        raise RuntimeError("a kernel fault")


def test_image_summary_raises_on_a_failed_forward_and_warns_on_a_failed_write(tmp_path,
                                                                                caplog):
    """The forward of the image summary runs outside any `try`, so a fault
    on the card stops the run; a file that cannot be written is logged."""
    batch = {"images": np.zeros((1, 16, 24, 6), np.float32)}
    stub = SimpleNamespace(model=Raising(), device=torch.device("cpu"), log_dir=tmp_path,
                           tb=None)
    with pytest.raises(RuntimeError, match="a kernel fault"):
        Trainer._save_image_summary(stub, 0, batch)

    class Flow(torch.nn.Module):
        def forward(self, inputs):
            return {"flow_2d": torch.ones(1, 16, 24, 2)}

    stub.model = Flow()
    (tmp_path / "images").write_text("a file where the folder goes")
    Trainer._save_image_summary(stub, 0, batch)
    assert "image summary failed" in caplog.text
    stub.log_dir = tmp_path / "ok"
    stub.log_dir.mkdir()
    Trainer._save_image_summary(stub, 4, batch)
    np.testing.assert_array_equal(png.read_png(stub.log_dir / "images" / "flow2d_epoch004.png"),
                                  viz_optical_flow(np.ones((16, 24, 2), np.float32)))


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft3d_tb")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
                    "--out", str(root), "--n", "4", "--height", "64", "--width", "96",
                    "--n_points", "600"], check=True, capture_output=True, timeout=120)
    return [f"trainset.root_dir={root}", f"valset.root_dir={root}", "trainset.n_points=512",
            "valset.n_points=512", "model.n_samples_list=[256,128,64,32,16]",
            "model.batch_size=2", "model.n_iters_train=2", "model.n_iters_eval=2",
            'model.backbone={"depth": 18, "pretrained": null}', "trainset.n_workers=2",
            "valset.n_workers=2", "log.val_interval=1", "log.print_interval=1",
            "training.epochs=1"]


def train(args, log_dir, *extra):
    return torch_train.main(["trainset=flyingthings3d_subset", "valset=flyingthings3d_subset",
                             "model=camliraft", "device=cpu", f"log.dir={log_dir}",
                             *args, *extra])


def test_cli_epoch_writes_scalar_events_and_the_image_summary(synthetic, tmp_path):
    """`log.save_image_summary=true`: images/flow2d_epoch000.png is the flow
    image (utils/visualization.py) of the port's flow for the first val
    batch's first sample, and tb/ holds the same image as a "val/flow2d"
    event at step 0, beside every metrics.jsonl scalar at its epoch."""
    log_dir = tmp_path / "run"
    trainer = train(synthetic, log_dir, "log.save_image_summary=true")
    assert trainer.tb._file.closed  # `run` closed the writer
    outputs = Evaluator(trainer.model, "cpu").forward(next(iter(trainer.val_loader)))
    want = viz_optical_flow(outputs["flow_2d"][0])
    assert want.shape == (64, 96, 3)
    np.testing.assert_array_equal(png.read_png(log_dir / "images" / "flow2d_epoch000.png"), want)

    (events,) = (log_dir / "tb").glob("events.out.tfevents.*")
    ((tag, step, height, width, colorspace, data),) = image_events(events)
    assert (tag, step, height, width, colorspace) == ("val/flow2d", 0, 64, 96, 3)
    np.testing.assert_array_equal(png.decode(data), want)

    lines = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    want_scalars = [(f"{x['tag']}/{k}", x["epoch"], np.float32(v)) for x in lines
                    for k, v in x.items() if k not in ("tag", "epoch")]
    assert [(t, s) for t, s, _ in scalar_events(events)] == [(t, s) for t, s, _ in want_scalars]
    assert [v for _, _, v in scalar_events(events)] == [v for _, _, v in want_scalars]


def test_cli_without_tensorboard_writes_no_events(synthetic, tmp_path):
    """`log.tensorboard=false` writes no tb/ (and, without
    `log.save_image_summary`, no images/); missing, it is on."""
    trainer = train(synthetic, tmp_path / "off", "log.tensorboard=false")
    assert trainer.tb is None
    assert sorted(p.name for p in (tmp_path / "off").iterdir()) == [
        "best_metrics.json", "ckpts", "ckpts_best", "metrics.jsonl", "train.log"]
