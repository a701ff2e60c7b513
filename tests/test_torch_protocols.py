"""PyTorch port: the eval protocols (runtime/evaluator.py's run_sintel and
run_sf_protocol, and eval.py's protocol dispatch) against the JAX Evaluator,
on the CPU.

The evaluators are fed the same fixed outputs (the JAX one built as
tests/test_evaluator.py builds it), and their metrics must agree to 1e-12
relative. Then the port's CLI runs every protocol end to end on a tiny
synthetic set with `device=cpu`, and the JAX Evaluator, fed the batches
and outputs of that run, must give the same metrics. The KITTI protocols
read the reference's relative roots, so they run from a temporary working
directory that holds them.
"""

from pathlib import Path
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import camliraft_l as jm
from camliflow_tpu.models import raft as jm_raft
from camliflow_tpu.runtime.checkpoint import flat_to_tree, save_variables, tree_to_flat
from camliflow_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from camliflow_tpu.utils.config import Config, compose
from camliflow_torch import eval as torch_eval
from camliflow_torch.data import protocol_datasets as tpd
from camliflow_torch.runtime.evaluator import Evaluator as TorchEvaluator

from test_torch_data import (
    write_flownet3d_things,
    write_hpl,
    write_kitti_pointpwc,
    write_kitti_rm_ground,
    write_sintel,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SF_SETTINGS = [(False, False), (True, True), (True, False), (False, True)]


def assert_metrics_equal(got, ref):
    assert set(got) == set(ref), (got, ref)
    for key in ref:
        assert abs(got[key] - ref[key]) <= 1e-12 * abs(ref[key]), (key, got[key], ref[key])


# --- the evaluators on the same fixed outputs ----------------------------

class PointSamples:
    """LiDAR samples with a noc mask; sample 3's mask is empty."""

    def __init__(self, n_samples=5, n=256):
        self.n_samples, self.n = n_samples, n

    def __len__(self):
        return self.n_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        pc1 = rng.randn(self.n, 3).astype(np.float32)
        pc1[:, 2] = np.abs(pc1[:, 2]) * 10 + 5
        flow = (0.1 * rng.randn(self.n, 3)).astype(np.float32)
        flow[:: 7] = 0  # zero targets: the relative error's epsilon
        noc = (rng.rand(self.n) > 0.3).astype(np.float32)
        if i == 3:
            noc[:] = 0
        return {"index": i, "pcs": np.concatenate([pc1, pc1 + flow], 1),
                "flow_3d": flow, "intrinsics": np.float32([1050, 479.5, 269.5]),
                "noc_mask_3d": noc}


class SintelSamples:
    """Image samples of three scenes, out of scene order."""

    def __init__(self, n_samples=5, h=12, w=16):
        self.n_samples, self.h, self.w = n_samples, h, w

    def __len__(self):
        return self.n_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(50 + i)
        return {"index": i, "scene_name": ("market_2", "alley_1", "cave_4")[i % 3],
                "flow_2d": (3 * rng.randn(self.h, self.w, 2)).astype(np.float32)}


def fixed_outputs(batch):
    """The same outputs for both evaluators: the targets plus noise seeded by
    the batch's first index, a NaN in each 2D map."""
    rng = np.random.RandomState(100 + int(batch["index"][0]))
    out = {}
    if "flow_3d" in batch:
        target = batch["flow_3d"][..., :3]
        out["flow_3d"] = (target + 0.08 * rng.randn(*target.shape)).astype(np.float32)
    if "flow_2d" in batch:
        target = batch["flow_2d"][..., :2]
        out["flow_2d"] = (target + 2 * rng.randn(*target.shape)).astype(np.float32)
        out["flow_2d"][:, 0, 0, 0] = np.nan
    return out


@pytest.fixture(scope="module")
def jax_evaluator():
    """tests/test_evaluator.py's JAX Evaluator (a tiny CamLiRAFT-L), on any
    dataset, at batch 2."""
    cfgs = Config({
        "model": {"name": "camliraft_l", "n_iters_train": 1, "n_iters_eval": 1,
                  "ids": {"enabled": False}, "loss": {"gamma": 0.8, "order": "l2-norm"},
                  "n_samples_list": [128, 64, 32, 16]},
        "testset": {"n_workers": 0},
        "ckpt": {"path": None},
    })
    sample = PointSamples()[0]
    inputs = {k: jnp.asarray(v)[None] for k, v in sample.items() if isinstance(v, np.ndarray)}
    model = jm.CamLiRAFTL(cfgs=cfgs.model.to_dict(), train_mode=False)
    variables = model.init(jax.random.PRNGKey(0), inputs)

    def make(dataset):
        ev = JaxEvaluator(cfgs, variables=variables, batch_size=2, dataset=dataset)
        ev._forward_device = fixed_outputs
        return ev

    return make


def torch_evaluator():
    ev = TorchEvaluator(torch.nn.Identity(), "cpu")
    ev.enqueue = fixed_outputs  # the "enqueued" forward is the outputs themselves
    ev.fetch = lambda outputs: outputs
    return ev


def batches_of(dataset, size=2):
    from camliflow_torch.data.datasets import batches

    return batches(dataset, size)


@pytest.mark.parametrize("per_sample_average,use_noc_mask", SF_SETTINGS)
def test_run_sf_protocol_matches_jax(jax_evaluator, per_sample_average, use_noc_mask):
    dataset = PointSamples()
    ref = jax_evaluator(dataset).run_sf_protocol(per_sample_average, use_noc_mask)
    got = torch_evaluator().run_sf_protocol(batches_of(dataset), per_sample_average,
                                            use_noc_mask)
    assert set(got) == {"EPE3d", "AccS", "AccR", "Outlier"}
    assert_metrics_equal(got, ref)


def test_run_sintel_matches_jax(jax_evaluator, caplog):
    dataset = SintelSamples()
    ref = jax_evaluator(dataset).run_sintel()
    with caplog.at_level("INFO", logger="camliflow_torch"):
        got = torch_evaluator().run_sintel(batches_of(dataset))
    assert set(got) == {"AEPE"} and np.isfinite(got["AEPE"])
    assert_metrics_equal(got, ref)
    # a line a scene, in scene order, then the total
    # the port's lines only: where an earlier test in the process left the
    # root logger at INFO (a Trainer's logging setup), the JAX Evaluator's
    # lines above are captured too
    lines = [r.getMessage() for r in caplog.records if r.name == "camliflow_torch"]
    assert [line.split(":")[0] for line in lines] == ["alley_1", "cave_4", "market_2", "Total"]


# --- the CLI, end to end, against the JAX Evaluator on its outputs ---------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX CamLiRAFT-L and RAFT (ResNet-18) checkpoints, BatchNorm statistics
    away from 0 and 1."""
    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.RandomState(0)
    pcs = rng.randn(1, 512, 6).astype(np.float32)
    pcs[..., 2] = np.abs(pcs[..., 2]) * 10 + 5
    pcs[..., 5] = pcs[..., 2] + 0.1
    l_cfgs = {"n_iters_eval": 2, "ids": {"enabled": True}, "fast_inference": "off",
              "n_samples_list": [256, 128, 64, 32, 16]}
    l_vars = jax.jit(jm.CamLiRAFTL(cfgs=l_cfgs, train_mode=False).init)(
        jax.random.PRNGKey(0), {"pcs": jnp.asarray(pcs),
                                "intrinsics": jnp.asarray([[1050.0, 479.5, 269.5]])})
    raft_cfgs = compose(REPO / "conf", model="raft", base="evaluator.yaml",
                        overrides=["model.backbone.depth=18"]).model.to_dict()
    images = rng.randint(0, 255, (1, 64, 96, 6)).astype(np.float32)
    raft_vars = jax.jit(jm_raft.RAFT(cfgs=raft_cfgs, train_mode=False).init)(
        jax.random.PRNGKey(1), {"images": jnp.asarray(images)})
    paths = {}
    for name, variables in (("camliraft_l", l_vars), ("raft", raft_vars)):
        flat = tree_to_flat(jax.tree.map(np.asarray, variables))
        for key in flat:
            if key.endswith("/var"):
                flat[key] = (1.0 + rng.rand(*flat[key].shape)).astype(np.float32)
            elif key.endswith("/mean"):
                flat[key] = (0.1 * rng.randn(*flat[key].shape)).astype(np.float32)
        paths[name] = root / f"{name}.npz"
        save_variables(paths[name], flat_to_tree(flat))
    return paths


POINT_MODEL = ["model.n_iters_eval=2", 'model.fast_inference="off"',  # bare off is YAML False
               "model.n_samples_list=[256,128,64,32,16]", "testset.n_points=512",
               "testset.n_workers=0"]


def protocol_case(protocol, root, checkpoints):
    """(testset, model, overrides) for a protocol's CLI run on the synthetic
    set under `root` (which the KITTI protocols run from)."""
    point = POINT_MODEL + [f"ckpt.path={checkpoints['camliraft_l']}"]
    if protocol == "things":
        subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
                        "--out", str(root), "--n", "3", "--n_points", "600"],
                       check=True, capture_output=True, timeout=120)
        return "flyingthings3d_subset", "camliraft_l", point + [f"testset.root_dir={root}"]
    if protocol == "sintel":
        write_sintel(root)
        return "sintel", "raft", [
            f"testset.root_dir={root}", "testset.n_points=256", "testset.n_workers=0",
            "model.n_iters_eval=2", 'model.fast_inference="off"', "model.backbone.depth=18",
            f"ckpt.path={checkpoints['raft']}"]
    if protocol == "things_noc_sf":
        write_hpl(root, 3)
        return "flyingthings3d_subset_hpl", "camliraft_l", point + [f"testset.root_dir={root}"]
    if protocol == "things_occ_sf":
        write_flownet3d_things(root)
        return ("flyingthings3d_subset_flownet3d", "camliraft_l",
                point + [f"testset.root_dir={root}"])
    (write_kitti_rm_ground if protocol == "kitti_occ_sf" else write_kitti_pointpwc)(root)
    return "kitti", "camliraft_l", point


class Recorded:
    """The samples of recorded batches, for the JAX Evaluator's loader."""

    def __init__(self, batches):
        self.samples = [{k: v[b] for k, v in batch.items()}
                        for batch in batches for b in range(len(batch["index"]))]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.mark.parametrize("protocol", list(torch_eval.PROTOCOLS))
def test_eval_cli_runs_each_protocol(protocol, checkpoints, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tpd, "HPL_VAL_SAMPLES", 3)  # the synthetic set's directories
    testset, model, overrides = protocol_case(protocol, tmp_path, checkpoints)
    seen = []
    lookahead = TorchEvaluator.batches

    def recording(self, batches):
        for batch, out in lookahead(self, batches):
            seen.append((batch, out))
            yield batch, out

    monkeypatch.setattr(TorchEvaluator, "batches", recording)
    got = torch_eval.main([f"protocol={protocol}", f"testset={testset}", f"model={model}",
                           "device=cpu"] + overrides)
    assert seen and all(np.isfinite(v) for v in got.values()), got

    cfgs = compose(REPO / "conf", testset=testset, model=model, base="evaluator.yaml",
                   overrides=overrides)
    ref_ev = JaxEvaluator(cfgs, variables={"params": {}}, batch_size=torch_eval.BATCH_SIZE,
                          dataset=Recorded([batch for batch, _ in seen]))
    outputs = iter([out for _, out in seen])
    ref_ev._forward_device = lambda batch: next(outputs)
    if protocol == "things":
        ref = ref_ev.run_things()
    elif protocol == "sintel":
        ref = ref_ev.run_sintel()
    else:
        ref = ref_ev.run_sf_protocol(*torch_eval.PROTOCOLS[protocol])
    assert_metrics_equal(got, ref)
