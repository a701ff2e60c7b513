"""PyTorch port, data parallelism on the CPU: ranks in processes of their
own over gloo (`camliflow_torch.parallel.dist.spawn`, a file rendezvous in
the test's directory, one thread a rank), running tests/torch_ddp_worker.py,
held to the JAX package, which runs in this process.

- Two ranks at a global batch of 4 (2 each) take one train step of
  CamLiRAFT-L (512 points) and of PWC (128x192, its second half's 2D
  validity sparser, so the ranks' valid counts differ) against the JAX
  package's `make_train_step` on a 2-device mesh at the same batch: loss,
  gradients, branch norms, BatchNorm statistics and parameters after the
  step to tests/torch_train_parity.py's bounds (the JAX side selecting by
  the port's distance, as there); both ranks hold the same state bit for
  bit.
- The masked-mean losses under `global_means` (unequal counts) against
  the JAX losses over the whole batch; BatchNorm's global statistics
  against one process's BatchNorm on the whole batch.
- One rank through the training CLI against one process, bit for bit.
- The rank-sharded loader against the JAX package's DataLoader.
- Two ranks evaluating 9 samples through the eval entry point (global
  batches of 8: rank 1's last slice empty) and the scene-flow protocol's
  sums (global batches of 2) against the JAX Evaluator's single-process
  totals.
- The training CLI under a torchrun environment of 2 ranks (`device=cpu`):
  only rank 0 writes files, the checkpoint carries no `module.` and is read
  by the one-process eval, and both 2 ranks and one process resume from it.

Every group of processes is waited for with a timeout of its own
(`RANK_TIMEOUT`), so a hung collective fails its test.
"""

import ast
import contextlib
import json
import logging
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from camliflow_tpu.data.loader import DataLoader as JaxDataLoader
from camliflow_tpu.models import camliraft_l as jm_l
from camliflow_tpu.models import losses as jlosses
from camliflow_tpu.models import pwc as jm_pwc
from camliflow_tpu.models.factory import optimizer_factory as jax_optimizer_factory
from camliflow_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from camliflow_tpu.runtime.train_state import TrainState, make_train_step
from camliflow_tpu.utils.config import Config as JConfig
from camliflow_tpu.utils.config import compose as jax_compose
from camliflow_torch import eval as torch_eval
from camliflow_torch import train as torch_train
from camliflow_torch.data.loader import DataLoader
from camliflow_torch.models import camliraft_l as tm_l
from camliflow_torch.models import pwc as tm_pwc
from camliflow_torch.models.factory import optimizer_factory, set_learning_rates
from camliflow_torch.parallel import dist
from test_torch_pwc import jax_variables
from torch_train_parity import N_SAMPLES, Steps, make_batch, port_selection_rule
import torch_ddp_worker as worker

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 300  # seconds a group of ranks may take

# tests/test_torch_train_step_camliraft_l.py's and _pwc.py's configs
FAMILIES = {
    "camliraft_l": (jm_l, jm_l.CamLiRAFTL, tm_l.CamLiRAFTL,
                    {"name": "camliraft_l", "n_iters_train": 2, "n_iters_eval": 2,
                     "fast_inference": "auto", "ids": {"enabled": True},
                     "n_samples_list": N_SAMPLES, "loss": {"gamma": 0.8, "order": "l2-norm"}},
                    {"opt": "adamw", "lr": 2e-3, "weight_decay": 1e-6, "grad_max_norm": 1,
                     "epochs": 100, "warmup_epochs": 2, "warmup_lr": 1e-5, "min_lr": 1e-5}),
    "pwc": (jm_pwc, jm_pwc.PWC, tm_pwc.PWC,
            {"name": "pwc", "max_displacement": 4, "lite_estimator": False,
             "norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                      "context_network": None},
             "loss": {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2-norm"}},
            {"opt": "adam", "lr": 1e-3, "weight_decay": 1e-6, "eps": 1e-7,
             "grad_max_norm": 20.0, "epochs": 200, "warmup_epochs": 10, "warmup_lr": 1e-4,
             "min_lr": 1e-5}),
}


def family_batch(name):
    """Global batch 4: CamLiRAFT-L's clouds (its loss has no mask), or PWC's
    images with the second half's 2D validity at 20% against 70%, so the
    two ranks' valid counts differ."""
    if name == "camliraft_l":
        return make_batch(0, batch=4, images=False)
    batch = make_batch(0, batch=4, h=128, w=192, points=False)
    batch["flow_2d"][2:, ..., 2] = np.random.RandomState(1).rand(2, 128, 192) > 0.8
    valid = batch["flow_2d"][..., 2]
    assert valid[:2].sum() > 2 * valid[2:].sum()
    return batch


@contextlib.contextmanager
def root_logger_restored():
    """A Trainer sets up the root logger (`logging.basicConfig`: INFO, a
    stream handler and one on its train.log); undo that after, so that
    later tests in the process log as they would alone."""
    root = logging.getLogger()
    level, before = root.level, root.handlers[:]
    try:
        yield
    finally:
        for handler in root.handlers[:]:
            if handler not in before:
                root.removeHandler(handler)
                handler.close()
        root.setLevel(level)


def synthetic_set(root, n):
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
                    "--out", str(root), "--n", str(n), "--height", "64", "--width", "96",
                    "--n_points", "600"], check=True, capture_output=True, timeout=120)


class InBackground:
    """`dist.spawn(...)` on a thread of this process, so the JAX side runs
    meanwhile; `wait` re-raises what the ranks raised."""

    def __init__(self, fn, nprocs, args, rdzv):
        self.error = None

        def run():
            try:
                dist.spawn(fn, nprocs, args, device_type="cpu", init_method=f"file://{rdzv}",
                           timeout=RANK_TIMEOUT)
            except BaseException as exc:  # handed to wait
                self.error = exc

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def wait(self):
        self.thread.join(RANK_TIMEOUT + 30)
        assert not self.thread.is_alive(), "the ranks did not finish"
        if self.error is not None:
            raise self.error


def mesh_step(jax_module, jax_cls, cfgs, training, batch, flat):
    """The JAX package's `make_train_step` on a 2-device mesh at the global
    batch, selecting by the port's distance: the reference dict
    torch_train_parity.Steps holds the port to (the gradients kept by an
    optax stage that passes them through into the optimizer state)."""
    tree = flat_to_tree(flat)
    tx = jax_optimizer_factory(JConfig(training), tree["params"], steps_per_epoch=4)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    keep = optax.GradientTransformation(lambda p: (tx.init(p), jax.tree.map(jnp.zeros_like, p)),
                                        update)
    mesh = make_mesh(jax.devices()[:2])
    state = TrainState(params=replicate_tree(tree["params"], mesh),
                       batch_stats=replicate_tree(tree["batch_stats"], mesh),
                       opt_state=replicate_tree(keep.init(tree["params"]), mesh),
                       step=jnp.zeros((), jnp.int32))
    step = make_train_step(jax_cls(cfgs=cfgs, train_mode=True), jax_module.loss_fn, keep,
                           JConfig(cfgs), donate=False)
    with port_selection_rule():
        state, loss, _, norms = step(state, shard_batch(batch, mesh))
    host = jax.tree.map(np.asarray, state)
    return {"loss": float(loss), "grads": tree_to_flat(host.opt_state[1]),
            "stats": tree_to_flat({"batch_stats": host.batch_stats}),
            "params": tree_to_flat(host.params),
            "norms": {k: float(v) for k, v in norms.items()}}


class RankSteps(Steps):
    """Steps whose port side is rank 0's step out of a 2-rank group and
    whose reference is `mesh_step`: the checks of Steps apply unchanged."""

    def __init__(self, name, flat, ref, results):
        (self.jax_module, self.jax_cls, self.torch_cls, self.cfgs,
         self.training) = FAMILIES[name]
        self.name, self.flat, self.ref, self.results = name, flat, ref, results
        mine = results[0]
        self.port = self.bridged(self.cfgs).train()
        with torch.no_grad():
            for key, param in self.port.named_parameters():
                param.copy_(torch.from_numpy(mine[f"param/{key}"]))
                param.grad = torch.from_numpy(mine[f"grad/{key}"])
            for key, buffer in self.port.named_buffers():
                buffer.copy_(torch.from_numpy(mine[f"buffer/{key}"]))
        self.optimizer = optimizer_factory(self.training, self.port, steps_per_epoch=4,
                                           model_name=name)
        set_learning_rates(self.optimizer, 0)
        self.loss = float(mine["loss"])
        self.telemetry = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in mine.items()
                          if k.startswith("telemetry/")}
        self.shapes = {k: tuple(v.shape) for k, v in self.port.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts every rank of the module's cases, computes the JAX side
    meanwhile, then waits for the ranks."""
    work = tmp_path_factory.mktemp("ranks")
    data = work / "ft3d"
    synthetic_set(data, 5)  # training: 2 steps of 2 an epoch, 5 validation pairs
    synthetic_set(work / "ft3d9", 9)  # evaluation: batches of 8 and 1
    for name, (_, jax_cls, _, cfgs, training) in FAMILIES.items():
        batch = family_batch(name)
        np.savez(work / f"{name}.batch.npz", **batch)
        np.savez(work / f"{name}.variables.npz", **jax_variables(jax_cls, cfgs, batch))
        (work / f"{name}.json").write_text(json.dumps({"cfgs": cfgs, "training": training}))

    # evaluation: CamLiRAFT-L from seeded JAX variables on the 9 val pairs
    overrides = [f"testset.root_dir={work / 'ft3d9'}", "testset.n_points=512",
                 "testset.n_workers=0",
                 "model.n_iters_eval=2", 'model.fast_inference="off"',
                 "model.n_samples_list=[256,128,64,32,16]", f"ckpt.path={work / 'l.npz'}"]
    cfgs = jax_compose(REPO / "conf", testset="flyingthings3d_subset", model="camliraft_l",
                       base="evaluator.yaml", overrides=overrides)
    pcs = make_batch(0, batch=1, images=False)
    np.savez(work / "l.npz", **jax_variables(jm_l.CamLiRAFTL, cfgs.model.to_dict(),
                                             {k: pcs[k] for k in ("pcs", "intrinsics")}))
    eval_argv = ["model=camliraft_l", "testset=flyingthings3d_subset", "protocol=things",
                 "device=cpu", *overrides]

    # one rank through the training CLI (the flagship, cut small)
    train_argv = ["trainset=flyingthings3d_subset", "valset=flyingthings3d_subset",
                  "model=camliraft", "device=cpu", f"trainset.root_dir={data}",
                  f"valset.root_dir={data}", "trainset.n_points=512", "valset.n_points=512",
                  "model.n_samples_list=[256,128,64,32,16]", "model.batch_size=2",
                  "model.n_iters_train=2", "model.n_iters_eval=2",
                  'model.backbone={"depth": 18, "pretrained": null}', "trainset.n_workers=0",
                  "valset.n_workers=0", "training.epochs=1"]
    two = InBackground(worker.two_rank_cases, 2,
                       (str(work), list(FAMILIES), eval_argv), work / "rdzv2")
    one = InBackground(worker.train_cli, 1, (str(work), train_argv + [f"log.dir={work}/one"]),
                       work / "rdzv1")

    refs = {name: mesh_step(jax_module, jax_cls, cfgs_, training,
                            dict(np.load(work / f"{name}.batch.npz")),
                            dict(np.load(work / f"{name}.variables.npz")))
            for name, (jax_module, jax_cls, _, cfgs_, training) in FAMILIES.items()}
    evaluator = JaxEvaluator(cfgs, batch_size=9)
    jax_eval = {"things": evaluator.run_things(),
                **{f"sf_per_sample={p}": evaluator.run_sf_protocol(p, False)
                   for p in (False, True)}}
    one.wait()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the rank's count: the CPU's sums split by thread
    try:
        with root_logger_restored():
            alone = torch_train.main(train_argv + [f"log.dir={work}/alone"])
    finally:
        torch.set_num_threads(threads)
    two.wait()
    return {"work": work, "refs": refs, "jax_eval": jax_eval, "alone": alone}


def rank_results(work, case):
    return [dict(np.load(work / f"{case}.rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def steps(runs):
    return {name: RankSteps(name, dict(np.load(runs["work"] / f"{name}.variables.npz")),
                            runs["refs"][name], rank_results(runs["work"], name))
            for name in FAMILIES}


@pytest.mark.parametrize("check", ["loss", "gradients", "branch_grad_norms",
                                   "batchnorm_statistics", "parameters_after_the_step"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_two_ranks_take_the_jax_mesh_step(steps, name, check):
    step = steps[name]
    if check == "branch_grad_norms":
        step.check_branch_grad_norms({"2d"})
    else:
        getattr(step, f"check_{check}")()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_ranks_hold_the_same_state(steps, name):
    first, second = steps[name].results
    assert first.keys() == second.keys()
    for key in first:
        np.testing.assert_array_equal(first[key], second[key], err_msg=key)


@pytest.mark.parametrize("kind", worker.LOSSES)
def test_global_masked_means_match_jax(runs, kind):
    """Loss and prediction gradients of the two ranks under `global_means`
    against the JAX loss over the whole batch (loss to 1e-6 relative,
    gradients within 1e-3 of their largest magnitude: the frameworks' resize
    and power round apart) and against the port's own loss in one process
    (gradients to 1e-5 relative)."""
    arrays = worker.loss_inputs(kind)
    target = jnp.asarray(arrays["target"], jnp.float32)
    n = sum(k.startswith("pred") for k in arrays)
    preds = [jnp.asarray(arrays[f"pred{i}"], jnp.float32) for i in range(n)]
    counts = [float(np.sum(arrays["target"][half, ..., -1])) for half in (slice(0, 2),
                                                                          slice(2, 4))]
    assert counts[0] > 2 * counts[1]

    def loss(preds):
        if kind == "sequence_3d":
            return jlosses.calc_sequence_loss(preds[0], target, 0.8, "l2-norm")
        if kind == "pyramid_2d":
            return jlosses.calc_pyramid_loss_2d(preds, target, [4.0, 2.0, 1.0], "robust")
        indices = [jnp.asarray(arrays[f"index{i}"]) for i in range(3)]
        return jlosses.calc_pyramid_loss_3d(preds, target, [4.0, 2.0, 1.0], "l2-norm",
                                            indices)

    value, grads = jax.value_and_grad(loss)(preds)
    alone = [torch.tensor(np.asarray(p), requires_grad=True) for p in preds]
    worker.loss_of(kind, arrays, alone).backward()
    got = [dict(np.load(runs["work"] / f"losses.rank{r}.npz")) for r in range(2)]
    for rank in got:
        np.testing.assert_allclose(rank[f"{kind}/loss"], float(value), rtol=1e-6)
    axis = 1 if kind == "sequence_3d" else 0
    for i, grad in enumerate(grads):
        port = np.concatenate([g[f"{kind}/grad{i}"] for g in got], axis)
        want = np.asarray(grad)
        np.testing.assert_allclose(port, want, atol=1e-3 * np.abs(want).max())
        np.testing.assert_allclose(port, alone[i].grad.numpy(), rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("channel_dim", [-1, 1])
def test_global_batchnorm_matches_one_process(runs, channel_dim):
    """Two ranks' BatchNorm (E[x^2] - E[x]^2 over both) against one
    process's on the whole batch: outputs, input gradients, the weight
    and bias gradients summed over the ranks (DDP averages the ranks' sums
    of the per-rank losses), running statistics on both ranks."""
    want = worker.batchnorm_run(channel_dim, worker.batchnorm_inputs(channel_dim))
    got = [dict(np.load(runs["work"] / f"batchnorm.rank{r}.npz")) for r in range(2)]
    for key in ("out", "x_grad"):
        np.testing.assert_allclose(np.concatenate([g[f"{channel_dim}/{key}"] for g in got]),
                                   want[key], atol=1e-5, err_msg=key)
    for key in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose(got[0][f"{channel_dim}/{key}"] + got[1][f"{channel_dim}/{key}"],
                                   want[key], rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("running_mean", "running_var"):
        for g in got:
            np.testing.assert_allclose(g[f"{channel_dim}/{key}"], want[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)


def test_one_rank_is_the_one_process_trainer_bit_for_bit(runs):
    """The training CLI in a group of one (DistributedDataParallel over
    gloo) against one process: the same losses and state, bit for bit."""
    got = dict(np.load(runs["work"] / "train_cli.rank0.npz"))
    alone = runs["alone"]
    assert got["losses"].tolist() == [h["loss"] for h in alone.history]
    state = alone.model.state_dict()
    assert {k[len("state/"):] for k in got if k.startswith("state/")} == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(got[f"state/{key}"], value.numpy(), err_msg=key)


class Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i])}


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sharded_loader_matches_jax(shuffle, drop_last, shards):
    """10 samples in global batches of 4: each shard reads the JAX loader's
    indices, epoch by epoch; with the remainder kept, 2 shards leave the
    second one's last slice empty, 4 the last two's."""
    for epoch in (0, 3):
        seen = []
        for shard in range(shards):
            loaders = [cls(Indexed(10), 4, shuffle=shuffle, num_workers=0, drop_last=drop_last,
                           shard_index=shard, num_shards=shards, seed=7)
                       for cls in (DataLoader, JaxDataLoader)]
            order = []
            for loader in loaders:
                loader.set_epoch(epoch)
                order.append([b["i"][:, 0].tolist() for b in loader])
            assert order[0] == order[1]
            assert all(len(b) == 4 // shards for b in order[0][:2])
            seen += [i for b in order[0] for i in b]
        assert len(set(seen)) == len(seen) == (8 if drop_last else 10)


def test_two_rank_evaluator_matches_the_jax_evaluator(runs):
    """9 samples over 2 ranks: the things protocol through the eval entry
    point (global batches of 8, rank 1's last slice empty) and the
    scene-flow protocol's two sums (global batches of 2, likewise), on both
    ranks, against the JAX Evaluator in one process."""
    got = [json.loads((runs["work"] / f"eval.rank{r}.json").read_text()) for r in range(2)]
    assert got[0] == got[1]
    want = runs["jax_eval"]
    assert set(got[0]) == set(want)
    for run, results in want.items():
        assert set(got[0][run]) == set(results), run
        for key, value in results.items():
            assert abs(got[0][run][key] - value) <= 1e-4, (run, key, got[0][run][key], value)


def test_sharded_eval_batches_skip_an_empty_slice():
    from camliflow_torch.data.datasets import batches

    slices = [[b["i"][:, 0].tolist() for b in batches(Indexed(5), 2, r, 2)] for r in range(2)]
    assert slices == [[[0], [2], [4]], [[1], [3]]]
    with pytest.raises(ValueError):
        next(batches(Indexed(5), 3, 0, 2))


def torchrun_env(rank, port):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    return {**env, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(REPO)}


def torchrun(argv, cwd):
    """`python -m camliflow_torch.train argv` as 2 ranks of torchrun's
    environment; both must exit 0 within RANK_TIMEOUT."""
    port = dist.free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "camliflow_torch.train", *argv],
                              cwd=cwd, env=torchrun_env(rank, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [proc.communicate(timeout=RANK_TIMEOUT)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return outs


def test_train_cli_under_torchrun_two_ranks(runs, tmp_path):
    data = runs["work"] / "ft3d"
    log_dir = tmp_path / "run"
    argv = ["trainset=flyingthings3d_subset", "valset=flyingthings3d_subset",
            "model=camliraft_l", "device=cpu", f"trainset.root_dir={data}",
            f"valset.root_dir={data}", "trainset.n_points=512", "valset.n_points=512",
            "model.n_samples_list=[256,128,64,32,16]", "model.batch_size=2",
            "model.n_iters_train=2", "model.n_iters_eval=2", "trainset.n_workers=0",
            "valset.n_workers=0", f"log.dir={log_dir}", "log.val_interval=1"]
    torchrun(argv + ["training.epochs=1"], tmp_path)
    # one writer: one line per summary, one event file, one checkpoint a folder
    lines = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(x["tag"], x["epoch"]) for x in lines] == [("train", 0), ("val", 0)]
    assert len(list((log_dir / "tb").iterdir())) == 1
    assert sorted(p.name for p in log_dir.rglob("*") if p.is_file() and p.parent.name != "tb") \
        == ["0.pt", "0.pt", "best_metrics.json", "metrics.jsonl", "train.log"]
    assert (log_dir / "train.log").read_text().count("train epoch 1:") == 1
    state = torch.load(log_dir / "ckpts" / "0.pt", weights_only=True)["model"]
    assert state and not any(k.startswith("module.") for k in state)
    # the one-process eval reads it
    results = torch_eval.main(["protocol=things", "testset=flyingthings3d_subset",
                               "model=camliraft_l", "device=cpu", f"testset.root_dir={data}",
                               "testset.n_points=512", "model.n_samples_list=[256,128,64,32,16]",
                               "model.n_iters_eval=2", f"ckpt.path={log_dir / 'ckpts' / '0.pt'}"])
    assert np.isfinite(results["EPE3d"])
    # 2 ranks resume from it, then one process from theirs
    torchrun(argv + ["training.epochs=2", "ckpt.resume=true"], tmp_path)
    lines = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(x["tag"], x["epoch"]) for x in lines][2:] == [("train", 1), ("val", 1)]
    with root_logger_restored():
        alone = torch_train.main(argv + ["training.epochs=3", "ckpt.resume=true"])
    assert alone.start_epoch == 2 and alone.step == 6  # 5 pairs: 2 steps of 2 an epoch
    assert sorted(p.name for p in (log_dir / "ckpts").glob("*.pt")) == ["0.pt", "1.pt", "2.pt"]


def test_worker_never_imports_jax():
    """The ranks import tests/torch_ddp_worker.py: torch and the port only."""
    banned = {"jax", "flax", "optax", "camliflow_tpu", "tools"}
    source = (REPO / "tests" / "torch_ddp_worker.py").read_text()
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name.split(".")[0] in banned]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found += [node.module] if node.module.split(".")[0] in banned else []
    assert not found, found
