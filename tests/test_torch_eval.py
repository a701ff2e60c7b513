"""PyTorch port: the eval entry point against the JAX Evaluator, the port's
independence from JAX, and chip_smoke.py's refusal to run without a card."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import camlipwc as jm_camlipwc
from camliflow_tpu.models import camlipwc_l as jm_camlipwc_l
from camliflow_tpu.models import camliraft as jm_flagship
from camliflow_tpu.models import camliraft_l as jm
from camliflow_tpu.models import pwc as jm_pwc
from camliflow_tpu.models import raft as jm_raft
from camliflow_tpu.runtime.checkpoint import flat_to_tree, save_variables, tree_to_flat
from camliflow_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from camliflow_tpu.utils.config import compose
from camliflow_torch import eval as torch_eval
from test_torch_pwc import jax_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A FlyingThings3D-format set (tools/make_synthetic_dataset.py) and a
    JAX CamLiRAFT-L checkpoint (.npz) with BN statistics away from 0/1."""
    root = tmp_path_factory.mktemp("ft3d")
    subprocess.run(
        [sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
         "--out", str(root), "--n", "3", "--n_points", "600"],
        check=True, capture_output=True, timeout=120,
    )
    cfgs = {"n_iters_eval": 2, "ids": {"enabled": True}, "fast_inference": "off",
            "n_samples_list": [256, 128, 64, 32, 16]}
    rng = np.random.RandomState(0)
    pcs = rng.randn(1, 512, 6).astype(np.float32)
    pcs[..., 2] = np.abs(pcs[..., 2]) * 10 + 5
    pcs[..., 5] = pcs[..., 2] + 0.1
    inputs = {"pcs": jnp.asarray(pcs),
              "intrinsics": jnp.asarray([[1050.0, 479.5, 269.5]], jnp.float32)}
    variables = jax.jit(jm.CamLiRAFTL(cfgs=cfgs, train_mode=False).init)(
        jax.random.PRNGKey(0), inputs)
    flat = tree_to_flat(jax.tree.map(np.asarray, variables))
    for key in flat:
        if key.endswith("/var"):
            flat[key] = (1.0 + rng.rand(*flat[key].shape)).astype(np.float32)
        elif key.endswith("/mean"):
            flat[key] = (0.1 * rng.randn(*flat[key].shape)).astype(np.float32)
    ckpt = root / "camliraft_l.npz"
    save_variables(ckpt, flat_to_tree(flat))
    overrides = [
        f"testset.root_dir={root}", "testset.n_points=512", "testset.n_workers=0",
        "model.n_iters_eval=2", 'model.fast_inference="off"',  # bare off is YAML False
        "model.n_samples_list=[256,128,64,32,16]", f"ckpt.path={ckpt}",
    ]
    return overrides


def test_eval_cli_matches_jax_evaluator(synthetic):
    args = ["protocol=things", "testset=flyingthings3d_subset", "model=camliraft_l",
            "device=cpu"]
    got = torch_eval.main(args + synthetic)
    cfgs = compose(REPO / "conf", testset="flyingthings3d_subset", model="camliraft_l",
                   base="evaluator.yaml", overrides=synthetic)
    ref = JaxEvaluator(cfgs, batch_size=torch_eval.BATCH_SIZE).run_things()
    assert set(got) == {"EPE3d", "5cm", "10cm", "EPE3d_noc", "5cm_noc", "10cm_noc"}
    for key in got:
        assert abs(got[key] - ref[key]) <= 1e-4, (key, got[key], ref[key])


def test_eval_cli_camliraft_matches_jax_evaluator(synthetic):
    """The flagship through the CLI on the CPU (ResNet-18 backbone to keep
    the JAX side's compile short): EPE2d, 1px, Fl and the 3D metrics match
    the JAX Evaluator on the same checkpoint to 1e-4."""
    root = synthetic[0].split("=", 1)[1]
    overrides = [o for o in synthetic if not o.startswith("ckpt.path=")]
    overrides.append("model.backbone.depth=18")
    cfgs = compose(REPO / "conf", testset="flyingthings3d_subset", model="camliraft",
                   base="evaluator.yaml", overrides=overrides)
    rng = np.random.RandomState(1)
    inputs = {"images": jnp.asarray(rng.randint(0, 255, (1, 128, 192, 6)).astype(np.float32)),
              "pcs": jnp.asarray(np.concatenate([rng.randn(1, 512, 3) + [0, 0, 10]] * 2, -1)
                                 .astype(np.float32)),
              "intrinsics": jnp.asarray([[1050.0, 479.5, 269.5]], jnp.float32)}
    model = jm_flagship.CamLiRAFT(cfgs=cfgs.model.to_dict(), train_mode=False)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), inputs)
    ckpt = Path(root) / "camliraft.npz"
    save_variables(ckpt, variables)
    overrides.append(f"ckpt.path={ckpt}")
    got = torch_eval.main(["protocol=things", "testset=flyingthings3d_subset",
                           "model=camliraft", "device=cpu"] + overrides)
    cfgs.ckpt.path = str(ckpt)
    ref = JaxEvaluator(cfgs, batch_size=torch_eval.BATCH_SIZE).run_things()
    assert {"EPE2d", "1px", "Fl", "EPE3d", "5cm", "10cm"} <= set(got)
    assert set(got) == set(ref)
    for key in got:
        assert abs(got[key] - ref[key]) <= 1e-4, (key, got[key], ref[key])


def test_eval_cli_raft_matches_jax_evaluator(synthetic):
    """RAFT through the CLI on the CPU (ResNet-18 backbone to keep the JAX
    side's compile short): EPE2d, 1px and Fl match the JAX Evaluator on the
    same checkpoint to 1e-4."""
    root = synthetic[0].split("=", 1)[1]
    overrides = [f"testset.root_dir={root}", "testset.n_points=512", "testset.n_workers=0",
                 "model.n_iters_eval=2", 'model.fast_inference="off"',
                 "model.backbone.depth=18"]
    cfgs = compose(REPO / "conf", testset="flyingthings3d_subset", model="raft",
                   base="evaluator.yaml", overrides=overrides)
    images = np.random.RandomState(2).randint(0, 255, (1, 128, 192, 6)).astype(np.float32)
    model = jm_raft.RAFT(cfgs=cfgs.model.to_dict(), train_mode=False)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), {"images": jnp.asarray(images)})
    ckpt = Path(root) / "raft.npz"
    save_variables(ckpt, variables)
    overrides.append(f"ckpt.path={ckpt}")
    got = torch_eval.main(["protocol=things", "testset=flyingthings3d_subset", "model=raft",
                           "device=cpu"] + overrides)
    cfgs.ckpt.path = str(ckpt)
    ref = JaxEvaluator(cfgs, batch_size=torch_eval.BATCH_SIZE).run_things()
    assert set(got) == set(ref) == {"EPE2d", "1px", "Fl"}
    for key in got:
        assert abs(got[key] - ref[key]) <= 1e-4, (key, got[key], ref[key])


def test_eval_cli_rejects_what_is_not_ported(synthetic):
    """Every eval protocol and model is ported, and so is the fast path:
    the CLI rejects an unknown protocol and a fast_inference value that is
    no mode (a bare `on` is YAML's true), and runs `model.fast_inference=
    "on"`, its metrics finite and its EPE within the JAX package's
    fast-vs-exact bound (0.02 m) of the exact run's."""
    with pytest.raises(SystemExit, match="unknown protocol"):
        torch_eval.main(["protocol=kitti_submission", "model=camliraft_l"])
    args = ["protocol=things", "testset=flyingthings3d_subset", "model=camliraft_l",
            "device=cpu"] + synthetic
    with pytest.raises(ValueError, match="auto|on|off"):
        torch_eval.main(args + ["model.fast_inference=on"])
    fast = torch_eval.main(args + ['model.fast_inference="on"'])
    exact = torch_eval.main(args)
    assert set(fast) == set(exact) and all(np.isfinite(v) for v in fast.values())
    assert fast != exact and abs(fast["EPE3d"] - exact["EPE3d"]) <= 0.02


@pytest.mark.parametrize("model", ["pwc", "camlipwc_l", "camlipwc"])
def test_eval_cli_pwc_family_matches_jax_evaluator(synthetic, model):
    """The PWC family through the CLI on the CPU: every metric of the
    things protocol within 1e-4 of the JAX Evaluator's on the same JAX
    variables (tests/test_torch_pwc.py::jax_variables)."""
    root = synthetic[0].split("=", 1)[1]
    overrides = [f"testset.root_dir={root}", "testset.n_points=512", "testset.n_workers=0"]
    if model != "pwc":
        overrides.append("model.n_samples_list=[256,128,64,32,16]")
    cfgs = compose(REPO / "conf", testset="flyingthings3d_subset", model=model,
                   base="evaluator.yaml", overrides=overrides)
    rng = np.random.RandomState(3)
    pcs = rng.randn(1, 512, 6).astype(np.float32)
    pcs[..., 2] = pcs[..., 5] = np.abs(pcs[..., 2]) * 10 + 5
    inputs = {"images": rng.randint(0, 255, (1, 128, 192, 6)).astype(np.float32),
              "pcs": pcs, "intrinsics": np.float32([[1050.0, 479.5, 269.5]])}
    module = {"pwc": jm_pwc.PWC, "camlipwc_l": jm_camlipwc_l.CamLiPWCL,
              "camlipwc": jm_camlipwc.CamLiPWC}[model]
    ckpt = Path(root) / f"{model}.npz"
    save_variables(ckpt, flat_to_tree(jax_variables(module, cfgs.model.to_dict(), inputs)))
    overrides.append(f"ckpt.path={ckpt}")
    got = torch_eval.main(["protocol=things", "testset=flyingthings3d_subset", f"model={model}",
                           "device=cpu"] + overrides)
    cfgs.ckpt.path = str(ckpt)
    ref = JaxEvaluator(cfgs, batch_size=torch_eval.BATCH_SIZE).run_things()
    keys_2d, keys_3d = {"EPE2d", "1px", "Fl"}, {"EPE3d", "5cm", "10cm"}
    assert set(got) == set(ref)
    assert keys_2d <= set(got) if model != "camlipwc_l" else not keys_2d & set(got)
    assert keys_3d <= set(got) if model != "pwc" else not keys_3d & set(got)
    for key in got:
        assert abs(got[key] - ref[key]) <= 1e-4, (key, got[key], ref[key])


def test_eval_cli_needs_a_card_unless_told_cpu(synthetic):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    args = ["protocol=things", "testset=flyingthings3d_subset", "model=camliraft_l"]
    with pytest.raises(RuntimeError, match="device=cpu"):
        torch_eval.main(args + synthetic)
    with pytest.raises(ValueError, match="cuda|cpu"):
        torch_eval.main(args + synthetic + ["device=tpu"])


def test_evaluator_turns_tf32_off():
    """Building an Evaluator runs the exact path's setup: with TF32 on, cuDNN
    convolutions and matrix products would keep ~3 digits on a card."""
    from camliflow_torch.runtime.evaluator import Evaluator as TorchEvaluator

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        TorchEvaluator(torch.nn.Linear(2, 2), "cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import camliflow_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(camliflow_torch.__path__, 'camliflow_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15  # every module was imported
    # imports inside functions run only when called, so read every source too
    banned = {"jax", "flax", "optax", "camliflow_tpu", "tools"}
    sources = sorted((REPO / "camliflow_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert len(sources) >= 25 and not found, found


def test_port_imports_opencv_only_inside_refinement():
    """The port reads and writes its PNGs with its own codec: OpenCV is
    imported only inside postprocess/refine.py's functions (its solvers)
    and data/augmentation.py's (the hue shift through HSV and the scale's
    resize, as the JAX augmentation computes them), never at a module's
    top, and chip_smoke.py does not import it."""
    sources = sorted((REPO / "camliflow_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]

    def imports_cv2(node):
        if isinstance(node, ast.Import):
            return any(alias.name.split(".")[0] == "cv2" for alias in node.names)
        return isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "cv2"

    where = []
    for path in sources:
        tree = ast.parse(path.read_text(), str(path))
        inside = {id(node) for fn in ast.walk(tree)
                  if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for node in ast.walk(fn)}
        where += [(path.relative_to(REPO).as_posix(), id(node) in inside)
                  for node in ast.walk(tree) if imports_cv2(node)]
    assert len(sources) >= 30
    assert where and all(in_function for _, in_function in where), where
    assert {path for path, _ in where} == {"camliflow_torch/postprocess/refine.py",
                                           "camliflow_torch/data/augmentation.py"}, where


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    runs = [REPO]
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs.append(alone)  # a directory holding chip_smoke.py and nothing else
    for cwd in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        for line in proc.stdout.splitlines():
            assert not (line.startswith("{") and json.loads(line).get("ok")), line
