"""PyTorch port: the serving entry points against the JAX package, on the CPU.

- the Evaluator's one-batch lookahead against a synchronous loop over
  `forward`, and `run_things(save_results=True)`'s files against the JAX
  Evaluator's on the same outputs, and through the eval CLI;
- the KITTI submission (`camliflow_torch.kitti_submission`) against the JAX
  SubmissionWriter on tests/test_submission.py's configuration (depth-18
  backbone, 1 iteration, 256 points, padded to 128x192, 2 synthetic frames
  from tools/make_synthetic_kitti.py), with the JAX weights carried across;
  the densification against JAX's knn_interpolation;
- `postprocess.mod_flow` and `camliflow_torch.refine_background` against the
  JAX ones, bit for bit;
- each entry point's device handling.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camliflow_tpu.data import io as jio
from camliflow_tpu.models import camliraft as jm_flagship
from camliflow_tpu.models import camliraft_l as jm
from camliflow_tpu.ops import geometry as jgeo
from camliflow_tpu.runtime.checkpoint import save_variables
from camliflow_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from camliflow_tpu.runtime.submission import SubmissionWriter as JaxSubmissionWriter
from camliflow_tpu.utils.config import compose as jax_compose
from camliflow_torch import eval as torch_eval
from camliflow_torch import kitti_submission, refine_background
from camliflow_torch.data import io as tio
from camliflow_torch.data.datasets import KITTITest, batches
from camliflow_torch.models.camliraft_l import CamLiRAFTL
from camliflow_torch.ops import knn
from camliflow_torch.postprocess import mod_flow
from camliflow_torch.runtime import submission as tsub
from camliflow_torch.runtime.checkpoint import random_weights
from camliflow_torch.runtime.evaluator import Evaluator

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 2


def load_script(name):
    """One of the repo's JAX entry-point scripts as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- the lookahead and saved results --------------------------------------

def point_batches(n_batches=3, bs=2, n=512, seed=0):
    """FlyingThings3D-like batches of clouds with a 3D target."""
    out = []
    for i in range(n_batches):
        rng = np.random.RandomState(seed + i)
        pc1 = rng.randn(bs, n, 3).astype(np.float32)
        pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
        flow = (0.1 * rng.randn(bs, n, 3)).astype(np.float32)
        out.append({"index": np.arange(i * bs, (i + 1) * bs), "pcs": np.concatenate(
            [pc1, pc1 + flow], -1), "flow_3d": flow,
            "intrinsics": np.tile(np.float32([1050, 479.5, 269.5]), (bs, 1))})
    return out


@pytest.fixture(scope="module")
def small_evaluator():
    model = CamLiRAFTL({"n_iters_eval": 2, "ids": {"enabled": True},
                        "n_samples_list": [256, 128, 64, 32, 16]})
    random_weights(model, seed=3)
    return Evaluator(model, "cpu")


def test_lookahead_equals_the_synchronous_loop(small_evaluator):
    """`batches` (one batch ahead) hands out each batch with the outputs a
    synchronous `forward` gives it, bit for bit, and run_things' metrics
    through it equal those through a synchronous loop."""
    ev, data = small_evaluator, point_batches()
    ahead = list(ev.batches(data))
    assert [pair[0] for pair in ahead] == data
    for (_, got), batch in zip(ahead, data):
        want = ev.forward(batch)
        assert "flow_3d" in got and set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    metrics = ev.run_things(data)
    sync = Evaluator(ev.model, "cpu")
    sync.batches = lambda loader: ((batch, sync.forward(batch)) for batch in loader)
    assert sync.run_things(data) == metrics
    assert len(sync.request_ms) == len(data)


def image_samples(n=5, h=12, w=16, points=64):
    """Samples with 2D and 3D targets for the saved-results comparison."""
    samples = []
    for i in range(n):
        rng = np.random.RandomState(30 + i)
        flow_2d = np.concatenate([3 * rng.randn(h, w, 2), np.ones((h, w, 1))], -1)
        pc1 = rng.randn(points, 3) + [0, 0, 10]
        samples.append({"index": 7 * i + 3, "flow_2d": flow_2d.astype(np.float32),
                        "pcs": np.concatenate([pc1, pc1], -1).astype(np.float32),
                        "flow_3d": (0.1 * rng.randn(points, 3)).astype(np.float32)})
    return samples


class Samples:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def fixed_outputs(batch):
    """Targets plus noise, some 2D flows past the +-500 px clip."""
    rng = np.random.RandomState(int(batch["index"][0]))
    flow_2d = batch["flow_2d"][..., :2] + 2 * rng.randn(*batch["flow_2d"][..., :2].shape)
    flow_2d[:, :2, :3] = 650 * np.sign(rng.randn(*flow_2d[:, :2, :3].shape))
    return {"flow_2d": flow_2d.astype(np.float32),
            "flow_3d": (batch["flow_3d"] + 0.05 * rng.randn(*batch["flow_3d"].shape))
            .astype(np.float32)}


def test_saved_results_match_the_jax_evaluator(tmp_path):
    """run_things(save_results=True) writes the files the JAX Evaluator
    writes on the same outputs: flow_2d PNGs equal decoded, flow_3d .npy
    equal; and the same metrics."""
    samples = image_samples()
    cfgs = jax_compose(REPO / "conf", model="camliraft_l", testset="flyingthings3d_subset",
                       base="evaluator.yaml", overrides=["testset.n_workers=0"])
    ref_ev = JaxEvaluator(cfgs, variables={"params": {}}, batch_size=2,
                          dataset=Samples(samples))
    ref_ev._forward_device = fixed_outputs
    ref = ref_ev.run_things(save_results=True, save_dir=str(tmp_path / "jax"))
    ev = Evaluator(torch.nn.Identity(), "cpu")
    ev.enqueue = fixed_outputs  # the "enqueued" forward is the outputs themselves
    ev.fetch = lambda outputs: outputs
    got = ev.run_things(batches(Samples(samples), 2), save_results=True,
                        save_dir=str(tmp_path / "port"))
    assert set(got) == set(ref)
    for key in ref:
        assert abs(got[key] - ref[key]) <= 1e-12 * abs(ref[key]), key
    for sample in samples:
        name = "%07d" % sample["index"]
        for loader in (tio.load_flow_png, jio.load_flow_png):
            a = loader(tmp_path / "port" / "flow_2d" / f"{name}.png")
            b = loader(tmp_path / "jax" / "flow_2d" / f"{name}.png")
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        assert np.abs(a[0]).max() == 500.0  # clipped
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "flow_3d" / f"{name}.npy"),
                                      np.load(tmp_path / "jax" / "flow_3d" / f"{name}.npy"))


@pytest.fixture(scope="module")
def ft3d(tmp_path_factory):
    """A FlyingThings3D-format set and a JAX CamLiRAFT-L checkpoint."""
    root = tmp_path_factory.mktemp("ft3d")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
                    "--out", str(root), "--n", "3", "--n_points", "600"],
                   check=True, capture_output=True, timeout=120)
    cfgs = {"n_iters_eval": 2, "ids": {"enabled": True}, "fast_inference": "off",
            "n_samples_list": [256, 128, 64, 32, 16]}
    pcs = np.random.RandomState(0).randn(1, 512, 6).astype(np.float32) + [0, 0, 10] * 2
    variables = jax.jit(jm.CamLiRAFTL(cfgs=cfgs, train_mode=False).init)(
        jax.random.PRNGKey(0), {"pcs": jnp.asarray(pcs),
                                "intrinsics": jnp.asarray([[1050.0, 479.5, 269.5]])})
    save_variables(root / "camliraft_l.npz", variables)
    return [f"testset.root_dir={root}", "testset.n_points=512", "testset.n_workers=0",
            "model.n_iters_eval=2", 'model.fast_inference="off"',
            "model.n_samples_list=[256,128,64,32,16]", f"ckpt.path={root / 'camliraft_l.npz'}"]


def test_eval_cli_saves_results_as_jax(ft3d, tmp_path, monkeypatch):
    """`python -m camliflow_torch.eval ... save_results=true` writes
    prediction/things/flow_3d/%07d.npy within 1e-4 m of eval.py's."""
    monkeypatch.chdir(tmp_path)
    torch_eval.main(["protocol=things", "testset=flyingthings3d_subset",
                     "model=camliraft_l", "device=cpu", "save_results=true"] + ft3d)
    cfgs = jax_compose(REPO / "conf", testset="flyingthings3d_subset", model="camliraft_l",
                       base="evaluator.yaml", overrides=ft3d)
    JaxEvaluator(cfgs, batch_size=torch_eval.BATCH_SIZE).run_things(
        save_results=True, save_dir="jax")
    names = sorted(p.name for p in (tmp_path / "prediction" / "things" / "flow_3d").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "flow_3d").iterdir())
    assert len(names) == 3
    for name in names:
        got = np.load(tmp_path / "prediction" / "things" / "flow_3d" / name)
        ref = np.load(tmp_path / "jax" / "flow_3d" / name)
        assert got.shape == ref.shape == (512, 3)
        np.testing.assert_allclose(got, ref, atol=1e-4)


# --- the KITTI submission --------------------------------------------------

SUBMISSION = [  # tests/test_submission.py's configuration, as overrides
    "model.batch_size=2", "model.backbone.depth=18", "model.n_iters_eval=1",
    "model.fuse_fnet=false", "model.fuse_cnet=false", "model.fuse_corr=false",
    "model.fuse_motion=false", "model.fuse_hidden=false", 'model.fast_inference="off"',
    "model.n_samples_list=[128,64,32,16]", "testset.n_points=256", "testset.n_workers=0",
    "testset.zero_padding.target_h=128", "testset.zero_padding.target_w=192",
]


@pytest.fixture(scope="module")
def submissions(tmp_path_factory):
    """The JAX and the port's submissions of the same 2 synthetic frames with
    the same weights: (kitti root, jax dir, port dir, overrides)."""
    root = tmp_path_factory.mktemp("kitti")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_kitti.py"),
                    "--out", str(root), "--n", str(N_FRAMES), "--height", "120",
                    "--width", "184"], check=True, capture_output=True, timeout=120)
    overrides = SUBMISSION + [f"testset.root_dir={root}"]
    cfgs = jax_compose(REPO / "conf", testset="kitti", model="camliraft",
                       base="evaluator.yaml", overrides=overrides)
    from camliflow_tpu.data.datasets import KITTITest as JaxKITTITest

    sample = JaxKITTITest(cfgs.testset)[0]
    inputs = {k: jnp.asarray(v)[None] for k, v in sample.items() if isinstance(v, np.ndarray)}
    model = jm_flagship.CamLiRAFT(cfgs=cfgs.model.to_dict(), train_mode=False)
    variables = model.init(jax.random.PRNGKey(0), inputs)
    ckpt = root / "camliraft.npz"
    save_variables(ckpt, variables)
    overrides.append(f"ckpt.path={ckpt}")
    dirs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxKITTITest, "__len__", lambda self: N_FRAMES)
        mp.setattr(KITTITest, "__len__", lambda self: N_FRAMES)
        for side in ("jax", "port"):
            dirs[side] = tmp_path_factory.mktemp(side)
            mp.chdir(dirs[side])
            if side == "jax":
                JaxSubmissionWriter(cfgs, variables=variables).run()
            else:
                kitti_submission.main(["model=camliraft", "device=cpu"] + overrides)
    return root, dirs["jax"], dirs["port"], overrides


def frame_names():
    return ["%06d_10.png" % i for i in range(N_FRAMES)]


def test_submission_writes_the_jax_files(submissions):
    """disp_0 equal; flow_initial within 1/64 px + 1e-3; occ equal but where
    the two flows put a pixel on either side of the frame's edge."""
    _, jax_dir, port_dir, _ = submissions
    for sub in ("disp_0", "flow_initial", "disp_1_initial", "occ"):
        assert sorted(p.name for p in (port_dir / "submission" / "testing" / sub).iterdir()) \
            == frame_names(), sub
    for name in frame_names():
        def both(sub, loader):
            return (loader(port_dir / "submission" / "testing" / sub / name),
                    loader(jax_dir / "submission" / "testing" / sub / name))

        (got, got_mask), (ref, ref_mask) = both("disp_0", tio.load_disp_png)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_mask, ref_mask)
        (flow, valid), (flow_ref, valid_ref) = both("flow_initial", tio.load_flow_png)
        assert flow.shape == (120, 184, 2) and valid.all() and valid_ref.all()
        np.testing.assert_allclose(flow, flow_ref, rtol=0, atol=1 / 64 + 1e-3)
        occ, occ_ref = both("occ", tio.load_grey_png)
        assert set(np.unique(occ)) <= {0, 255}
        h, w = occ.shape
        warp = flow_ref + np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
        edge = np.minimum(np.minimum(np.abs(warp[..., 0]), np.abs(warp[..., 0] - w)),
                          np.minimum(np.abs(warp[..., 1]), np.abs(warp[..., 1] - h)))
        assert (edge[occ != occ_ref] <= 2 / 64 + 2e-3).all()


def test_submission_densifies_as_jax(submissions):
    """disp_1_initial within 1/256 px + 1e-3 of the JAX file wherever both
    densifications pick the same 3 supports; where the JAX one (expanded
    |q|^2 - 2q.p + |p|^2 distances) picks others, the port's are nearer in
    float64, and such pixels are rare. The densification itself: the port's
    knn_interpolation against JAX's on the frame's own inputs."""
    root, jax_dir, port_dir, overrides = submissions
    cfgs = kitti_submission.configure(["model=camliraft", "device=cpu"] + overrides)[0]
    dataset = KITTITest(cfgs.testset)
    for i, name in enumerate(frame_names()):
        sample = dataset[i]
        f, cx, cy = (float(v) for v in sample["intrinsics"])
        disp1 = tio.load_disp_png(root / "testing" / "disp_ganet" / name)[0]
        queries = tio.disp2pc(disp1, baseline=0.54, f=f, cx=cx, cy=cy).reshape(-1, 3)
        queries = queries.astype(np.float32)
        support = sample["pcs"][:, :3]
        idx = knn.k_nearest_neighbor_plain(torch.from_numpy(support)[None],
                                           torch.from_numpy(queries)[None], 3)[0].numpy()
        idx_ref = np.asarray(jgeo.k_nearest_neighbor(jnp.asarray(support)[None],
                                                     jnp.asarray(queries)[None], 3))[0]
        same = (np.sort(idx, -1) == np.sort(idx_ref, -1)).all(-1)
        assert same.mean() > 0.99
        d64 = ((queries[:, None].astype(np.float64) - support[None]) ** 2).sum(-1)
        picked = np.take_along_axis(d64, idx, 1).sum(-1)
        picked_ref = np.take_along_axis(d64, idx_ref, 1).sum(-1)
        assert (picked <= picked_ref)[~same].all()

        flow = (0.05 * np.random.RandomState(i).randn(*support.shape)).astype(np.float32)
        got = tsub.densify(support, flow, queries, torch.device("cpu"))
        ref = np.asarray(jgeo.knn_interpolation(jnp.asarray(support)[None],
                                                jnp.asarray(flow)[None],
                                                jnp.asarray(queries)[None]))[0]
        np.testing.assert_allclose(got[same], ref[same], atol=1e-5)

        disp_c = tio.load_disp_png(port_dir / "submission" / "testing" / "disp_1_initial"
                                   / name)[0].reshape(-1)
        disp_ref = tio.load_disp_png(jax_dir / "submission" / "testing" / "disp_1_initial"
                                     / name)[0].reshape(-1)
        np.testing.assert_allclose(disp_c[same], disp_ref[same], rtol=0, atol=1 / 256 + 1e-3)
        assert ((disp_c > 0) == (disp_ref > 0)).all()


def test_densify_on_the_cpu_goes_in_query_chunks(monkeypatch):
    """On the CPU the densification runs the plain version over chunks of
    queries (a frame's 465,750 at once would need ≈ 15 GB of distances): the
    chunks, a last short one included, give one call's values bit for bit."""
    from camliflow_torch.ops import interp

    rng = np.random.RandomState(0)
    support = (10 * rng.rand(64, 3)).astype(np.float32)
    flow = rng.randn(64, 3).astype(np.float32)
    queries = (10 * rng.rand(1000, 3)).astype(np.float32)
    seen = []
    plain = interp.knn_interpolation

    def counted(xyz, feats, query, k):
        seen.append(query.shape[1])
        return plain(xyz, feats, query, k)

    monkeypatch.setattr(tsub, "CPU_QUERY_CHUNK", 96)
    monkeypatch.setattr(tsub, "knn_interpolation", counted)
    got = tsub.densify(support, flow, queries, torch.device("cpu"))
    ref = interp.knn_interpolation_plain(*(torch.from_numpy(a)[None]
                                           for a in (support, flow, queries)), 3)[0]
    assert seen == [96] * 10 + [40]
    np.testing.assert_array_equal(got, ref.numpy())


def test_mod_flow_matches_jax_on_a_rigid_scene():
    """tests/test_submission.py::test_mod_flow_rigid_scene's scene: the
    port's mod_flow gives the JAX one's flow and disparity bit for bit."""
    from camliflow_tpu.postprocess import mod_flow as jax_mod_flow

    h, w = 96, 128
    f, cx, cy = 100.0, (w - 1) / 2, (h - 1) / 2
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    depth = 5.0 + 10.0 * ys / h
    P = np.stack([(xs - cx) * depth / f, (ys - cy) * depth / f, depth], -1)
    P2 = P + np.array([1.2, 0.2, 1.5], np.float32)
    x2 = cx + f * P2[..., 0] / P2[..., 2]
    y2 = cy + f * P2[..., 1] / P2[..., 2]
    flow_gt = np.stack([x2 - xs, y2 - ys], -1).astype(np.float32)
    disp = (0.54 * f / depth).astype(np.float32)
    disp_change = (0.54 * f / P2[..., 2]).astype(np.float32)
    flow_noisy = flow_gt + np.random.RandomState(0).randn(h, w, 2).astype(np.float32) * 0.5
    ones = np.ones((h, w), bool)
    results = []
    for fn in (mod_flow, jax_mod_flow):
        np.random.seed(0)
        results.append(fn(ones, disp, disp_change.copy(), flow_noisy, K, K, bl=0.54,
                          occ_mask=ones))
    (flow, disp_c), (flow_ref, disp_ref) = results
    assert not np.array_equal(flow, flow_noisy)  # the rigid path ran
    np.testing.assert_array_equal(flow, flow_ref)
    np.testing.assert_array_equal(disp_c, disp_ref)


def test_refine_background_matches_jax(submissions, tmp_path, monkeypatch):
    """The port's refine_background (2 worker processes) over the port's
    submission with tools/make_synthetic_kitti.py's semantic masks writes
    the JAX script's (serial) files bit for bit."""
    import shutil

    root, _, port_dir, _ = submissions
    runs = {}
    for side in ("jax", "port"):
        runs[side] = tmp_path / side
        shutil.copytree(port_dir / "submission", runs[side] / "submission")
    jax_script = load_script("refine_background")
    common = ["--dataset_dir", str(root), "--n_frames", str(N_FRAMES)]
    monkeypatch.chdir(runs["jax"])
    jax_script.main(refine_background.parse_args(common + ["--workers", "1"]))
    monkeypatch.chdir(runs["port"])
    refine_background.main(refine_background.parse_args(
        common + ["--workers", "2"]))
    for sub, loader in (("flow", tio.load_flow_png), ("disp_1", tio.load_disp_png)):
        for name in frame_names():
            got = loader(runs["port"] / "submission" / "testing" / sub / name)
            ref = loader(runs["jax"] / "submission" / "testing" / sub / name)
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])


# --- device handling -------------------------------------------------------

def test_serving_entry_points_need_a_card_unless_told_cpu(submissions, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, _, _, overrides = submissions
    monkeypatch.chdir(tmp_path)
    args = ["model=camliraft"] + overrides
    with pytest.raises(RuntimeError, match="device=cpu"):
        kitti_submission.main(args)
    with pytest.raises(ValueError, match="cuda|cpu"):
        kitti_submission.main(args + ["device=tpu"])
    assert not (tmp_path / "submission").exists()
