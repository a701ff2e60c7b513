"""PyTorch port: each CUDA kernel against its plain version, on the card.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
without a card. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.) Tolerances: KNN
and corr3d selected squared distances rtol = atol = 1e-4; corr3d costs
exactly the pyramid at the kernel's own indices; FPS indices identical;
interpolation atol 1e-5; the 2D and 3D update kernels max |kernel - plain|
<= 1e-4 * (1 + max |plain|) (f32 on both sides, summation order only).
"""

import numpy as np
import pytest
import torch

from camliflow_torch.ops import corr3d, fps, interp, knn, update2d, update3d
from camliflow_torch.ops.geometry import squared_distance
from camliflow_torch.ops.ids import make_parallel_camera_info, persp2paral
from camliflow_torch.utils.torch_setup import setup_torch

SEL_TOL = dict(rtol=1e-4, atol=1e-4)
PERSP = {"sensor_h": 540, "sensor_w": 960, "f": 1050.0, "cx": 479.5, "cy": 269.5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    setup_torch()  # the plain versions' convolutions in full f32, not TF32
    return torch.device("cuda")


def ids_clouds(seed, device, batch=2, n=512):
    """Gaussian clouds in IDS (parallel) coordinates, as the model sees them."""
    rng = np.random.RandomState(seed)
    pc = rng.randn(batch, n, 3).astype(np.float32)
    pc[..., 2] = np.abs(pc[..., 2]) * 10 + 5
    paral = make_parallel_camera_info(540, 960)
    return persp2paral(torch.from_numpy(pc), PERSP, paral).to(device).contiguous()


def assert_same_selection(query, support, got, ref):
    d = squared_distance(query, support)
    torch.testing.assert_close(torch.gather(d, 2, got.long()),
                               torch.gather(d, 2, ref.long()), **SEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 5, 16, 32])
def test_knn_kernel_matches_plain(cuda, k):
    pts, q = ids_clouds(20, cuda), ids_clouds(21, cuda, n=1500)[:, :300].contiguous()
    before = knn.k_nearest_neighbor.launches
    got = knn.k_nearest_neighbor(pts, q, k)
    assert knn.k_nearest_neighbor.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (2, 300, k)
    assert_same_selection(q, pts, got, knn.k_nearest_neighbor_plain(pts, q, k))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 1000, 8192])
def test_fps_kernel_matches_plain(cuda, n):
    pc = ids_clouds(22, cuda, n=n)
    got = fps.furthest_point_sampling(pc, n // 2)
    assert torch.equal(got, fps.furthest_point_sampling_plain(pc, n // 2))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3, 7])
def test_interp_kernel_matches_plain(cuda, channels):
    src, q = ids_clouds(23, cuda), ids_clouds(24, cuda, n=1300)
    feats = torch.randn(2, 512, channels, device=cuda)
    torch.testing.assert_close(interp.knn_interpolation(src, feats, q, 3),
                               interp.knn_interpolation_plain(src, feats, q, 3),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(256, 128, 64, 32), (300, 50)])
def test_corr3d_kernel_matches_plain(cuda, sizes):
    xyz1 = ids_clouds(25, cuda, 1, 256)
    xyz2 = ids_clouds(26, cuda, 1, 320)
    pyramid = torch.randn(1, 256, sum(sizes), device=cuda)
    idx, cost = corr3d.correlation3d_knn(xyz1, xyz2, pyramid, sizes, 16)
    ref, ref_cost = corr3d.correlation3d_knn_plain(xyz1, xyz2, pyramid, sizes, 16)
    for level, m in enumerate(sizes):
        sl = slice(level * 16, (level + 1) * 16)
        assert int(idx[..., sl].max()) < m
        assert_same_selection(xyz1, xyz2[:, :m], idx[..., sl], ref[..., sl])
    columns = idx.long() + corr3d.level_offsets(sizes, 16, cuda)
    assert torch.equal(cost, torch.gather(pyramid, 2, columns))
    if torch.equal(idx, ref):
        assert torch.equal(cost, ref_cost)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    pts = ids_clouds(27, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        knn.k_nearest_neighbor(pts, pts.transpose(0, 1).contiguous().transpose(0, 1), 3)
    with pytest.raises(TypeError):
        knn.k_nearest_neighbor(pts.double(), pts.double(), 3)
    with pytest.raises(ValueError, match="k"):
        knn.k_nearest_neighbor(pts, pts, 33)
    with pytest.raises(ValueError, match="CUDA"):
        interp.knn_interpolation(pts, pts, pts.cpu(), 3)
    with pytest.raises(ValueError, match="N <="):
        fps.furthest_point_sampling(ids_clouds(28, cuda, 1, 8193), 10)
    with pytest.raises(ValueError, match="descending"):
        corr3d.correlation3d_knn(pts[:1], pts[:1], torch.zeros(1, 512, 768, device=cuda),
                                 (256, 512), 16)


@pytest.mark.cuda
def test_knn_kernel_takes_2d_points(cuda):
    """CLFM's pixel-grid KNN: 2-D points reach the kernel with z = 0, so the
    selected distances equal the plain version's exactly."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    uv = (torch.rand(2, 300, 2, generator=gen, device=cuda) * 20).contiguous()
    ys, xs = torch.meshgrid(torch.arange(12.0, device=cuda), torch.arange(21.0, device=cuda),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(2, -1, -1).contiguous()
    got = knn.k_nearest_neighbor(uv, grid, 1)
    ref = knn.k_nearest_neighbor_plain(uv, grid, 1)
    d = squared_distance(grid, uv)
    assert torch.equal(torch.gather(d, 2, got.long()), torch.gather(d, 2, ref.long()))


def update_blocks(device, seed):
    from camliflow_torch.models.raft import FlowHead2D, GRU2D, MotionEncoder2D

    torch.manual_seed(seed)
    return [m.to(device) for m in (MotionEncoder2D(corr_channels=36), GRU2D(), FlowHead2D())]


def assert_conv_close(got, ref):
    """f32 on both sides: the residue is summation order."""
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * (1 + float(ref.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9), (1, 1, 5)])
def test_motion_encoder_2d_kernel_matches_plain(cuda, shape):
    encoder, _, _ = update_blocks(cuda, 30)
    flow = 2 * torch.randn(*shape, 2, device=cuda)
    corr = torch.randn(*shape, 36, device=cuda)
    with torch.inference_mode():
        params = update2d.prepare_motion_encoder_params(encoder)
        before = update2d.motion_encoder_2d.launches
        got = update2d.motion_encoder_2d(flow, corr, params)
        assert update2d.motion_encoder_2d.launches == before + 1
        ref = update2d.motion_encoder_2d_plain(flow, corr, params)
    assert got.shape == (*shape, 128)
    assert torch.equal(got[..., -2:], flow)
    assert_conv_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9), (1, 6, 1)])
def test_gru_flowhead_2d_kernel_matches_plain(cuda, shape):
    _, gru, head = update_blocks(cuda, 31)
    h = torch.tanh(torch.randn(*shape, 128, device=cuda))
    x2d = torch.relu(torch.randn(*shape, 128, device=cuda))
    motion = torch.randn(*shape, 128, device=cuda)
    with torch.inference_mode():
        params = update2d.prepare_gru_flowhead_params(gru, head)
        before = update2d.gru_flowhead_2d.launches
        h_got, d_got = update2d.gru_flowhead_2d(h, x2d, motion, params)
        assert update2d.gru_flowhead_2d.launches == before + 1
        h_ref, d_ref = update2d.gru_flowhead_2d_plain(h, x2d, motion, params)
    assert h_got.shape == (*shape, 128) and d_got.shape == (*shape, 2)
    assert_conv_close(h_got, h_ref)
    assert_conv_close(d_got, d_ref)


@pytest.mark.cuda
def test_update2d_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    encoder, gru, head = update_blocks(cuda, 32)
    flow = torch.randn(1, 6, 8, 2, device=cuda)
    corr = torch.randn(1, 6, 8, 36, device=cuda)
    with torch.inference_mode():
        params = update2d.prepare_motion_encoder_params(encoder)
        with pytest.raises(ValueError, match="contiguous"):
            update2d.motion_encoder_2d(flow, corr.transpose(1, 2).contiguous().transpose(1, 2),
                                       params)
        with pytest.raises(ValueError, match="shape"):
            update2d.motion_encoder_2d(flow, corr[..., :30].contiguous(), params)
        cpu_params = update2d.prepare_motion_encoder_params(encoder.cpu())
        with pytest.raises(ValueError, match="params"):
            update2d.motion_encoder_2d(flow, corr, cpu_params)
        gf = update2d.prepare_gru_flowhead_params(gru, head)
        h = torch.randn(1, 6, 8, 128, device=cuda)
        with pytest.raises(ValueError, match="fit"):
            update2d.gru_flowhead_2d(h, h, h[..., :64].contiguous(), gf)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9), (1, 6, 1), (1, 5, 13)])
def test_update_2d_kernel_matches_plain(cuda, shape):
    """The whole RAFT iteration in one cooperative launch: batch 2, a map
    one pixel wide, pixel counts that are not a multiple of 64."""
    encoder, gru, head = update_blocks(cuda, 33)
    flow = 2 * torch.randn(*shape, 2, device=cuda)
    corr = torch.randn(*shape, 36, device=cuda)
    h = torch.tanh(torch.randn(*shape, 128, device=cuda))
    x2d = torch.relu(torch.randn(*shape, 128, device=cuda))
    with torch.inference_mode():
        me, gf = update2d.prepare_update_2d_params(encoder, gru, head)
        before = update2d.update_2d.launches
        h_got, d_got = update2d.update_2d(h, x2d, flow, corr, me, gf)
        assert update2d.update_2d.launches == before + 1
        h_ref, d_ref = update2d.update_2d_plain(h, x2d, flow, corr, me, gf)
    assert h_got.shape == (*shape, 128) and d_got.shape == (*shape, 2)
    assert_conv_close(h_got, h_ref)
    assert_conv_close(d_got, d_ref)


@pytest.mark.cuda
def test_update_2d_raises_on_what_the_kernel_does_not_take(cuda):
    encoder, gru, head = update_blocks(cuda, 34)
    shape = (1, 6, 8)
    flow = torch.randn(*shape, 2, device=cuda)
    corr = torch.randn(*shape, 36, device=cuda)
    h = torch.randn(*shape, 128, device=cuda)
    with torch.inference_mode():
        me, gf = update2d.prepare_update_2d_params(encoder, gru, head)
        with pytest.raises(TypeError):
            update2d.update_2d(h.double(), h, flow, corr, me, gf)
        with pytest.raises(ValueError, match="contiguous"):
            update2d.update_2d(h, h.transpose(1, 2).contiguous().transpose(1, 2), flow, corr,
                               me, gf)
        with pytest.raises(ValueError, match="CUDA"):
            update2d.update_2d(h, h, flow.cpu(), corr, me, gf)
        with pytest.raises(RuntimeError, match="update_2d: CUDA error"):
            update2d.update_2d(h, h, flow, corr, me, gf, grid=1 << 20)  # never co-resident


def update3d_case(device, seed, batch, n):
    """Blocks, a cloud, its k=32 neighbours (some repeated) and the hoisted
    weights."""
    from camliflow_torch.models.camliraft_l import FlowHead3D, GRU3D, MotionEncoder3D

    torch.manual_seed(seed)
    blocks = [m.to(device) for m in (MotionEncoder3D(), GRU3D(), FlowHead3D())]
    xyz = ids_clouds(seed, device, batch, n)
    idx = knn.k_nearest_neighbor(xyz, xyz, 32)
    idx[:, ::7, 3] = idx[:, ::7, 0]  # duplicate neighbours
    encoder, gru, head = blocks
    dw_me = encoder.precompute_weights(xyz, idx)
    dw_gf = {**gru.precompute_weights(xyz, idx), **head.precompute_weights(xyz, idx)}
    return blocks, idx.contiguous(), dw_me, dw_gf


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(1, 2048), (2, 100), (1, 70)])
def test_motion_encoder_3d_kernel_matches_plain(cuda, batch, n):
    with torch.inference_mode():
        (encoder, _, _), idx, dw, _ = update3d_case(cuda, 35, batch, n)
        flow = 0.1 * torch.randn(batch, n, 3, device=cuda)
        corr = torch.randn(batch, n, 128, device=cuda)
        params = update3d.prepare_motion_encoder_3d_params(encoder)
        before = update3d.motion_encoder_3d.launches
        got = update3d.motion_encoder_3d(flow, corr, idx, dw, params)
        assert update3d.motion_encoder_3d.launches == before + 1
        ref = update3d.motion_encoder_3d_plain(flow, corr, idx, dw, params)
    assert got.shape == (batch, n, 128)
    assert torch.equal(got[..., -3:], flow)
    assert_conv_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(1, 2048), (2, 100), (1, 70)])
def test_gru_flowhead_3d_kernel_matches_plain(cuda, batch, n):
    with torch.inference_mode():
        (_, gru, head), idx, _, dw = update3d_case(cuda, 36, batch, n)
        h = torch.tanh(torch.randn(batch, n, 128, device=cuda))
        x3d = torch.relu(torch.randn(batch, n, 128, device=cuda))
        motion = torch.randn(batch, n, 128, device=cuda)
        params = update3d.prepare_gru_flowhead_3d_params(gru, head)
        before = update3d.gru_flowhead_3d.launches
        h_got, d_got = update3d.gru_flowhead_3d(h, x3d, motion, idx, dw, params)
        assert update3d.gru_flowhead_3d.launches == before + 1
        h_ref, d_ref = update3d.gru_flowhead_3d_plain(h, x3d, motion, idx, dw, params)
    assert h_got.shape == (batch, n, 128) and d_got.shape == (batch, n, 3)
    assert_conv_close(h_got, h_ref)
    assert_conv_close(d_got, d_ref)


@pytest.mark.cuda
def test_update3d_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with torch.inference_mode():
        (encoder, gru, head), idx, dw_me, dw_gf = update3d_case(cuda, 37, 1, 100)
        flow = torch.randn(1, 100, 3, device=cuda)
        corr = torch.randn(1, 100, 128, device=cuda)
        me = update3d.prepare_motion_encoder_3d_params(encoder)
        with pytest.raises(TypeError):
            update3d.motion_encoder_3d(flow.double(), corr, idx, dw_me, me)
        with pytest.raises(TypeError):
            update3d.motion_encoder_3d(flow, corr, idx.long(), dw_me, me)
        with pytest.raises(ValueError, match="contiguous"):
            update3d.motion_encoder_3d(flow, corr.transpose(1, 2).contiguous().transpose(1, 2),
                                       idx, dw_me, me)
        with pytest.raises(ValueError, match="CUDA"):
            update3d.motion_encoder_3d(flow, corr, idx.cpu(), dw_me, me)
        h = torch.randn(1, 100, 128, device=cuda)
        gf = update3d.prepare_gru_flowhead_3d_params(gru, head)
        with pytest.raises(ValueError, match="CUDA|lies on"):
            update3d.gru_flowhead_3d(h, h, h, idx, {**dw_gf, "conv_q": dw_gf["conv_q"].cpu()}, gf)
        with pytest.raises(ValueError, match="fit"):
            update3d.gru_flowhead_3d(h, h, h[..., :64].contiguous(), idx, dw_gf, gf)
        with pytest.raises(ValueError, match="neighbours"):
            update3d.gru_flowhead_3d(h, h, h, idx[..., :16].contiguous(), dw_gf, gf)
