"""PyTorch port: each CUDA kernel against its plain version, on the card.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
without a card. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.) Tolerances: KNN
indices identical, ties included; FPS indices identical; interpolation
atol 1e-5, and bit for bit its own arithmetic on the plain selection
(FPS also on duplicated points, and the 3D GRU +
flow head's NaN positions too); the 2D and 3D update kernels, the Correlation3D
tail and CLFM max |kernel - plain| <= 1e-4 * (1 + max |plain|) (f32 on both
sides: summation order only, and for the tensor-core tile of the 2D chain
and CLFM the 3xTF32 split's ~2^-22 relative residue per product); the
k-major gather, the probe's cases, the PointConvDW tail, and corr3d's
indices and costs bit for bit.
"""

import numpy as np
import pytest
import torch

from camliflow_torch.ops import clfm, corr3d, fps, gather, interp, knn, update2d, update3d
from camliflow_torch.ops.geometry import gather_points, squared_distance
from camliflow_torch.ops.ids import make_parallel_camera_info, persp2paral
from camliflow_torch.utils.torch_setup import setup_torch

PERSP = {"sensor_h": 540, "sensor_w": 960, "f": 1050.0, "cx": 479.5, "cy": 269.5}


@pytest.fixture(autouse=True)
def forward_only():
    """The fused kernels' packers and wrappers are forward-only: they refuse
    weights or inputs that require grad while grad mode is on (a gradient
    would be dropped). These tests exercise the eval path, so grad mode is
    off, as it is under the Evaluator's inference_mode."""
    with torch.no_grad():
        yield


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 5, 16, 32])
def test_knn_kernel_matches_plain(cuda, k):
    pts, q = ids_clouds(20, cuda), ids_clouds(21, cuda, n=1500)[:, :300].contiguous()
    before = knn.k_nearest_neighbor.launches
    got = knn.k_nearest_neighbor(pts, q, k)
    assert knn.k_nearest_neighbor.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (2, 300, k)
    assert torch.equal(got, knn.k_nearest_neighbor_plain(pts, q, k))


def tie(support, query):
    """Exact ties: every 7th point repeats an earlier one (across slices),
    and every third query sits on a point."""
    m = support[:, 1::7].shape[1]
    support[:, 1::7] = support[:, : 7 * m : 7].clone()
    n = query[:, ::3].shape[1]
    query[:, ::3] = support[:, torch.arange(n, device=support.device) * 5 % support.shape[1]]


# every (batch, queries, candidates, k) the main paths give #1 (tests/test_torch_knn.py)
KNN_CALLS = [(2, 4096, 8192, 16), (2, 2048, 4096, 16), (1, 1024, 2048, 3), (1, 512, 1024, 3),
             (1, 256, 512, 3), (1, 2048, 2048, 32), (1, 8192, 2048, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("batch,n,m,k", KNN_CALLS + [(2, 100, 40, 32), (1, 300, 32, 32)])
def test_knn_kernel_at_main_path_shapes(cuda, batch, n, m, k, ties):
    """Indices bit for bit the plain version's, ties included, at every
    main-path shape (and M = 40, M = k = 32), and two runs bit for bit."""
    support = ids_clouds(40 + m, cuda, batch, m)
    query = ids_clouds(41 + n, cuda, batch, n)
    if ties:
        tie(support, query)
    got = knn.k_nearest_neighbor(support, query, k)
    assert torch.equal(got, knn.k_nearest_neighbor_plain(support, query, k))
    assert torch.equal(knn.k_nearest_neighbor(support, query, k), got)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,m,k", [(1, 64, 8192, 16), (1, 1, 8192, 3),
                                         (1, 100, 8192, 32), (2, 40, 9000, 16)])
def test_selection_kernels_on_few_queries_over_many_candidates(cuda, batch, n, m, k):
    """A few queries over thousands of candidates, where the plan's slices
    stop at a block's 32 warps: KNN indices bit for bit the plain
    version's, ties included; the interpolation within 1e-5 of its plain
    version, and with k = 1 on each support's index as its feature, the
    plain KNN's selection."""
    support, query = ids_clouds(47, cuda, batch, m), ids_clouds(48, cuda, batch, n)
    tie(support, query)
    assert torch.equal(knn.k_nearest_neighbor(support, query, k),
                       knn.k_nearest_neighbor_plain(support, query, k))
    feats = torch.randn(batch, m, 3, device=cuda)
    torch.testing.assert_close(interp.knn_interpolation(support, feats, query, k),
                               interp.knn_interpolation_plain(support, feats, query, k),
                               rtol=0, atol=1e-5)
    index = torch.arange(float(m), device=cuda)[None, :, None].expand(batch, -1, -1).contiguous()
    picked = interp.knn_interpolation(support, index, query, 1)[..., 0].int()
    assert torch.equal(picked, knn.k_nearest_neighbor_plain(support, query, 1)[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 1000, 8192])
def test_fps_kernel_matches_plain(cuda, n):
    pc = ids_clouds(22, cuda, n=n)
    got = fps.furthest_point_sampling(pc, n // 2)
    assert torch.equal(got, fps.furthest_point_sampling_plain(pc, n // 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 8192])
def test_fps_kernel_on_duplicated_points(cuda, n):
    """Every fifth point a copy of the point half a cloud away, in another
    block of the cluster: exact ties across blocks; indices identical."""
    pc = ids_clouds(23, cuda, n=n)
    pc[:, 1::5] = pc[:, (torch.arange(1, n, 5, device=cuda) + n // 2) % n]
    got = fps.furthest_point_sampling(pc, n // 4)
    assert torch.equal(got, fps.furthest_point_sampling_plain(pc, n // 4))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,slices,queries,group", [
    (40, 32, 5, 4, 1), (40, 32, 5, 4, 2), (40, 32, 32, 1, 1), (100, 16, 25, 1, 1),
    (515, 3, 9, 3, 1), (515, 8, 3, 8, 2), (9000, 16, 5, 6, 2),
])
def test_knn_kernel_on_plans_of_its_own(cuda, m, k, slices, queries, group):
    """Plans the wrapper does not choose, through the C entry point: slices
    shorter than k (8 candidates for k = 32: their lists padded with
    (inf, 0)), empty slices (32 slices of 40 candidates), 1 or 2 queries a
    warp, and more candidates than a block stages at once (9000); indices
    bit for bit the plain version's, ties included."""
    from camliflow_torch.csrc.build import launch

    support, query = ids_clouds(45, cuda, 2, m), ids_clouds(46, cuda, 2, 150)
    tie(support, query)
    out = torch.empty(2, 150, k, dtype=torch.int32, device=cuda)
    launch("camli_knn", support.data_ptr(), query.data_ptr(), out.data_ptr(), 2, m, 150, k,
           slices, queries, group)
    assert torch.equal(out, knn.k_nearest_neighbor_plain(support, query, k))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3, 7])
def test_interp_kernel_matches_plain(cuda, channels):
    src, q = ids_clouds(23, cuda), ids_clouds(24, cuda, n=1300)
    feats = torch.randn(2, 512, channels, device=cuda)
    torch.testing.assert_close(interp.knn_interpolation(src, feats, q, 3),
                               interp.knn_interpolation_plain(src, feats, q, 3),
                               rtol=0, atol=1e-5)


def interp_in_kernel_order(support, feats, query, idx):
    """csrc/interp.cu's arithmetic as torch ops on given indices, one
    rounding per operation: sqrt, clamp, reciprocal, the total in list
    order, the division, each channel's sum in list order."""
    diff = gather_points(support, idx) - query[:, :, None, :]
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                      + diff[..., 2] * diff[..., 2]).clamp_min(1e-8)
    w = 1.0 / dist
    total = torch.zeros_like(w[..., 0])
    for j in range(idx.shape[-1]):
        total = total + w[..., j]
    w = w / total[..., None]
    f = gather_points(feats, idx)
    acc = torch.zeros_like(f[:, :, 0])
    for j in range(idx.shape[-1]):
        acc = acc + f[:, :, j] * w[..., j : j + 1]
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [2048, 8192])  # the backwarp and CamLiRAFT-L's upsample
def test_interp_kernel_at_main_path_shapes(cuda, n, ties):
    """[1, n] <- [1, 2048], C = 3, k = 3: within 1e-5 of the plain version,
    and bit for bit the kernel's arithmetic on the plain version's
    selection (so the kernel selected what the plain version selects); with
    k = 1 and a feature that holds each support's index, the output is the
    selected index itself."""
    support, query = ids_clouds(42, cuda, 1, 2048), ids_clouds(43, cuda, 1, n)
    if ties:
        tie(support, query)
    feats = 0.05 * torch.randn(1, 2048, 3, device=cuda)
    before = interp.knn_interpolation.launches
    got = interp.knn_interpolation(support, feats, query, 3)
    assert interp.knn_interpolation.launches == before + 1
    torch.testing.assert_close(got, interp.knn_interpolation_plain(support, feats, query, 3),
                               rtol=0, atol=1e-5)
    idx = knn.k_nearest_neighbor_plain(support, query, 3)
    assert torch.equal(got, interp_in_kernel_order(support, feats, query, idx))
    index = torch.arange(2048.0, device=cuda)[None, :, None].contiguous()
    picked = interp.knn_interpolation(support, index, query, 1)
    assert torch.equal(picked[..., 0].int(), knn.k_nearest_neighbor_plain(support, query, 1)[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,k,ties", [
    ((2048, 1024, 512, 256), 16, False),  # the main paths' shape, 2048 queries
    ((2048, 1024, 512, 256), 16, True),
    ((256, 128, 64, 32), 1, True),
    ((256, 128, 64, 32), 16, False),
    ((256, 128, 64, 32), 32, True),
    ((300, 50), 1, False),
    ((300, 50), 16, True),
    ((300, 50), 32, False),
])
def test_corr3d_kernel_matches_plain(cuda, sizes, k, ties):
    """Indices and costs bit for bit, ties included: with `ties`, every 7th
    point repeats an earlier one, across slices and levels, and queries sit
    on points."""
    n = 2048 if sizes[0] == 2048 else 256
    xyz2 = ids_clouds(26, cuda, 1, max(320, sizes[0]))
    xyz1 = ids_clouds(25, cuda, 1, n)
    if ties:
        m = xyz2[:, 1::7].shape[1]
        xyz2[:, 1::7] = xyz2[:, : 7 * m : 7].clone()
        xyz1[:, ::3] = xyz2[:, 5 : 5 + xyz1[:, ::3].shape[1]]
    pyramid = torch.randn(1, n, sum(sizes), device=cuda)
    before = corr3d.correlation3d_knn.launches
    idx, cost = corr3d.correlation3d_knn(xyz1, xyz2, pyramid, sizes, k)
    assert corr3d.correlation3d_knn.launches == before + 1
    ref, ref_cost = corr3d.correlation3d_knn_plain(xyz1, xyz2, pyramid, sizes, k)
    for level, m in enumerate(sizes):
        assert int(idx[..., level * k:(level + 1) * k].max()) < m
    assert torch.equal(idx, ref)
    assert torch.equal(cost, ref_cost)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,k,ties,batch", [
    ((2048, 1024, 512, 256), 16, False, 2),  # the training path's shape, batch 2
    ((2048, 1024, 512, 256), 16, True, 2),
    ((256, 128, 64, 32), 32, True, 1),
    ((300, 50), 1, True, 3),
])
def test_corr3d_index_only_kernel_matches_the_full_form(cuda, sizes, k, ties, batch):
    """The index-only form (`with_cost=False`, training's): no pyramid read,
    no costs, the full form's and the plain version's indices bit for bit,
    ties included; counted on `index_launches`."""
    n = 2048 if sizes[0] == 2048 else 256
    xyz2 = ids_clouds(36, cuda, batch, max(320, sizes[0]))
    xyz1 = ids_clouds(35, cuda, batch, n)
    if ties:
        m = xyz2[:, 1::7].shape[1]
        xyz2[:, 1::7] = xyz2[:, : 7 * m : 7].clone()
        xyz1[:, ::3] = xyz2[:, 5 : 5 + xyz1[:, ::3].shape[1]]
    pyramid = torch.randn(batch, n, sum(sizes), device=cuda)
    before = (corr3d.correlation3d_knn.launches, corr3d.correlation3d_knn.index_launches)
    idx, cost = corr3d.correlation3d_knn(xyz1, xyz2, None, sizes, k, with_cost=False)
    after = (corr3d.correlation3d_knn.launches, corr3d.correlation3d_knn.index_launches)
    assert cost is None and after == (before[0], before[1] + 1)
    assert torch.equal(idx, corr3d.correlation3d_knn(xyz1, xyz2, pyramid, sizes, k)[0])
    ref, none = corr3d.correlation3d_knn_plain(xyz1, xyz2, None, sizes, k, with_cost=False)
    assert none is None and torch.equal(idx, ref)


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
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_knn_kernel_on_the_clfm_pixel_grid(cuda):
    """CLFM's cache at the main shape: the 68 x 120 pixel grid of 1/8
    feature maps against 2048 projected points of each frame, k = 1, with
    points on pixel centres (exact ties between points and between their
    copies); indices bit for bit, reruns too."""
    gen = torch.Generator(device=cuda).manual_seed(44)
    uv = torch.rand(2, 2048, 2, generator=gen, device=cuda)
    uv = uv * torch.tensor([119.0, 67.0], device=cuda)
    uv[:, ::4] = uv[:, ::4].round()
    uv[:, 1::9] = uv[:, : uv[:, 1::9].shape[1]].clone()
    uv = uv.contiguous()
    ys, xs = torch.meshgrid(torch.arange(68.0, device=cuda), torch.arange(120.0, device=cuda),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(2, -1, -1).contiguous()
    got = knn.k_nearest_neighbor(uv, grid, 1)
    assert torch.equal(got, knn.k_nearest_neighbor_plain(uv, grid, 1))
    assert torch.equal(knn.k_nearest_neighbor(uv, grid, 1), got)


def update_blocks(device, seed):
    from camliflow_torch.models.raft import FlowHead2D, GRU2D, MotionEncoder2D

    torch.manual_seed(seed)
    return [m.to(device) for m in (MotionEncoder2D(corr_channels=36), GRU2D(), FlowHead2D())]


def assert_conv_close(got, ref):
    """f32 on both sides: the residue is summation order."""
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * (1 + float(ref.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9), (1, 1, 5), (1, 5, 13)])
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
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9), (1, 6, 1), (1, 5, 13)])
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


def hidden_case(device, seed, shape):
    """#8's halves as the fuse_hidden path calls them: random GRU2D and
    FlowHead2D packed once, h in (-1, 1), x2d >= 0."""
    _, gru, head = update_blocks(device, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.tanh(torch.randn(*shape, 128, generator=gen, device=device))
    x2d = torch.relu(torch.randn(*shape, 128, generator=gen, device=device))
    motion = torch.randn(*shape, 128, generator=gen, device=device)
    with torch.inference_mode():
        return (h, x2d, motion, update2d.prepare_gru_params(gru),
                update2d.prepare_flow_head_params(head))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9), (1, 6, 1), (1, 5, 13)])
def test_gru_2d_kernel_matches_plain(cuda, shape):
    """#8's GRU half: batch 2, a map one pixel wide, 65 pixels (one past the
    64-pixel tile)."""
    h, x2d, motion, gp, _ = hidden_case(cuda, 58, shape)
    with torch.inference_mode():
        before = update2d.gru_2d.launches
        got = update2d.gru_2d(h, x2d, motion, gp)
        assert update2d.gru_2d.launches == before + 1
        ref = update2d.gru_2d_plain(h, torch.cat([x2d, motion], dim=-1), gp)
    assert got.shape == (*shape, 128)
    assert_conv_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9), (1, 6, 1), (1, 5, 13)])
def test_flow_head_2d_kernel_matches_plain(cuda, shape):
    """#8's flow-head half; its last conv (256 -> 2) splits the reduction
    over a block's warps and sums the parts in a fixed order, so two runs
    give the same bits."""
    h, _, _, _, hp = hidden_case(cuda, 59, shape)
    with torch.inference_mode():
        before = update2d.flow_head_2d.launches
        got = update2d.flow_head_2d(h, hp)
        again = update2d.flow_head_2d(h, hp)
        assert update2d.flow_head_2d.launches == before + 2
        ref = update2d.flow_head_2d_plain(h, hp)
    assert got.shape == (*shape, 2)
    assert_conv_close(got, ref)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_gru_flowhead_2d_is_its_halves_bit_for_bit(cuda):
    """One entry point runs the two halves in sequence: the same launches,
    the same bits, run after run."""
    _, gru, head = update_blocks(cuda, 60)
    h, x2d, motion, gp, hp = hidden_case(cuda, 60, (1, 68, 120))
    with torch.inference_mode():
        gf = update2d.prepare_gru_flowhead_params(gru, head)
        h_fused, d_fused = update2d.gru_flowhead_2d(h, x2d, motion, gf)
        h_again, d_again = update2d.gru_flowhead_2d(h, x2d, motion, gf)
        h_half = update2d.gru_2d(h, x2d, motion, gp)
        d_half = update2d.flow_head_2d(h_half, hp)
    assert torch.equal(h_fused, h_again) and torch.equal(d_fused, d_again)
    assert torch.equal(h_fused, h_half) and torch.equal(d_fused, d_half)


@pytest.mark.cuda
def test_tensor_core_wrappers_raise_on_what_the_tile_does_not_take(cuda):
    """The tile copies 4 channels (16 bytes) at a time: a channel count that
    is not a multiple of 4, or a view 4 bytes into its storage, raises."""
    torch.manual_seed(61)
    from camliflow_torch.models.raft import MotionEncoder2D

    encoder = MotionEncoder2D(corr_channels=30).to(cuda)
    h, x2d, motion, gp, hp = hidden_case(cuda, 61, (1, 6, 8))
    with torch.inference_mode():
        me = update2d.prepare_motion_encoder_params(encoder)
        flow = torch.randn(1, 6, 8, 2, device=cuda)
        with pytest.raises(ValueError, match="multiple of 4"):
            update2d.motion_encoder_2d(flow, torch.randn(1, 6, 8, 30, device=cuda), me)
        shifted = torch.empty(h.numel() + 1, device=cuda)[1:].view(h.shape)
        shifted.copy_(h)
        assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
        with pytest.raises(ValueError, match="16-byte"):
            update2d.gru_2d(shifted, x2d, motion, gp)
        with pytest.raises(ValueError, match="16-byte"):
            update2d.flow_head_2d(shifted, hp)
        with pytest.raises(ValueError, match="16-byte"):
            update2d.gru_2d(h, x2d, shifted, gp)  # the third input of the concat
        with pytest.raises(ValueError, match="tf32 planes"):
            update2d.flow_head_2d(h, {k: v._replace(hi=None) for k, v in hp.items()})


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
    """The whole RAFT iteration from one entry point: batch 2, a map one
    pixel wide, pixel counts that are not a multiple of 64."""
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
@pytest.mark.parametrize("shape", [(1, 68, 120), (2, 7, 9)])
def test_update_2d_is_the_chain_bit_for_bit(cuda, shape):
    """The iteration's entry point runs the motion encoder's and the GRU +
    flow head's launches on one scratch buffer, so h' and delta are those of
    motion_encoder_2d then gru_flowhead_2d, bit for bit, run after run."""
    encoder, gru, head = update_blocks(cuda, 35)
    gen = torch.Generator(device=cuda).manual_seed(35)
    flow = 2 * torch.randn(*shape, 2, generator=gen, device=cuda)
    corr = torch.randn(*shape, 36, generator=gen, device=cuda)
    h = torch.tanh(torch.randn(*shape, 128, generator=gen, device=cuda))
    x2d = torch.relu(torch.randn(*shape, 128, generator=gen, device=cuda))
    with torch.inference_mode():
        me, gf = update2d.prepare_update_2d_params(encoder, gru, head)
        h_fused, d_fused = update2d.update_2d(h, x2d, flow, corr, me, gf)
        h_again, d_again = update2d.update_2d(h, x2d, flow, corr, me, gf)
        motion = update2d.motion_encoder_2d(flow, corr, me)
        h_chain, d_chain = update2d.gru_flowhead_2d(h, x2d, motion, gf)
    assert torch.equal(h_fused, h_chain) and torch.equal(d_fused, d_chain)
    assert torch.equal(h_fused, h_again) and torch.equal(d_fused, d_again)


@pytest.mark.cuda
def test_update_2d_raises_where_the_tensor_core_tile_would_fault(cuda):
    """The tile copies 4 channels (16 bytes) at a time: an x2d view 4 bytes
    into its storage, or a corr of 30 channels, raises before the launch."""
    torch.manual_seed(36)
    from camliflow_torch.models.raft import FlowHead2D, GRU2D, MotionEncoder2D

    shape = (1, 6, 8)
    blocks = [m.to(cuda) for m in (MotionEncoder2D(corr_channels=30), GRU2D(), FlowHead2D())]
    flow = torch.randn(*shape, 2, device=cuda)
    h = torch.randn(*shape, 128, device=cuda)
    with torch.inference_mode():
        me30, gf = update2d.prepare_update_2d_params(*blocks)
        before = update2d.update_2d.launches
        with pytest.raises(ValueError, match="multiple of 4"):
            update2d.update_2d(h, h, flow, torch.randn(*shape, 30, device=cuda), me30, gf)
        encoder, _, _ = update_blocks(cuda, 36)
        me = update2d.prepare_motion_encoder_params(encoder)
        shifted = torch.empty(h.numel() + 1, device=cuda)[1:].view(h.shape)
        shifted.copy_(h)
        assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
        with pytest.raises(ValueError, match="16-byte"):
            update2d.update_2d(h, shifted, flow, torch.randn(*shape, 36, device=cuda), me, gf)
        assert update2d.update_2d.launches == before


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
        with pytest.raises(ValueError, match="shape"):
            update2d.update_2d(h, h, flow[..., :1].contiguous(), corr, me, gf)


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
@pytest.mark.parametrize("batch,n", [(1, 2048), (2, 100), (1, 70), (8, 2048)])
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


def motion_encoder_3d_case(device, seed, batch, n):
    (encoder, _, _), idx, dw, _ = update3d_case(device, seed, batch, n)
    flow = 0.1 * torch.randn(batch, n, 3, device=device)
    corr = torch.randn(batch, n, 128, device=device)
    return (flow, corr, idx), dw, update3d.prepare_motion_encoder_3d_params(encoder)


@pytest.mark.cuda
def test_motion_encoder_3d_propagates_nan_as_plain(cuda):
    """One NaN in the merge conv's hoisted weights: it lands where the plain
    version's does (one point's channel), and the rest agrees."""
    with torch.inference_mode():
        inputs, dw, params = motion_encoder_3d_case(cuda, 48, 1, 2048)
        bad = {**dw, "conv": update3d.padded_rows(dw["conv"].clone())}
        bad["conv"][0, 9, 1, 2] = float("nan")
        ref = update3d.motion_encoder_3d_plain(*inputs, bad, params)
        assert torch.isnan(ref).any()
        got = update3d.motion_encoder_3d(*inputs, bad, params)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert_conv_close(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.cuda
def test_motion_encoder_3d_and_dw_max_rerun_bit_identical(cuda):
    """No atomics in either: two runs give the same bits."""
    with torch.inference_mode():
        inputs, dw, params = motion_encoder_3d_case(cuda, 49, 2, 2048)
        first = update3d.motion_encoder_3d(*inputs, dw, params)
        assert torch.equal(update3d.motion_encoder_3d(*inputs, dw, params), first)
    gen = torch.Generator(device=cuda).manual_seed(50)
    for k, channels in ((4, 256), (4, 128), (32, 128), (32, 64), (16, 125)):
        table = torch.randn(1, 2048, channels, generator=gen, device=cuda)
        idx = torch.randint(0, 2048, (1, 2048, 32), generator=gen, device=cuda,
                            dtype=torch.int32)
        weights = torch.randn(1, 2048, k, channels, generator=gen, device=cuda)
        first = update3d.dw_max(table, idx, weights)
        assert torch.equal(update3d.dw_max(table, idx, weights), first)


def gru_flowhead_3d_case(device, seed, batch, n):
    (_, gru, head), idx, _, dw = update3d_case(device, seed, batch, n)
    h = torch.tanh(torch.randn(batch, n, 128, device=device))
    x3d = torch.relu(torch.randn(batch, n, 128, device=device))
    motion = torch.randn(batch, n, 128, device=device)
    return (h, x3d, motion, idx), dw, update3d.prepare_gru_flowhead_3d_params(gru, head)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(1, 2048), (2, 2048), (8, 2048), (2, 100), (1, 70)])
def test_gru_flowhead_3d_kernel_matches_plain(cuda, batch, n):
    """At the loop's 2048 points, at the eval CLI's batch of 8, and ragged."""
    with torch.inference_mode():
        inputs, dw, params = gru_flowhead_3d_case(cuda, 36, batch, n)
        before = update3d.gru_flowhead_3d.launches
        h_got, d_got = update3d.gru_flowhead_3d(*inputs, dw, params)
        assert update3d.gru_flowhead_3d.launches == before + 1
        h_ref, d_ref = update3d.gru_flowhead_3d_plain(*inputs, dw, params)
    assert h_got.shape == (batch, n, 128) and d_got.shape == (batch, n, 3)
    assert_conv_close(h_got, h_ref)
    assert_conv_close(d_got, d_ref)


@pytest.mark.cuda
def test_gru_flowhead_3d_propagates_nan_as_plain(cuda):
    """A copy of the hoisted weights with one NaN in q's and one in conv1's:
    the NaNs land where the plain version's do (h' at one point; delta at
    every point that has the poisoned one among its conv2 neighbours), and
    the rest agrees."""
    with torch.inference_mode():
        inputs, dw, params = gru_flowhead_3d_case(cuda, 38, 1, 2048)
        bad = {**dw, "conv_q": dw["conv_q"].clone(), "conv1": dw["conv1"].clone()}
        bad["conv_q"][0, 9, 1, 2] = float("nan")
        bad["conv1"][0, 5, 3, 7] = float("nan")
        h_ref, d_ref = update3d.gru_flowhead_3d_plain(*inputs, bad, params)
        assert torch.isnan(h_ref).any() and torch.isnan(d_ref).any()
        h_got, d_got = update3d.gru_flowhead_3d(*inputs, bad, params)
    for got, ref in ((h_got, h_ref), (d_got, d_ref)):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert_conv_close(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.cuda
def test_fps_and_gru_flowhead_3d_rerun_bit_identical(cuda):
    """No atomics in either: two runs give the same bits."""
    pc = ids_clouds(24, cuda, n=8192)
    assert torch.equal(fps.furthest_point_sampling(pc, 4096),
                       fps.furthest_point_sampling(pc, 4096))
    with torch.inference_mode():
        inputs, dw, params = gru_flowhead_3d_case(cuda, 39, 2, 2048)
        first = update3d.gru_flowhead_3d(*inputs, dw, params)
        again = update3d.gru_flowhead_3d(*inputs, dw, params)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


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
        # the c1 and merge tails read their weights in 16-byte loads, the
        # merge conv's rows 128 floats apart, and corr feeds the tensor-core
        # tile
        def shifted(t, row=None):  # 4 bytes past a 16-byte boundary
            row = row or t.shape[-1]
            base = torch.empty(t[..., :1].numel() * row + 1, device=cuda)[1:]
            base = base.view(*t.shape[:-1], row)
            base[..., :t.shape[-1]] = t
            return base[..., :t.shape[-1]]

        for key, row in (("conv_c1", None), ("conv", 128)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                update3d.motion_encoder_3d(flow, corr, idx, {**dw_me, key: shifted(dw_me[key], row)},
                                           me)
        with pytest.raises(ValueError, match="16-byte aligned"):
            update3d.motion_encoder_3d(flow, shifted(corr), idx, dw_me, me)
        with pytest.raises(ValueError, match="128 floats apart"):
            update3d.motion_encoder_3d(flow, corr, idx, {**dw_me, "conv": dw_me["conv"].contiguous()},
                                       me)
        # f1's and f2's tails read 4 bytes at a time: their weights may sit anywhere
        moved = {**dw_me, "conv_f1": shifted(dw_me["conv_f1"]),
                 "conv_f2": shifted(dw_me["conv_f2"])}
        assert torch.equal(update3d.motion_encoder_3d(flow, corr, idx, moved, me),
                           update3d.motion_encoder_3d(flow, corr, idx, dw_me, me))
        h = torch.randn(1, 100, 128, device=cuda)
        gf = update3d.prepare_gru_flowhead_3d_params(gru, head)
        with pytest.raises(ValueError, match="CUDA|lies on"):
            update3d.gru_flowhead_3d(h, h, h, idx, {**dw_gf, "conv_q": dw_gf["conv_q"].cpu()}, gf)
        with pytest.raises(ValueError, match="fit"):
            update3d.gru_flowhead_3d(h, h, h[..., :64].contiguous(), idx, dw_gf, gf)
        with pytest.raises(ValueError, match="neighbours"):
            update3d.gru_flowhead_3d(h, h, h, idx[..., :16].contiguous(), dw_gf, gf)
        narrow = update3d.prepare_gru_flowhead_3d_params(gru, head)
        narrow["conv2"] = narrow["conv2"]._replace(cout=62)
        narrow["fc"] = narrow["fc"]._replace(cin=62)
        dw_narrow = {**dw_gf, "conv2": dw_gf["conv2"][..., :62].contiguous()}
        with pytest.raises(ValueError, match="multiples of 4"):  # 16-byte loads of conv2's
            update3d.gru_flowhead_3d(h, h, h, idx, dw_narrow, narrow)
        shifted = torch.empty(dw_gf["conv1"].numel() + 1, device=cuda)[1:]
        shifted = shifted.view(dw_gf["conv1"].shape).copy_(dw_gf["conv1"])
        with pytest.raises(ValueError, match="16-byte aligned"):
            update3d.gru_flowhead_3d(h, h, h, idx, {**dw_gf, "conv1": shifted}, gf)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,channels", [(torch.float32, 3), (torch.float32, 99),
                                            (torch.float32, 324), (torch.int32, 131),
                                            (torch.bfloat16, 3), (torch.bfloat16, 99),
                                            (torch.int8, 5)])
@pytest.mark.parametrize("k", [1, 16])
def test_gather_kmajor_kernel_matches_plain(cuda, dtype, channels, k):
    """Rows of 3, 99 and 324 elements (not 16-byte aligned), batch 2, 77
    queries (not a multiple of the block), duplicate indices: bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    data = (50 * torch.randn(2, 300, channels, generator=gen, device=cuda)).to(dtype)
    idx = torch.randint(0, 300, (2, 77, k), generator=gen, device=cuda, dtype=torch.int32)
    idx[:, ::3, -1] = idx[:, ::3, 0]
    before = gather.gather_points_kmajor.launches
    got = gather.gather_points_kmajor(data, idx)
    assert gather.gather_points_kmajor.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, k, 77, channels)
    assert torch.equal(got, gather.gather_points_kmajor_plain(data, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,channels,offset", [(torch.bfloat16, 2, 1), (torch.int8, 4, 1),
                                                   (torch.int8, 8, 2)])
def test_gather_kmajor_kernel_takes_views_at_any_offset(cuda, dtype, channels, offset):
    """A contiguous view may start at any element of its storage: rows of 4
    or 8 bytes at a 1- or 2-byte offset are copied in words that fit the
    address, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(39)
    base = (50 * torch.randn(2 * 300 * channels + offset, generator=gen, device=cuda)).to(dtype)
    data = base[offset:].view(2, 300, channels)
    assert data.data_ptr() % 4 != 0
    idx = torch.randint(0, 300, (2, 77, 16), generator=gen, device=cuda, dtype=torch.int32)
    got = gather.gather_points_kmajor(data, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_points_kmajor_plain(data, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("case", gather.PROBE_CASES, ids=[c[0] for c in gather.PROBE_CASES])
def test_probe_gather_cases(cuda, case):
    """tools/probe_gather_matrix.py's cases through the k-major gather."""
    data, idx, finish, want = gather.probe_case(case, torch.Generator(device=cuda).manual_seed(41),
                                                cuda)
    got = finish(gather.gather_points_kmajor(data, idx))
    assert got.dtype == want.dtype and torch.equal(got, want)


def strided_view(base_numel, offset, shape, dtype, device, seed):
    """A contiguous [B, N, C] view of `dtype` starting `offset` elements into
    its storage (so at an odd address for offset 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = (50 * torch.randn(base_numel + offset, generator=gen, device=device)).to(dtype)
    return base[offset:offset + int(np.prod(shape))].view(*shape)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,m,k,channels,dtype,offset", [
    (1, 300, 77, 3, 3, torch.float32, 0),  # unaligned slabs: M * 12 bytes % 16 != 0
    (2, 300, 77, 16, 99, torch.float32, 0),  # M % T != 0 (T = 32)
    (2, 300, 77, 16, 131, torch.float32, 0),  # T = 16
    (2, 300, 77, 5, 5, torch.bfloat16, 0),  # bf16 rows of 10 bytes
    (2, 300, 77, 5, 7, torch.int8, 0),  # int8 rows of 7 bytes
    (2, 300, 77, 4, 99, torch.float32, 1),  # a view at an odd element
    (1, 300, 77, 3, 5, torch.bfloat16, 1),
    (1, 300, 77, 3, 7, torch.int8, 3),
    (2, 300, 77, 1, 3, torch.float32, 0),  # k = 1, xyz
    (1, 2048, 8192, 3, 3, torch.float32, 0),  # the upsample: k = 3, xyz
    (8, 4096, 2048, 16, 131, torch.float32, 0),  # B = 8, encoder level 1
    (8, 300, 77, 16, 3, torch.float32, 0),  # B = 8, xyz
    (1, 40, 9, 2, 5000, torch.float32, 0),  # rows wider than a buffer: pieces
    (2, 64, 20, 3, 4, torch.float32, 0),  # 16-byte rows: 16-byte words
])
def test_gather_kmajor_staged_slabs(cuda, batch, n, m, k, channels, dtype, offset):
    """The staged slab copy at the shapes that take its edge paths (an
    unaligned slab head and tail, a last tile of M % T rows, 1- and 2-byte
    words, a view at an odd element, rows copied in pieces) and at the main
    path's: bit for bit the plain version, one launch."""
    data = strided_view(batch * n * channels, offset, (batch, n, channels), dtype, cuda, 43)
    gen = torch.Generator(device=cuda).manual_seed(44)
    idx = torch.randint(0, n, (batch, m, k), generator=gen, device=cuda, dtype=torch.int32)
    idx[:, ::3, -1] = idx[:, ::3, 0]
    before = gather.gather_points_kmajor.launches
    got = gather.gather_points_kmajor(data, idx)
    torch.cuda.synchronize()
    assert gather.gather_points_kmajor.launches == before + 1
    assert got.dtype == dtype and got.shape == (batch, k, m, channels)
    assert torch.equal(got, gather.gather_points_kmajor_plain(data, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("channels,plan", [(9, (16, 36)), (9, (10, 36)), (9, (1, 16)),
                                           (3, (1024, 12)), (9, (7, 36)), (99, (0, 0)),
                                           (3, (48, 12))])
def test_gather_kmajor_kernel_on_plans_of_its_own(cuda, channels, plan):
    """Plans gather_plan does not pick for these shapes (T not a multiple of
    16, a row in 16-byte pieces, T above M, 12-byte rows staged, a wide row
    a word a thread): bit for bit the plain version."""
    from camliflow_torch.csrc.build import launch

    data = strided_view(2 * 80 * channels, 0, (2, 80, channels), torch.float32, cuda, 45)
    idx = torch.randint(0, 80, (2, 45, 7), device=cuda, dtype=torch.int32)
    out = torch.empty(2, 7, 45, channels, device=cuda)
    launch("camli_gather_kmajor", data.data_ptr(), idx.data_ptr(), out.data_ptr(), 2, 80, 45,
           7, 4 * channels, *plan)
    torch.cuda.synchronize()
    assert torch.equal(out, gather.gather_points_kmajor_plain(data, idx))


@pytest.mark.cuda
def test_gather_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    data = torch.randn(2, 50, 7, device=cuda)
    idx = torch.randint(0, 50, (2, 9, 4), device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather.gather_points_kmajor(data.double(), idx)
    with pytest.raises(TypeError):
        gather.gather_points_kmajor(data, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_points_kmajor(data.transpose(0, 1).contiguous().transpose(0, 1), idx)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_points_kmajor(data, idx.cpu())
    with pytest.raises(ValueError, match="shape"):
        gather.gather_points_kmajor(data, idx[:1].contiguous())


def tail_case(device, seed, batch, n, level_sizes, k, out_channels):
    """A Correlation3D with random weights and kernel #4's selection."""
    from camliflow_torch.models.camliraft_l import Correlation3D

    torch.manual_seed(seed)
    module = Correlation3D(n_levels=len(level_sizes), out_channels=out_channels, k=k).to(device)
    xyz1 = ids_clouds(seed, device, batch, n)
    xyz2 = ids_clouds(seed + 1, device, batch, level_sizes[0])
    pyramid = torch.randn(batch, n, sum(level_sizes), device=device)
    idx, cost = corr3d.correlation3d_knn(xyz1, xyz2, pyramid, level_sizes, k)
    return corr3d.prepare_corr3d_tail_params(module), xyz1, xyz2, idx, cost


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,level_sizes,k,out_channels", [
    (1, 2048, (2048, 1024, 512, 256), 16, 128),  # the main path: 64 KB of merge weights
    (2, 100, (96, 48, 24), 8, 128),  # the JAX tests' k and levels, batch 2
    (2, 77, (96, 48, 24), 8, 64),  # a hidden width of 16, N not a multiple of 8
    (1, 50, (64, 48, 40, 32, 24, 16, 12, 8), 8, 128),  # 8 levels: 128 KB
    (1, 300, (96, 48, 24, 12), 6, 128),  # k = 6, not a power of two
    # 8 levels of 6 taps: a level straddles two chunks of the kernel's taps
    (2, 77, (64, 56, 48, 40, 32, 24, 16, 8), 6, 128),
])
def test_corr3d_tail_kernel_matches_plain(cuda, batch, n, level_sizes, k, out_channels):
    with torch.inference_mode():
        params, xyz1, xyz2, idx, cost = tail_case(cuda, 42, batch, n, level_sizes, k,
                                                  out_channels)
        n_levels = len(level_sizes)
        before = corr3d.corr3d_tail.launches
        got = corr3d.corr3d_tail(xyz1, xyz2, idx, cost, params, n_levels, k)
        torch.cuda.synchronize()
        assert corr3d.corr3d_tail.launches == before + 1
        ref = corr3d.corr3d_tail_plain(xyz1, xyz2, idx, cost, params, n_levels, k)
    assert got.shape == (batch, n, out_channels)
    assert_conv_close(got, ref)


@pytest.mark.cuda
def test_corr3d_tail_reruns_bit_identical(cuda):
    """The level sums and the merge add in a fixed order: no float atomics."""
    with torch.inference_mode():
        params, xyz1, xyz2, idx, cost = tail_case(cuda, 45, 1, 2048, (2048, 1024, 512, 256), 16,
                                                  128)
        first = corr3d.corr3d_tail(xyz1, xyz2, idx, cost, params, 4, 16)
        for _ in range(2):
            assert torch.equal(corr3d.corr3d_tail(xyz1, xyz2, idx, cost, params, 4, 16), first)


@pytest.mark.cuda
def test_corr3d_tail_launch_above_48_kb_of_shared_memory(cuda):
    """The main path's merge weights (4 levels x 32 x 128 f32) are 64 KB of
    shared memory, above a launch's 48 KB default: the entry point raises
    the kernel's limit first, so the launch runs, and so does one of 8
    levels (128 KB)."""
    with torch.inference_mode():
        params, xyz1, xyz2, idx, cost = tail_case(cuda, 43, 1, 64, (64, 32, 16, 8), 4, 128)
        assert params.wm.numel() * 4 == 65536 > 48 * 1024
        got = corr3d.corr3d_tail(xyz1, xyz2, idx, cost, params, 4, 4)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        huge = params._replace(wm=torch.zeros(8 * 32, 128, device=cuda))
        corr3d.corr3d_tail(xyz1, xyz2, torch.zeros(1, 64, 32, dtype=torch.int32, device=cuda),
                           torch.zeros(1, 64, 32, device=cuda), huge, 8, 4)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_corr3d_tail_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    with torch.inference_mode():
        params, xyz1, xyz2, idx, cost = tail_case(cuda, 44, 1, 64, (64, 32, 16), 4, 128)
        with pytest.raises(TypeError):
            corr3d.corr3d_tail(xyz1.double(), xyz2, idx, cost, params, 3, 4)
        with pytest.raises(TypeError):
            corr3d.corr3d_tail(xyz1, xyz2, idx.long(), cost, params, 3, 4)
        with pytest.raises(ValueError, match="contiguous"):
            corr3d.corr3d_tail(xyz1, xyz2, idx, cost.transpose(1, 2).contiguous().transpose(1, 2),
                               params, 3, 4)
        with pytest.raises(ValueError, match="CUDA"):
            corr3d.corr3d_tail(xyz1, xyz2, idx, cost.cpu(), params, 3, 4)
        with pytest.raises(ValueError, match="shape"):
            corr3d.corr3d_tail(xyz1, xyz2, idx, cost, params, 3, 8)
        with pytest.raises(ValueError, match="do not fit"):
            corr3d.corr3d_tail(xyz1, xyz2, idx[..., :8].contiguous(), cost[..., :8].contiguous(),
                               params, 2, 4)
        wm = torch.empty(params.wm.numel() + 1, device=cuda)[1:].view(params.wm.shape)
        wm.copy_(params.wm)
        assert wm.data_ptr() % 16 == 4 and wm.is_contiguous()
        with pytest.raises(ValueError, match="16-byte"):  # the merge weights' 16-byte copies
            corr3d.corr3d_tail(xyz1, xyz2, idx, cost, params._replace(wm=wm), 3, 4)


def clfm_case(device, seed, batch, height, width, n, c2, c3):
    """A CLFM with random weights, its hoisted operands and inputs; some
    points project outside the map, so some taps are weighted 0."""
    from camliflow_torch.nn.clfm import CLFM, fusion_interp_cache

    torch.manual_seed(seed)
    module = CLFM(c2, c3).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    feat_2d = torch.randn(batch, height, width, c2, generator=gen, device=device)
    feat_3d = torch.randn(batch, n, c3, generator=gen, device=device)
    span = torch.tensor([width + 3.0, height + 3.0], device=device)
    uv = torch.rand(batch, n, 2, generator=gen, device=device) * span - 1.5
    cache = fusion_interp_cache(uv, height, width)
    score = clfm.hoist_interp_score(module.interp, cache[1])
    tap_idx, tap_w = clfm.grid_sample_cache(uv, height, width)
    assert (tap_w == 0).any()
    return (feat_2d, feat_3d, score, cache[0], tap_idx, tap_w), clfm.prepare_clfm_params(module)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,height,width,n,c2,c3", [
    (1, 68, 120, 2048, 324, 128),  # the flagship's corr call
    (1, 68, 120, 2048, 128, 128),  # its motion and hidden calls
    (2, 8, 12, 64, 324, 128),
    (2, 7, 9, 50, 128, 128),
])
def test_clfm_kernel_matches_plain(cuda, batch, height, width, n, c2, c3):
    with torch.inference_mode():
        inputs, params = clfm_case(cuda, 45, batch, height, width, n, c2, c3)
        before = clfm.clfm_fused.launches
        got_2d, got_3d = clfm.clfm_fused(*inputs, params)
        again_2d, again_3d = clfm.clfm_fused(*inputs, params)
        assert clfm.clfm_fused.launches == before + 2
        ref_2d, ref_3d = clfm.clfm_fused_plain(*inputs, params)
    assert got_2d.shape == (batch, height, width, c2) and got_3d.shape == (batch, n, c3)
    assert_conv_close(got_2d, ref_2d)
    assert_conv_close(got_3d, ref_3d)
    # no atomics: two runs give the same bits
    assert torch.equal(got_2d, again_2d) and torch.equal(got_3d, again_3d)


@pytest.mark.cuda
def test_clfm_kernel_is_at_most_six_launches(cuda):
    """One call at the flagship's corr widths: the profiler sees at most six
    kernels, two of them the tensor-core tile's grouped dense launches."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        inputs, params = clfm_case(cuda, 48, 1, 68, 120, 2048, 324, 128)
        clfm.clfm_fused(*inputs, params)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            clfm.clfm_fused(*inputs, params)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(names) <= 6, names
    assert sum("conv_tc_group_kernel" in name for name in names) == 2, names


@pytest.mark.cuda
def test_clfm_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    with torch.inference_mode():
        (f2d, f3d, score, nn_idx, tap_idx, tap_w), params = clfm_case(cuda, 46, 1, 6, 8, 30,
                                                                      128, 128)
        clfm.clfm_fused(f2d, f3d, score, nn_idx, tap_idx, tap_w, params)  # params checked once
        with pytest.raises(TypeError):
            clfm.clfm_fused(f2d.double(), f3d, score, nn_idx, tap_idx, tap_w, params)
        with pytest.raises(TypeError):
            clfm.clfm_fused(f2d, f3d, score, nn_idx, tap_idx.long(), tap_w, params)
        with pytest.raises(ValueError, match="contiguous"):
            clfm.clfm_fused(f2d.transpose(1, 2).contiguous().transpose(1, 2), f3d, score, nn_idx,
                            tap_idx, tap_w, params)
        with pytest.raises(ValueError, match="CUDA"):
            clfm.clfm_fused(f2d, f3d.cpu(), score, nn_idx, tap_idx, tap_w, params)
        with pytest.raises(ValueError, match="fit"):
            clfm.clfm_fused(f2d[..., :64].contiguous(), f3d, score, nn_idx, tap_idx, tap_w,
                            params)
        # a copy with another layer is checked again
        bare = {**params, "mlps3d": params["mlps3d"]._replace(hi=None, lo=None)}
        with pytest.raises(ValueError, match="tf32 planes"):
            clfm.clfm_fused(f2d, f3d, score, nn_idx, tap_idx, tap_w, bare)
        # the tensor-core tile copies 4 channels at a time
        inputs, params = clfm_case(cuda, 46, 1, 6, 8, 30, 126, 128)
        with pytest.raises(ValueError, match="multiple of 4"):
            clfm.clfm_fused(*inputs, params)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n_table,k,channels", [
    (1, 2048, 2048, 4, 256),  # GRU3D's z|r on the fuse_hidden path
    (1, 2048, 2048, 32, 64),  # FlowHead3D's conv2
    (2, 70, 100, 32, 125),  # batch 2, a table longer than the queries
    (2, 33, 33, 1, 3),
    (1, 2048, 2048, 4, 128),  # GRU3D's q
    (1, 2048, 2048, 32, 128),  # FlowHead3D's conv1
    (1, 300, 300, 40, 20),  # more neighbours than a round holds
    (1, 100, 120, 5, 300),  # wider than a round of channels
])
def test_dw_max_kernel_matches_plain(cuda, batch, m, n_table, k, channels):
    """Duplicate neighbours and NaN propagate as in torch.amax: bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(47)
    table = torch.randn(batch, n_table, channels, generator=gen, device=cuda)
    table[:, 5, :2] = float("nan")
    idx = torch.randint(0, n_table, (batch, m, max(k, 32)), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[:, ::7, k - 1] = idx[:, ::7, 0]  # duplicate neighbours
    weights = torch.randn(batch, m, k, channels, generator=gen, device=cuda)
    before = update3d.dw_max.launches
    got = update3d.dw_max(table, idx, weights)
    assert update3d.dw_max.launches == before + 1
    ref = update3d.dw_max_plain(table, idx, weights)
    assert got.shape == (batch, m, channels)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.cuda
def test_dw_max_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    table = torch.randn(1, 40, 16, device=cuda)
    idx = torch.randint(0, 40, (1, 40, 8), device=cuda, dtype=torch.int32)
    weights = torch.randn(1, 40, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        update3d.dw_max(table.double(), idx, weights)
    with pytest.raises(TypeError):
        update3d.dw_max(table, idx.long(), weights)
    with pytest.raises(ValueError, match="contiguous"):
        update3d.dw_max(table, idx, weights.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA|lies on"):
        update3d.dw_max(table, idx.cpu(), weights)
    with pytest.raises(ValueError, match="neighbours"):
        update3d.dw_max(table, idx[..., :4].contiguous(), weights)
    with pytest.raises(ValueError, match="no neighbours"):
        update3d.dw_max(table, idx, weights[:, :, :0].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [128, 64, 12])
def test_dw_max_kernel_takes_misaligned_rows(cuda, channels):
    """A table, weights or both starting 4 bytes past a 16-byte boundary
    take the 4-byte form: bit for bit all the same."""
    gen = torch.Generator(device=cuda).manual_seed(51)
    table = torch.randn(2, 90, channels, generator=gen, device=cuda)
    idx = torch.randint(0, 90, (2, 80, 32), generator=gen, device=cuda, dtype=torch.int32)
    weights = torch.randn(2, 80, 32, channels, generator=gen, device=cuda)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)

    ref = update3d.dw_max_plain(table, idx, weights)
    for t, w in ((shifted(table), weights), (table, shifted(weights)),
                 (shifted(table), shifted(weights))):
        assert torch.equal(update3d.dw_max(t, idx, w), ref)
