"""PyTorch port, the JAX package's two gated operand forms against the JAX
package, on the CPU: the int8 hoisted weights of the 3D chain
(CAMLIFLOW_UPDATE3D=1: `quantize_dw_int8`, #6's and #7's int8 forms) and
CLFM's bf16 form (CAMLIFLOW_CLFM=1: #11's bf16 form).

The same numpy inputs (made from a seed), and the Flax variables carried into
the port by name, go through the JAX functions (their Pallas kernels in
interpret mode, as the JAX package's own tests run them; each switch set by
`monkeypatch`, read by JAX at trace time, so every model is jitted anew) and
through the port's plain versions, which the CUDA kernels' gated forms equal
on a card (tests/test_torch_kernels_cuda.py, chip_smoke.py). The
quantisation is held bit for bit; each op within one bf16 step of its
output's largest value (the two sides sum in another order, which can flip
a bf16 rounding); each whole model within 2e-3 m and 1e-2 px of the JAX
flows.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import camliraft as jflag
from camliflow_tpu.models import camliraft_l as jm
from camliflow_tpu.ops import pallas_clfm as jclfm
from camliflow_tpu.ops import pallas_update3d as pu
from camliflow_tpu.ops.geometry import k_nearest_neighbor
from camliflow_tpu.runtime.checkpoint import flat_to_tree
from camliflow_torch.models import camliraft as tflag
from camliflow_torch.models import camliraft_l as tm
from camliflow_torch.ops import clfm, update3d
from tests.test_torch_clfm import make_case
from tests.test_torch_fast_inference import (
    BF16_STEP,
    LIKE_2D,
    LIKE_3D,
    camliraft_l,  # noqa: F401 (a fixture)
    flag_cfgs,
    flag_inputs,
    l_inputs,
    run_port,
)
from tests.test_torch_pwc import jax_variables
from tests.test_torch_update3d import load_block

torch.set_num_threads(2)

BATCH, N = 2, 64  # a batch of 2: the int8 scales are the batch's


@pytest.fixture(autouse=True)
def forward_only():
    """The gated forms are forward-only, as the Evaluator runs them."""
    with torch.no_grad():
        yield


def j(a):
    return jnp.asarray(np.asarray(a))


def t(a):
    return torch.from_numpy(np.array(a))


def seeded_variables(block, seed, *args):
    """A Flax block's variables: the shapes of its init (traced by
    `jax.eval_shape`, not run: an eager init of these blocks takes 20 s),
    the values from a seeded generator at the init's scale, kernels
    U(+-1/sqrt(fan_in)) and biases U(+-0.1)."""
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(seed), *args)
    rng = np.random.RandomState(seed)

    def value(path, leaf):
        bound = float(np.prod(leaf.shape[:-1])) ** -0.5 if path[-1].key == "kernel" else 0.1
        return jnp.asarray(rng.uniform(-bound, bound, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(value, shapes)


def within_a_step(got, ref):
    """|got - ref| within one bf16 step of ref's largest value."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_STEP * float(np.abs(ref).max()))


# --- the int8 hoisted weights (kernels #6 and #7) ---------------------------


@pytest.fixture(scope="module")
def chain():
    """The 3D chain's Flax blocks at 64 points, a batch of 2, their hoisted
    weights (one channel zero across the batch: the 1e-12 floor), the JAX
    quantisation, and the ports with the same weights."""
    rng = np.random.default_rng(20)

    def rand(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.float32)

    xyz = rand(BATCH, N, 3)
    knn = k_nearest_neighbor(xyz, xyz, 32)
    c = {"flow": 0.1 * rand(BATCH, N, 3), "corr": rand(BATCH, N, 128),
         "h": jnp.tanh(rand(BATCH, N, 128)), "x3d": jnp.maximum(rand(BATCH, N, 128), 0.0),
         "motion": rand(BATCH, N, 128)}
    encoder, gru, head = jm.MotionEncoder3D(), jm.GRU3D(hidden_dim=128), jm.FlowHead3D()
    evars = seeded_variables(encoder, 0, xyz, c["flow"], c["corr"], knn)
    gvars = seeded_variables(gru, 1, xyz, c["h"], jnp.concatenate([c["x3d"], c["motion"]], -1),
                             knn)
    hvars = seeded_variables(head, 2, xyz, c["h"], knn)
    dw = {"motion_encoder": encoder.apply(evars, xyz, knn,
                                          method=jm.MotionEncoder3D.precompute_weights),
          "gru": gru.apply(gvars, xyz, knn, method=jm.GRU3D.precompute_weights),
          "flow_head": head.apply(hvars, xyz, knn, method=jm.FlowHead3D.precompute_weights)}
    dw["motion_encoder"]["conv_f1"] = dw["motion_encoder"]["conv_f1"].at[..., 5].set(0.0)
    # jitted, as inside the JAX models (eager, it takes 8 s; the same bits)
    quantize = jax.jit(pu.quantize_dw_int8)
    ref = quantize(dw, pu.prepare_motion_encoder_3d_params(evars["params"]),
                   pu.prepare_gru_flowhead_3d_params(gvars["params"], hvars["params"]))
    ports = (load_block(tm.MotionEncoder3D(), evars), load_block(tm.GRU3D(), gvars),
             load_block(tm.FlowHead3D(), hvars))
    port_dw = {tree: {name: t(w) for name, w in convs.items()} for tree, convs in dw.items()}
    port_dw["motion_encoder"]["conv"] = update3d.padded_rows(port_dw["motion_encoder"]["conv"])
    return (knn, c, dw, ref, ports, port_dw, evars,
            (gvars["params"], hvars["params"]), quantize)


def test_quantize_dw_int8_matches_jax_bit_for_bit(chain):
    """The int8 values (the port keeps [B, N, k, C], the merge conv's rows
    16 values apart), each conv's scales, and the folded kernels and biases,
    bit for bit, at a batch of 2 (the scales span the batch), from f32
    weights and from the bf16 ones the models quantise."""
    _, _, dw, (dq, me_q, gf_q), (encoder, gru, head), port_dw = chain[:6]
    qdw, me, gf = update3d.quantize_dw_int8(port_dw, update3d.motion_encoder_3d_weights(encoder),
                                            update3d.gru_flowhead_3d_weights(gru, head))
    for tree, convs in qdw.items():
        for name, q in convs.items():
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.transpose(np.asarray(dq[tree][name]),
                                                                  (0, 2, 1, 3)))
            w = dw[tree][name]  # the JAX package's own expression of the scale
            scale = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-12) * (1.0 / 127.0)
            _, got = update3d.quantize_channels_int8(port_dw[tree][name])
            np.testing.assert_array_equal(got.numpy(), np.asarray(scale))
    merge = qdw["motion_encoder"]["conv"]
    assert merge.stride()[2:] == (128, 1) and merge.shape[-1] == 125
    assert float(np.asarray(dw["motion_encoder"]["conv_f1"])[..., 5].max()) == 0.0
    for i, name in enumerate(update3d.ME_CONVS):
        np.testing.assert_array_equal(me[name][0].numpy().T, np.asarray(me_q[2 * i]))
        np.testing.assert_array_equal(me[name][1].numpy(), np.asarray(me_q[2 * i + 1]))
    for i, name in enumerate(("zr", "q", "conv1", "conv2", "fc")):  # fc: unfolded
        np.testing.assert_array_equal(gf[name][0].numpy().T, np.asarray(gf_q[2 * i]))
        np.testing.assert_array_equal(gf[name][1].numpy(), np.asarray(gf_q[2 * i + 1]))
    # the models quantise the fast path's bf16 weights, as the JAX models do
    dw16 = jax.tree.map(lambda w: w.astype(jnp.bfloat16), dw)
    dq16, me16, _ = chain[8](dw16, pu.prepare_motion_encoder_3d_params(chain[6]["params"]),
                             pu.prepare_gru_flowhead_3d_params(*chain[7]))
    qdw16, me_16, _ = update3d.quantize_dw_int8(update3d.to_bf16(port_dw),
                                               update3d.motion_encoder_3d_weights(encoder),
                                               update3d.gru_flowhead_3d_weights(gru, head))
    for tree, convs in qdw16.items():
        for name, q in convs.items():
            np.testing.assert_array_equal(q.numpy(), np.transpose(np.asarray(dq16[tree][name]),
                                                                  (0, 2, 1, 3)))
    for i, name in enumerate(update3d.ME_CONVS):
        np.testing.assert_array_equal(me_16[name][1].numpy(), np.asarray(me16[2 * i + 1]))


def test_update3d_int8_forms_match_pallas(chain):
    """#6's and #7's int8 forms (`prepare_int8`: the packings from the
    folded weights, bf16) against motion_encoder_3d_pallas and
    gru_flowhead_3d_pallas on the same quantised weights (their kernel
    layout): each output within one bf16 step of its largest value, the
    flow columns bit for bit."""
    knn, c, _, (dq, me_q, gf_q), (encoder, gru, head), port_dw = chain[:6]
    qdw, me, gf = update3d.prepare_int8(port_dw, encoder, gru, head)
    assert all(p.bf16 for p in (*me.values(), *gf.values()))
    assert me["conv"].hi is not None and me["conv"].lo is None  # the tile's one bf16 plane
    got = update3d.motion_encoder_3d(t(c["flow"]), t(c["corr"]), t(knn),
                                     qdw["motion_encoder"], me)
    ref = pu.motion_encoder_3d_pallas(c["flow"], c["corr"], knn, dq["motion_encoder"], me_q,
                                      interpret=True)
    within_a_step(got[..., :125], np.asarray(ref)[..., :125])
    np.testing.assert_array_equal(got[..., 125:].numpy(), np.asarray(c["flow"]))
    h, delta = update3d.gru_flowhead_3d(t(c["h"]), t(c["x3d"]), t(c["motion"]), t(knn),
                                        {**qdw["gru"], **qdw["flow_head"]}, gf)
    h_ref, d_ref = pu.gru_flowhead_3d_pallas(
        c["h"], c["x3d"], c["motion"], knn,
        {**dq["gru"], "flow_conv1": dq["flow_head"]["conv1"],
         "flow_conv2": dq["flow_head"]["conv2"]}, gf_q, interpret=True)
    within_a_step(h, h_ref)
    within_a_step(delta, d_ref)


def test_int8_form_takes_its_own_packings(chain):
    """int8 weights with the f32 packings, or bf16 weights with the int8
    form's, raise before a launch would read them in the wrong form."""
    knn, c, _, _, (encoder, gru, head), port_dw = chain[:6]
    qdw, me, _ = update3d.prepare_int8(port_dw, encoder, gru, head)
    f32 = update3d.prepare_motion_encoder_3d_params(encoder)
    with pytest.raises(ValueError, match="bf16 packings"):
        update3d._check_form("motion_encoder_3d", f32, torch.int8)
    with pytest.raises(ValueError, match="f32 packings"):
        update3d._check_form("motion_encoder_3d", me, torch.bfloat16)
    assert update3d._check_form("motion_encoder_3d", me, torch.int8) == 2
    assert update3d._check_form("motion_encoder_3d", f32, torch.float32) == 0


# --- CLFM's bf16 form (kernel #11) ------------------------------------------


@pytest.mark.parametrize("c2,c3", [(324, 128), (128, 128)])
def test_clfm_bf16_form_matches_pallas(c2, c3):
    """#11's bf16 form against clfm_fused_pallas (interpret mode) on the
    same score gate, cache and taps, at the corr and motion widths: each
    output within one bf16 step of its largest value. The port's own bf16
    gate, computed in f32 by the module and rounded, within one bf16 step
    of 1."""
    _, variables, port, (uv, feat_2d, feat_3d), cache = make_case(c2, c3, 84)
    params = variables["params"]
    score = jclfm.hoist_interp_score(params["interp"], cache[1])
    taps = jclfm.grid_sample_cache(uv, *feat_2d.shape[1:3])
    ref_2d, ref_3d = jclfm.clfm_fused_pallas(feat_2d, feat_3d, score, cache[0], *taps,
                                             jclfm.prepare_clfm_params(params), interpret=True)
    packed = clfm.prepare_clfm_params(port, bf16=True)
    assert all(packed[key].bf16 and packed[key].lo is None for key in clfm.DENSE)
    own = clfm.hoist_interp_score(port.interp, t(cache[1]), bf16=True)
    assert own.dtype == torch.bfloat16
    np.testing.assert_allclose(own.float().numpy(), np.asarray(score, np.float32), rtol=0,
                               atol=BF16_STEP)
    score_t = torch.from_numpy(np.asarray(score, np.float32)).to(torch.bfloat16)
    got_2d, got_3d = clfm.clfm_fused(t(feat_2d), t(feat_3d), score_t, t(cache[0]),
                                     *clfm.grid_sample_cache(t(uv), *feat_2d.shape[1:3]), packed)
    within_a_step(got_2d, ref_2d)
    within_a_step(got_3d, ref_3d)


# --- whole models with the switches on ---------------------------------------


def switches(monkeypatch, update3d_on: bool, clfm_on: bool):
    monkeypatch.setenv("CAMLIFLOW_UPDATE3D", "1" if update3d_on else "0")
    monkeypatch.setenv("CAMLIFLOW_CLFM", "1" if clfm_on else "0")


@pytest.fixture
def forms(monkeypatch):
    """The gated forms a forward took: each `prepare_int8` call, and the
    `bf16` argument of each `prepare_clfm_params` call."""
    taken = {"int8": 0, "clfm": []}
    prepare_int8, prepare_clfm = update3d.prepare_int8, clfm.prepare_clfm_params

    def int8(*args):
        taken["int8"] += 1
        return prepare_int8(*args)

    def clfm_params(module, bf16=False):
        taken["clfm"].append(bf16)
        return prepare_clfm(module, bf16)

    monkeypatch.setattr(update3d, "prepare_int8", int8)
    monkeypatch.setattr(clfm, "prepare_clfm_params", clfm_params)
    return taken


def report(name, label, got, ref, bound):
    d = float(np.abs(got - ref).max())
    print(f"{name} {label}: max |delta| {d:.3e} at scale {np.abs(ref).max():.3e} "
          f"(bound {bound:.0e})")
    assert d <= bound, (name, label, d, bound)


def test_camliraft_l_int8_matches_jax(camliraft_l, monkeypatch, forms):  # noqa: F811
    """CamLiRAFT-L with `fast_inference: on` and CAMLIFLOW_UPDATE3D=1 (512
    points, 3 iterations, a batch of 2): the port's int8 chain (taken once
    a request) against the JAX package's Pallas chain within 2e-3 m."""
    flat, tree, cfgs = camliraft_l
    inputs = l_inputs(1)
    fast_cfgs = {**cfgs, "fast_inference": "on"}
    switches(monkeypatch, True, False)
    ref = jax.jit(jm.CamLiRAFTL(cfgs=fast_cfgs, train_mode=False).apply)(
        tree, {k: j(v) for k, v in inputs.items()})
    got = run_port(tm.CamLiRAFTL, fast_cfgs, flat, "camliraft_l", inputs)["flow_3d"].numpy()
    report("camliraft_l", "int8 vs JAX int8", got, np.asarray(ref["flow_3d"]), LIKE_3D)
    assert forms["int8"] == 1


@pytest.fixture(scope="module")
def flagships():
    """The flagship's JAX variables (fuse_hidden off and on; seeded values
    on the init's shapes, `jax_variables`, which traces the init without
    compiling it), flows of a pixel or so and a few tenths of a metre."""
    out = {}
    for fuse_hidden in (False, True):
        cfgs = flag_cfgs(fuse_hidden=fuse_hidden)
        inputs = flag_inputs(3)
        flat = jax_variables(jflag.CamLiRAFT, cfgs, inputs, 12)
        for key in flat:  # its 3D flows a few metres: a few tenths
            if "flow_head_3d/fc/" in key:
                flat[key] = flat[key] * 0.05
        out[fuse_hidden] = ({**cfgs, "fast_inference": "on"}, flat, inputs)
    return out


@pytest.mark.parametrize("fuse_hidden", [False, True])
def test_camliraft_gated_matches_jax(flagships, fuse_hidden, monkeypatch, forms):
    """The flagship with `fast_inference: on`, 60x76, 512 points, 2
    iterations. fuse_hidden off, both switches on: the int8 3D chain and
    the bf16 corr and motion fusions; fuse_hidden on, CAMLIFLOW_CLFM=1:
    the bf16 corr and motion fusions, the hidden one exact. Both flows
    against the JAX package's with the same switches within 1e-2 px and
    2e-3 m. With fuse_hidden, CAMLIFLOW_UPDATE3D=1 changes nothing, in JAX
    and in the port (bit for bit): the int8 chain needs #7 whole. The
    forms taken are counted."""
    fast_cfgs, flat, inputs = flagships[fuse_hidden]
    switches(monkeypatch, not fuse_hidden, True)
    ref = jax.jit(jflag.CamLiRAFT(cfgs=fast_cfgs, train_mode=False).apply)(
        flat_to_tree(flat), {k: j(v) for k, v in inputs.items()})
    got = run_port(tflag.CamLiRAFT, fast_cfgs, flat, "camliraft", inputs)
    assert np.abs(got["flow_2d"].numpy()).max() > 0.1
    assert np.abs(got["flow_3d"].numpy()).max() > 0.05
    name = f"camliraft fuse_hidden={fuse_hidden}"
    report(name, "2D gated vs JAX gated", got["flow_2d"].numpy(), np.asarray(ref["flow_2d"]),
           LIKE_2D)
    report(name, "3D gated vs JAX gated", got["flow_3d"].numpy(), np.asarray(ref["flow_3d"]),
           LIKE_3D)
    # corr and motion in the bf16 form, the hidden fusion exact
    assert forms == {"int8": 0 if fuse_hidden else 1,
                     "clfm": [True, True] + ([False] if fuse_hidden else [])}
    if fuse_hidden:  # the int8 chain falls back to the bf16 form, bit for bit
        switches(monkeypatch, True, True)
        again = run_port(tflag.CamLiRAFT, fast_cfgs, flat, "camliraft", inputs)
        for key in ("flow_2d", "flow_3d"):
            np.testing.assert_array_equal(again[key].numpy(), got[key].numpy())
        assert forms["int8"] == 0


def test_int8_chain_falls_back_above_4096_points(monkeypatch):
    """The JAX package engages its int8 chain at `xyz1.shape[1] <= 4096`:
    at 4096 loop points the port's hoist gives int8 weights, at 4097 the
    bf16 form's weights and packings, bit for bit the switch-off hoist."""
    monkeypatch.setenv("CAMLIFLOW_UPDATE3D", "1")
    update = tm.UpdateBlock3D(n_levels=4).eval()
    gen = torch.Generator().manual_seed(21)
    for n, int8 in ((4096, True), (4097, False)):
        xyz = torch.randn(1, n, 3, generator=gen)
        knn = torch.randint(0, n, (1, n, 32), generator=gen, dtype=torch.int32)
        dw, packed = update.hoist(xyz, knn, fast=True)
        want = torch.int8 if int8 else torch.bfloat16
        assert all(w.dtype == want for convs in dw.values() for w in convs.values())
        if not int8:
            monkeypatch.setenv("CAMLIFLOW_UPDATE3D", "0")
            dw_off, packed_off = update.hoist(xyz, knn, fast=True)
            for tree, convs in dw.items():
                for name, w in convs.items():
                    assert torch.equal(w, dw_off[tree][name])
            for key in ("me", "gf"):
                for name, conv in packed[key].items():
                    assert not conv.bf16 and torch.equal(conv.weight,
                                                         packed_off[key][name].weight)
        del dw, packed


@pytest.mark.parametrize("value", [None, "0", "1", "2", ""])
def test_switches_read_as_jax_reads_them(monkeypatch, value):
    """Each switch reads its variable as the JAX package's own reader does
    (unset, "0", "1", another value, empty), and `update3d.int8_form`
    engages the int8 chain on the JAX models' conditions: the fast path,
    the switch on, at most 4096 loop points and no CLFM at the hidden
    state."""
    for name in ("CAMLIFLOW_UPDATE3D", "CAMLIFLOW_CLFM"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert update3d.int8_dw_enabled() == pu.update3d_enabled()
    assert clfm.bf16_enabled() == jclfm.clfm_pallas_enabled()
    for fast, n, hidden in itertools.product((False, True), (4096, 4097), (False, True)):
        want = fast and pu.update3d_enabled() and n <= 4096 and not hidden
        assert update3d.int8_form(fast, n, hidden) == want, (fast, n, hidden)
        if not hidden:
            assert update3d.int8_form(fast, n) == want
