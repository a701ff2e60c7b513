"""PyTorch port, RAFT: the fused 2D update (kernel #10's plain version) and
the whole model against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and
its counterpart in camliflow_torch; Flax variables are carried into the
port through the weight bridge, with BatchNorm statistics and scales moved
away from 0/1. The JAX side runs its exact path (`fast_inference: off`).
Both sides are f32, so the tolerances cover summation order, except where a
test holds the port against the bf16 Pallas kernel in interpret mode: there
it uses the split kernels' test tolerances (tests/test_torch_camliraft.py).
The CUDA kernel itself runs only on a card: tests/test_torch_kernels_cuda.py
compares it with this plain version.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camliflow_tpu.models import raft as jraft
from camliflow_tpu.ops.pallas_update2d import (
    prepare_gru_flowhead_params,
    prepare_motion_encoder_params,
    update_2d_pallas,
)
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_torch.models import raft as traft
from camliflow_torch.models.factory import model_factory
from camliflow_torch.ops import update2d
from camliflow_torch.runtime.checkpoint import (
    load_jax_variables,
    relayout,
    state_dict_from_jax,
)
from camliflow_torch.runtime.names import translate_suffix

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def forward_only():
    """The fused kernels' packers and wrappers are forward-only: they refuse
    weights or inputs that require grad while grad mode is on (a gradient
    would be dropped). These tests exercise the eval path, so grad mode is
    off, as it is under the Evaluator's inference_mode."""
    with torch.no_grad():
        yield


def j(a):
    return jnp.asarray(np.asarray(a))


def t(a):
    return torch.from_numpy(np.array(a))


def perturb_bn(flat, seed):
    """Move every BatchNorm's statistics and affine parameters away from
    their init values (a BN bias is a bias beside a scale)."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for key, value in flat.items():
        is_bn_bias = key.endswith("/bias") and key[:-5] + "/scale" in flat
        if key.endswith("/mean") or is_bn_bias:
            out[key] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        elif key.endswith("/var"):
            out[key] = (1.0 + rng.rand(*value.shape)).astype(np.float32)
        elif key.endswith("/scale"):
            out[key] = (1.0 + 0.2 * rng.randn(*value.shape)).astype(np.float32)
    return out


def load_block(block, variables):
    """Carry a standalone Flax block's variables into its port."""
    shapes = {k: tuple(v.shape) for k, v in block.state_dict().items()}
    state = {}
    for path, value in tree_to_flat(jax.tree.map(np.asarray, variables)).items():
        key = translate_suffix(path.split("/", 1)[1])
        value = np.asarray(value, np.float32)
        if path.endswith("/kernel"):
            value = relayout(value, shapes[key])
        state[key] = torch.from_numpy(np.array(value))
    block.load_state_dict(state, strict=True)
    return block.eval()


def test_update_2d_plain_matches_flax_and_pallas():
    """MotionEncoder2D -> GRU2D -> FlowHead2D at 2 x 7 x 9, corr 36."""
    rng = np.random.RandomState(50)
    shape = (2, 7, 9)
    c = {"flow": 2 * rng.randn(*shape, 2), "corr": rng.randn(*shape, 36),
         "h": np.tanh(rng.randn(*shape, 128)), "x2d": np.maximum(rng.randn(*shape, 128), 0)}
    c = {k: np.asarray(v, np.float32) for k, v in c.items()}
    encoder, gru, head = jraft.MotionEncoder2D(), jraft.GRU2D(), jraft.FlowHead2D()
    evars = encoder.init(jax.random.PRNGKey(0), j(c["flow"]), j(c["corr"]))
    motion = encoder.apply(evars, j(c["flow"]), j(c["corr"]))
    x = jnp.concatenate([j(c["x2d"]), motion], axis=-1)
    gvars = gru.init(jax.random.PRNGKey(1), j(c["h"]), x)
    h_ref = gru.apply(gvars, j(c["h"]), x)
    hvars = head.init(jax.random.PRNGKey(2), h_ref)
    d_ref = head.apply(hvars, h_ref)

    me, gf = update2d.prepare_update_2d_params(
        load_block(traft.MotionEncoder2D(corr_channels=36), evars),
        load_block(traft.GRU2D(), gvars), load_block(traft.FlowHead2D(), hvars))
    args = (t(c["h"]), t(c["x2d"]), t(c["flow"]), t(c["corr"]), me, gf)
    h_got, d_got = update2d.update_2d_plain(*args)
    assert h_got.shape == (*shape, 128) and d_got.shape == (*shape, 2)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), rtol=0, atol=1e-5)
    # the wrapper on CPU tensors is the plain version
    h_w, d_w = update2d.update_2d(*args)
    np.testing.assert_array_equal(h_w.numpy(), h_got.numpy())
    np.testing.assert_array_equal(d_w.numpy(), d_got.numpy())
    # the Pallas kernel (bf16 operands), at the split kernels' tolerances
    h_pal, d_pal = update_2d_pallas(
        j(c["h"]), j(c["x2d"]), j(c["flow"]), j(c["corr"]),
        prepare_motion_encoder_params(evars["params"]),
        prepare_gru_flowhead_params(gvars["params"], hvars["params"]), 7, 9, interpret=True)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_pal), rtol=0, atol=3e-2)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_pal), rtol=0, atol=6e-2)


# --- the whole model -------------------------------------------------------------


def small_cfgs(**overrides):
    cfgs = {"name": "raft", "backbone": {"depth": 50}, "n_iters_eval": 2,
            "fast_inference": "off"}
    return {**cfgs, **overrides}


def make_inputs(seed, h=60, w=76):
    """bench.py's recipe at a small size: 60x76 pads to 64x80."""
    rng = np.random.RandomState(seed)
    return {"images": rng.randint(0, 255, size=(1, h, w, 6)).astype(np.float32)}


@pytest.fixture(scope="module")
def raft():
    """(flat JAX variables, JAX model, tree) of a small RAFT; larger flow
    head weights, so that the random-init model predicts flows of a few
    pixels and the comparison is not of near-zeros."""
    model = jraft.RAFT(cfgs=small_cfgs(), train_mode=False)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    {k: j(v) for k, v in make_inputs(0).items()})
    flat = perturb_bn(tree_to_flat(jax.tree.map(np.asarray, variables)), 51)
    for key in flat:
        if "flow_head" in key and key.endswith("/kernel"):
            flat[key] = flat[key] * 4.0
    return flat, model, flat_to_tree(flat)


def test_bridge_lands_every_leaf(raft):
    flat, _, _ = raft
    model = traft.RAFT(small_cfgs())
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = state_dict_from_jax(flat, "raft", shapes)
    assert set(state) == set(shapes) and len(state) == len(flat)
    np.testing.assert_array_equal(state["core.gru.convq2.weight"].numpy(),
                                  flat["params/core/update/gru/convq2/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["core.correlation.fnet_aligner.weight"].numpy(),
                                  flat["params/core/fnet_aligner/kernel"].T)
    np.testing.assert_array_equal(state["core.cnet.layer1.0.bn1.running_mean"].numpy(),
                                  flat["batch_stats/core/cnet/layer1_0/bn1/mean"])
    with pytest.raises(KeyError, match="no state_dict name"):
        state_dict_from_jax({**flat, "params/elsewhere/kernel": np.zeros((2, 2))}, "raft")


def test_raft_matches_jax(raft):
    """Full eval forward at 60x76 (padded to 64x80), 2 iterations: flow_2d to
    1e-3 px."""
    flat, model, tree = raft
    inputs = make_inputs(1)
    ref = jax.jit(model.apply)(tree, {k: j(v) for k, v in inputs.items()})
    port = model_factory(small_cfgs())(small_cfgs()).eval()
    load_jax_variables(port, flat, "raft")
    with torch.inference_mode():
        got = port({k: t(v) for k, v in inputs.items()})
    assert set(got) == {"flow_2d", "flow_2d_seq"}
    assert got["flow_2d"].shape == (1, 60, 76, 2)
    assert got["flow_2d_seq"].shape == (1, 1, 60, 76, 2)
    flow, flow_ref = got["flow_2d"].numpy(), np.asarray(ref["flow_2d"])
    assert np.abs(flow_ref).max() > 0.1  # the comparison is not of near-zeros
    np.testing.assert_allclose(flow, flow_ref, rtol=0, atol=1e-3)


def test_config_keys():
    for mode in ("auto", "off"):
        traft.RAFT(small_cfgs(fast_inference=mode, backbone={"depth": 18}))
    for storage in ("auto", "split"):
        traft.RAFT(small_cfgs(lookup_storage=storage, backbone={"depth": 18}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        traft.RAFT(small_cfgs(fast_inference="on"))
    for storage in ("bf16", "int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            traft.RAFT(small_cfgs(lookup_storage=storage))
    # the backbone depth as the JAX wrapper reads it
    no_backbone = {k: v for k, v in small_cfgs().items() if k != "backbone"}
    assert len(traft.RAFT(no_backbone).core.fnet.layer1) == 3  # ResNet-50
    pretrain = {**no_backbone, "pretrain": {"enabled": True, "depth": 18}}
    assert len(traft.RAFT(pretrain).core.fnet.layer1) == 2  # ResNet-18
