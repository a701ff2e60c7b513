"""PyTorch port, one train step of the flagship against the JAX package on
the CPU: CamLiRAFT at its own width (ResNet-50 to stage 2, CLFM at fnet,
cnet, corr and motion) on 64x96 images and 512 points, n_samples_list
[256, 128, 64, 32, 16], 2 iterations, batch 2, f32.

Both sides start from the same variables (the JAX init, carried into the
port through the weight bridge; BatchNorm statistics and affine
parameters moved away from 1/0, and every zero bias given a small random
value: at a zero bias a leaky ReLU sits on its kink at the self-neighbour
of each PointConv, where the two frameworks pick different subgradients).
The JAX side runs its training path on the CPU (`train_mode=True`, Pallas
selection in interpret mode), `loss_fn`, `jax.value_and_grad` and the
optax chain of `optimizer_factory`; the port runs `train_step`. Compared:
the loss to 1e-5 relative, every gradient (after the clip, the same factor
on both sides) within 1e-3 * (1 + max|g_jax|), the BatchNorm running
statistics after the step to 1e-6, the parameters after the clipped AdamW
step to 1e-5 (2 lr where the two gradients round to opposite signs; see
that test), and the branch gradient norms. With `amp` (bf16 compute) each
side's loss is finite and within 5e-2 relative of its f32 loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from camliflow_tpu.models import camliraft as jm
from camliflow_tpu.models.factory import optimizer_factory as jax_optimizer_factory
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_tpu.runtime.train_state import branch_grad_norms as jax_grad_norms
from camliflow_tpu.utils.config import Config as JConfig
from camliflow_torch.models import camliraft as tm
from camliflow_torch.models.factory import optimizer_factory
from camliflow_torch.runtime.checkpoint import load_jax_variables, relayout
from camliflow_torch.runtime.names import our_path_to_torch
from camliflow_torch.runtime.train_state import train_step

torch.set_num_threads(4)

CFGS = {"name": "camliraft", "backbone": {"depth": 50}, "n_iters_eval": 2,
        "n_iters_train": 2, "fast_inference": "auto", "freeze_bn": False,
        "fuse_fnet": True, "fuse_cnet": True, "fuse_corr": True, "fuse_motion": True,
        "fuse_hidden": False, "n_samples_list": [256, 128, 64, 32, 16],
        "loss2d": {"gamma": 0.8, "order": "l2-norm"},
        "loss3d": {"gamma": 0.8, "order": "l2-norm"}}
# conf/training/flyingthings3d_subset/camliraft.yaml; the first step's rate
# is warmup_lr
TRAINING = {"opt": "adamw", "lr_2d": 2e-4, "lr_3d": 2e-3, "weight_decay": 1e-6,
            "grad_max_norm": 1, "epochs": 150, "warmup_epochs": 2, "warmup_lr": 1e-5,
            "min_lr": 1e-5}


def make_batch(seed, batch=2, h=64, w=96, n=512):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(batch, h, w, 6)).astype(np.float32)
    pc1 = rng.randn(batch, n, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(batch, n, 3).astype(np.float32)
    flow_2d = np.concatenate([rng.randn(batch, h, w, 2), rng.rand(batch, h, w, 1) > 0.3], -1)
    return {"images": images, "pcs": np.concatenate([pc1, pc2], -1),
            "intrinsics": np.tile([100.0, (w - 1) / 2, (h - 1) / 2], (batch, 1)).astype(np.float32),
            "flow_2d": flow_2d.astype(np.float32),
            "flow_3d": (pc2 - pc1 + 0.02 * rng.randn(batch, n, 3)).astype(np.float32)}


def generic_variables(flat, seed):
    """BatchNorm statistics and affine parameters away from their init
    values, and every zero bias a small random one."""
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
        elif key.startswith("params/") and key.endswith("/bias") and not np.any(value):
            out[key] = (0.05 * rng.randn(*value.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def steps():
    """(JAX results, the port after its step, the port's loss and
    telemetry, the port's layout of each kernel)."""
    batch = make_batch(0)
    jin = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jm.CamLiRAFT(cfgs=CFGS, train_mode=True)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jin)
    flat = generic_variables(tree_to_flat(jax.tree.map(np.asarray, variables)), 11)
    tree = flat_to_tree(flat)

    def loss_of(params):
        out, updates = model.apply({"params": params, "batch_stats": tree["batch_stats"]}, jin,
                                   mutable=["batch_stats"])
        loss, _ = jm.loss_fn(out, jin, JConfig(CFGS))
        return loss, updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(tree["params"])
    tx = jax_optimizer_factory(JConfig(TRAINING), tree["params"], steps_per_epoch=4)
    step, _ = tx.update(grads, tx.init(tree["params"]), tree["params"])
    ref = {"loss": float(loss), "grads": tree_to_flat(jax.tree.map(np.asarray, grads)),
           "stats": tree_to_flat(jax.tree.map(np.asarray, updates)),
           "params": tree_to_flat(jax.tree.map(np.asarray, optax.apply_updates(tree["params"],
                                                                               step))),
           "norms": {k: float(v) for k, v in jax_grad_norms(grads).items()}}

    port = tm.CamLiRAFT(CFGS)
    load_jax_variables(port, flat, "camliraft")
    port.train()
    optimizer = optimizer_factory(TRAINING, port, steps_per_epoch=4)
    got_loss, _, telemetry = train_step(port, optimizer, {k: torch.from_numpy(v) for k, v in
                                                          batch.items()},
                                        tm.loss_fn, CFGS, step=0)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    return ref, port, float(got_loss), telemetry, shapes, (flat, batch)


def port_view(path, value, shapes):
    """A JAX leaf in the port's layout, with the port's name."""
    key = our_path_to_torch(path.split("/", 1)[1], "camliraft")
    return key, relayout(value, shapes[key]) if path.endswith("/kernel") else value


def test_train_step_loss(steps):
    ref, _, loss, _, _, _ = steps
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)


def test_train_step_gradients(steps):
    """Every parameter's gradient, as the port's step left it (clipped to
    the global norm 1), against the JAX gradient times the same clip."""
    ref, port, _, _, shapes, _ = steps
    norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                       for g in ref["grads"].values()))
    factor = min(1.0, 1.0 / norm)
    params = dict(port.named_parameters())
    assert len(ref["grads"]) == len(params)
    for path, g in ref["grads"].items():
        key, want = port_view("params/" + path, g * factor, shapes)
        got = params[key].grad.numpy()
        bound = 1e-3 * (1.0 + np.abs(want).max())
        assert np.abs(got - want).max() <= bound, (key, np.abs(got - want).max(), bound)


def test_train_step_branch_grad_norms(steps):
    ref, _, _, telemetry, _, _ = steps
    for key, value in ref["norms"].items():
        assert float(telemetry[key]) > 0
        np.testing.assert_allclose(float(telemetry[key]), value, rtol=1e-4)


def test_train_step_batchnorm_statistics(steps):
    """The running statistics after the step: the biased-variance update of
    every train-mode BatchNorm (the 3D encoders' per frame, the fnet/cnet
    fusions'), the backbone's untouched."""
    ref, port, _, _, shapes, _ = steps
    buffers = dict(port.named_buffers())
    assert ref["stats"]
    for path, value in ref["stats"].items():
        key, want = port_view(path, value, shapes)
        np.testing.assert_allclose(buffers[key].numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_train_step_parameters_after_the_clipped_adamw_step(steps):
    """Every parameter after the step within 1e-5 of the JAX one where the
    two gradients have the same sign. Adam's first step moves an element by
    lr * g / (|g| + eps), about +-lr whatever |g|, so an element whose
    gradient rounds to the other sign in the other framework (a gradient
    within their rounding difference of 0) lands 2 lr apart: those are held
    to 2 lr (lr = warmup_lr = 1e-5 at the first step) and counted."""
    ref, port, _, _, shapes, _ = steps
    params = dict(port.named_parameters())
    lr, flipped = TRAINING["warmup_lr"], 0
    for path, value in ref["params"].items():
        key, want = port_view("params/" + path, value, shapes)
        _, grad = port_view("params/" + path, ref["grads"][path], shapes)
        same = np.sign(params[key].grad.numpy()) == np.sign(grad)
        diff = np.abs(params[key].detach().numpy() - want)
        assert diff[same].max(initial=0) <= 1e-5, (key, diff[same].max())
        assert diff[~same].max(initial=0) <= 2 * lr * (1 + 1e-3), (key, diff[~same].max())
        flipped += int((~same).sum())
    # ~1e-4 of the elements here (the pre-BatchNorm biases of the 3D
    # encoders, whose true gradient is 0, and backbone weights at |g| ~ 1e-9);
    # a gradient of the wrong sign at large would flip about half
    assert flipped <= 1e-2 * sum(p.numel() for p in params.values())


def test_train_step_amp_losses_are_close_to_f32(steps):
    """bf16 compute (`compute_dtype: bfloat16`, what `training.amp` sets):
    both losses finite and within 5e-2 relative of their f32 values (the
    two frameworks cast at different points, so no bit parity)."""
    ref, _, loss_f32, _, _, (flat, batch) = steps
    cfgs = {**CFGS, "compute_dtype": "bfloat16"}
    jin = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = flat_to_tree(flat)
    model = jm.CamLiRAFT(cfgs=cfgs, train_mode=True)
    out, _ = jax.jit(lambda v: model.apply(v, jin, mutable=["batch_stats"]))(tree)
    jax_amp = float(jm.loss_fn(out, jin, JConfig(cfgs))[0])
    port = tm.CamLiRAFT(cfgs)
    load_jax_variables(port, flat, "camliraft")
    with torch.no_grad():
        outputs = port.train()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert outputs["flow_2d_seq"].shape == (2, 2, 64, 96, 2)
    port_amp = float(tm.loss_fn(outputs, {k: torch.from_numpy(v) for k, v in batch.items()},
                                cfgs)[0])
    for amp, f32 in ((jax_amp, ref["loss"]), (port_amp, loss_f32)):
        assert np.isfinite(amp)
        assert abs(amp - f32) <= 5e-2 * abs(f32), (amp, f32)
