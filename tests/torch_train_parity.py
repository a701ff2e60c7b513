"""One f32 train step of a model family, the JAX package's against the
port's, on the CPU: the shared half of tests/test_torch_train_step_*.py.

Both sides start from the same variables: the JAX init's paths and shapes
(`jax.eval_shape`, tests/test_torch_pwc.py::jax_variables) with seeded
values, BatchNorm away from 0/1 and every bias nonzero (at a zero bias a
leaky ReLU sits on its kink at a PointConv's self-neighbour, where the two
frameworks pick different subgradients), carried into the port through the
weight bridge. The JAX side runs its training path (`train_mode=True`, the
Pallas selections in interpret mode), its `loss_fn`, `jax.value_and_grad`
and the optax chain of `optimizer_factory`; the port runs `train_step`.

The JAX package ranks neighbours by |q|^2 - 2 q.p + |p|^2, the port by the
per-coordinate distance (ROADMAP Queue 3): at IDS coordinates the two
rules pick a different k-th neighbour at a few near-ties, which moves the
BatchNorm statistics by ~1e-5. So the step is taken with the JAX package
selecting by the port's rule (`port_selection_rule`, patched here, the JAX
package untouched), and the loss is also held to the JAX package's own
rule's (`check_loss_under_the_jax_selection_rule`).

The checks: the loss to 1e-5 relative, every gradient (after the clip, the
same factor on both sides) within 1e-3 * (1 + max|g_jax|), the BatchNorm
running statistics after the step to 1e-6 (under `freeze_bn` unchanged on
both sides, bit for bit), the parameters after the
clipped Adam/AdamW step to 1e-5 (2 lr where the two gradients round to
opposite signs), the branch gradient norms to 1e-4 relative, and, with
bf16 compute, each side's loss within 5e-2 relative of its f32 loss.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from camliflow_tpu.models.factory import optimizer_factory as jax_optimizer_factory
from camliflow_tpu.ops import geometry as jgeo
from camliflow_tpu.runtime.checkpoint import flat_to_tree, tree_to_flat
from camliflow_tpu.runtime.train_state import branch_grad_norms as jax_grad_norms
from camliflow_tpu.utils.config import Config as JConfig
from camliflow_torch.models.factory import optimizer_factory
from camliflow_torch.runtime.checkpoint import load_jax_variables, relayout
from camliflow_torch.runtime.names import our_path_to_torch
from camliflow_torch.runtime.train_state import train_step
from test_torch_pwc import jax_variables

N_SAMPLES = [256, 128, 64, 32, 16]


def make_batch(seed, batch=2, h=64, w=96, n=512, images=True, points=True):
    """Images, clouds 5-35 m deep that project into them (f = 100 px) and
    targets (2D with a validity channel, 3D with an occlusion mask)."""
    rng = np.random.RandomState(seed)
    pc1 = rng.randn(batch, n, 3).astype(np.float32)
    pc1[..., 2] = np.abs(pc1[..., 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(batch, n, 3).astype(np.float32)
    out = {}
    if images:
        flow_2d = np.concatenate([rng.randn(batch, h, w, 2), rng.rand(batch, h, w, 1) > 0.3], -1)
        out.update(images=rng.randint(0, 255, size=(batch, h, w, 6)).astype(np.float32),
                   flow_2d=flow_2d.astype(np.float32))
    if points:
        out.update(pcs=np.concatenate([pc1, pc2], -1),
                   intrinsics=np.tile([100.0, (w - 1) / 2, (h - 1) / 2],
                                      (batch, 1)).astype(np.float32),
                   flow_3d=(pc2 - pc1 + 0.02 * rng.randn(batch, n, 3)).astype(np.float32),
                   occ_mask_3d=(rng.rand(batch, n) > 0.8).astype(np.float32))
    return out


def per_coordinate_squared_distance(xyz1, xyz2):
    """The port's selection distance, dx*dx + dy*dy + dz*dz, in JAX."""
    a, b = xyz1.astype(jnp.float32)[:, :, None, :], xyz2.astype(jnp.float32)[:, None, :, :]
    dist = None
    for c in range(a.shape[-1]):
        d = a[..., c] - b[..., c]
        dist = d * d if dist is None else dist + d * d
    return dist


@contextlib.contextmanager
def port_selection_rule():
    """The JAX package's selections (`k_nearest_neighbor` and the train
    path's Correlation3D) ranking by the port's distance; the compiled
    traces are dropped on the way in and out."""
    saved = jgeo.squared_distance
    jgeo.squared_distance = per_coordinate_squared_distance
    jax.clear_caches()
    try:
        yield
    finally:
        jgeo.squared_distance = saved
        jax.clear_caches()


class Steps:
    """The two sides' step from the same variables on the same batch."""

    def __init__(self, jax_module, jax_cls, torch_module, torch_cls, name, cfgs, training,
                 batch, seed=0, points=True):
        self.name, self.cfgs, self.training, self.batch = name, cfgs, training, batch
        self.jax_module, self.jax_cls = jax_module, jax_cls
        self.torch_module, self.torch_cls = torch_module, torch_cls
        self.flat = jax_variables(jax_cls, cfgs, batch, seed)
        tree = flat_to_tree(self.flat)
        jin = {k: jnp.asarray(v) for k, v in batch.items()}
        model = jax_cls(cfgs=cfgs, train_mode=True)

        def loss_of(params):
            out, updates = model.apply({**tree, "params": params}, jin, mutable=["batch_stats"])
            loss, _ = jax_module.loss_fn(out, jin, JConfig(cfgs))
            return loss, (updates, {k: out[k] for k in ("flow_2d", "flow_3d") if k in out})

        with port_selection_rule():
            (loss, (updates, flows)), grads = jax.jit(
                jax.value_and_grad(loss_of, has_aux=True))(tree["params"])
        self.own_rule_loss = float(jax.jit(loss_of)(tree["params"])[0]) if points else None
        tx = jax_optimizer_factory(JConfig(training), tree["params"], steps_per_epoch=4)

        @jax.jit
        def update(grads, params):  # one jit: eager, each leaf's ops compile apart
            step, _ = tx.update(grads, tx.init(params), params)
            return optax.apply_updates(params, step), jax_grad_norms(grads)

        params, norms = update(grads, tree["params"])
        self.ref = {
            "loss": float(loss), "grads": tree_to_flat(jax.tree.map(np.asarray, grads)),
            "stats": tree_to_flat(jax.tree.map(np.asarray, updates)),
            "params": tree_to_flat(jax.tree.map(np.asarray, params)),
            "norms": {k: float(v) for k, v in norms.items()},
            "flows": jax.tree.map(np.asarray, flows)}

        self.port = self.bridged(cfgs).train()
        self.optimizer = optimizer_factory(training, self.port, steps_per_epoch=4,
                                           model_name=name)
        loss, _, self.telemetry = train_step(self.port, self.optimizer, self.torch_batch(),
                                             torch_module.loss_fn, cfgs, step=0, model_name=name)
        self.loss = float(loss)
        self.shapes = {k: tuple(v.shape) for k, v in self.port.state_dict().items()}

    def bridged(self, cfgs):
        port = self.torch_cls(cfgs)
        load_jax_variables(port, self.flat, self.name)
        return port

    def torch_batch(self):
        return {k: torch.from_numpy(v) for k, v in self.batch.items()}

    def port_view(self, path, value):
        """A JAX leaf in the port's layout, with the port's name."""
        key = our_path_to_torch(path.split("/", 1)[1], self.name)
        return key, relayout(value, self.shapes[key]) if path.endswith("/kernel") else value

    def check_loss(self):
        assert np.isfinite(self.loss)
        np.testing.assert_allclose(self.loss, self.ref["loss"], rtol=1e-5)

    def check_loss_under_the_jax_selection_rule(self):
        """The JAX package's own step (its own selection rule) gives the
        port's loss to 1e-5 relative: the near-ties move it less."""
        np.testing.assert_allclose(self.loss, self.own_rule_loss, rtol=1e-5)

    def check_gradients(self):
        """Every parameter's gradient, as the port's step left it (clipped
        to the global norm), against the JAX gradient times the same clip."""
        grads = self.ref["grads"]
        norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                           for g in grads.values()))
        factor = min(1.0, float(self.training["grad_max_norm"]) / norm)
        params = dict(self.port.named_parameters())
        assert len(grads) == len(params)
        for path, g in grads.items():
            key, want = self.port_view("params/" + path, g * factor)
            got = params[key].grad.numpy()
            bound = 1e-3 * (1.0 + np.abs(want).max())
            assert np.abs(got - want).max() <= bound, (key, np.abs(got - want).max(), bound)

    def check_branch_grad_norms(self, branches):
        """The branches the family has parameters in (the JAX labels) have
        a norm > 0, the others none; each within 1e-4 of the JAX one."""
        for key, value in self.ref["norms"].items():
            got = float(self.telemetry[key])
            assert (got > 0) == (key[-2:] in branches), (key, got)
            np.testing.assert_allclose(got, value, rtol=1e-4)

    def check_batchnorm_statistics(self):
        """The running statistics after the step: each train-mode
        BatchNorm's biased-variance update, per call; the others' (the
        ResNet backbone's) untouched. Under `freeze_bn` no statistic moves
        on either side, bit for bit."""
        buffers = dict(self.port.named_buffers())
        if self.cfgs.get("freeze_bn", False):
            start = {k: v for k, v in self.flat.items() if k.startswith("batch_stats/")}
            assert start
            for path, value in start.items():
                key, want = self.port_view(path, value)
                np.testing.assert_array_equal(buffers[key].numpy(), want, err_msg=key)
            for path, value in self.ref["stats"].items():
                np.testing.assert_array_equal(value, start[path], err_msg=path)
            return
        assert self.ref["stats"]
        for path, value in self.ref["stats"].items():
            key, want = self.port_view(path, value)
            np.testing.assert_allclose(buffers[key].numpy(), want, rtol=1e-6, atol=1e-6,
                                       err_msg=key)

    def check_parameters_after_the_step(self):
        """Every parameter after the step within 1e-5 + lr |u_port - u_jax|
        of the JAX one, u = g / (|g| + eps) the direction of Adam's first
        step for each side's gradient g (clipped; plus Adam's L2 term). The
        step moves an element by lr u: where the two gradients have the same
        sign and |g| >> eps the bound is 1e-5; where they round to opposite
        signs it is about 2 lr; between, where |g| is near eps (1e-7 for
        PWC), the gradients' rounding difference, held above, moves the
        element by up to lr |du|. Such elements (du > 0.1) are at most 1%.
        lr is the element's group's rate at the first step: warmup_lr with a
        warm-up, lr_2d or lr_3d without."""
        params = dict(self.port.named_parameters())
        start = dict(self.bridged(self.cfgs).named_parameters())
        norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                           for g in self.ref["grads"].values()))
        factor = min(1.0, float(self.training["grad_max_norm"]) / norm)
        eps = float(self.training.get("eps", 1e-8))
        l2 = self.training["opt"] == "adam"  # torch Adam / optax add_decayed_weights
        decay = {id(p): group["weight_decay"] for group in self.optimizer.param_groups
                 for p in group["params"]}
        rates = {id(p): group["lr"] for group in self.optimizer.param_groups
                 for p in group["params"]}
        sensitive = 0
        for path, value in self.ref["params"].items():
            key, want = self.port_view("params/" + path, value)
            _, grad = self.port_view("params/" + path, self.ref["grads"][path])
            p0 = start[key].detach().numpy()
            step_dirs = []
            for g in (params[key].grad.numpy(), grad * factor):
                g = g + decay[id(params[key])] * p0 if l2 else g
                step_dirs.append(g / (np.abs(g) + eps))
            du = np.abs(step_dirs[0] - step_dirs[1])
            diff = np.abs(params[key].detach().numpy() - want)
            bound = 1e-5 + rates[id(params[key])] * du * (1 + 1e-3)
            assert (diff <= bound).all(), (key, diff.max(), (diff - bound).max())
            sensitive += int((du > 0.1).sum())
        assert sensitive <= 1e-2 * sum(p.numel() for p in params.values()), sensitive

    def check_amp(self):
        """bf16 compute (`compute_dtype: bfloat16`, what `training.amp`
        sets): both losses finite and within 5e-2 relative of their f32
        losses (the frameworks cast at different points: no bit parity)."""
        cfgs = {**self.cfgs, "compute_dtype": "bfloat16"}
        jin = {k: jnp.asarray(v) for k, v in self.batch.items()}
        model = self.jax_cls(cfgs=cfgs, train_mode=True)
        with port_selection_rule():
            out, _ = jax.jit(lambda v: model.apply(v, jin, mutable=["batch_stats"]))(
                flat_to_tree(self.flat))
        jax_amp = float(self.jax_module.loss_fn(out, jin, JConfig(cfgs))[0])
        with torch.no_grad():
            outputs = self.bridged(cfgs).train()(self.torch_batch())
        port_amp = float(self.torch_module.loss_fn(outputs, self.torch_batch(), cfgs)[0])
        for amp, f32 in ((jax_amp, self.ref["loss"]), (port_amp, self.loss)):
            assert np.isfinite(amp)
            assert abs(amp - f32) <= 5e-2 * abs(f32), (amp, f32)
        return outputs
