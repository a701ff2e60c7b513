"""PyTorch port, training pieces against the JAX package on the CPU: the
sequence and pyramid losses, the metrics and their float64 reduction, the
flow resize, the BatchNorm's train-mode running statistics, the compute
precision switch, the optimizer's 4-group partition, the timm cosine
schedule and one clipped AdamW (and Adam + L2) step against optax.

The same numpy inputs (made from a seed) go through the JAX function and
its counterpart in camliflow_torch. Losses and metrics agree to 1e-6
relative; the optimizer step to 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from camliflow_tpu.models import camliraft as jm
from camliflow_tpu.models import factory as jfactory
from camliflow_tpu.models import losses as jlosses
from camliflow_tpu.models import metrics as jmetrics
from camliflow_tpu.ops import image as jimage
from camliflow_tpu.runtime.checkpoint import tree_to_flat
from camliflow_tpu.utils.config import Config as JConfig
from camliflow_torch.models import camliraft as tm
from camliflow_torch.models import factory
from camliflow_torch.models import losses, metrics
from camliflow_torch.nn import layers
from camliflow_torch.ops import image as timage
from camliflow_torch.runtime.names import our_path_to_torch
from camliflow_torch.runtime.train_state import branch_grad_norms
from camliflow_torch.utils.profiling import BadLossChecker

torch.set_num_threads(2)
RTOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def flows(seed, dim, masked, n_preds=None):
    """(predictions [T, B, ..., dim] or [B, ..., dim], target with an
    optional validity channel)."""
    rng = np.random.RandomState(seed)
    shape = (2, 9, 11) if dim == 2 else (2, 300)
    pred = rng.randn(*((n_preds,) if n_preds else ()), *shape, dim).astype(np.float32)
    target = rng.randn(*shape, dim).astype(np.float32)
    if masked:
        valid = (rng.rand(*shape, 1) > 0.3).astype(np.float32)
        target = np.concatenate([target, valid], -1)
    return pred, target


def close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("order", ["l2-norm", "l1", "robust"])
@pytest.mark.parametrize("dim", [2, 3])
def test_calc_sequence_loss(dim, order, masked):
    pred, target = flows(0, dim, masked, n_preds=4)
    ref = jlosses.calc_sequence_loss(jnp.asarray(pred), jnp.asarray(target), 0.8, order)
    got = losses.calc_sequence_loss(t(pred), t(target), 0.8, order)
    close(float(got), float(ref))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("order", ["l2-norm", "robust"])
def test_calc_pyramid_loss_2d(order, masked):
    rng = np.random.RandomState(1)
    _, target = flows(1, 2, masked)
    levels = [rng.randn(2, h, w, 2).astype(np.float32) for h, w in ((9, 11), (5, 6), (3, 3))]
    weights = [8.0, 4.0, 2.0]
    ref = jlosses.calc_pyramid_loss_2d([jnp.asarray(x) for x in levels], jnp.asarray(target),
                                       weights, order)
    got = losses.calc_pyramid_loss_2d([t(x) for x in levels], t(target), weights, order)
    close(float(got), float(ref))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("order", ["l2-norm", "robust"])
def test_calc_pyramid_loss_3d(order, masked):
    rng = np.random.RandomState(2)
    _, target = flows(2, 3, masked)
    sizes = (300, 128, 64)
    levels = [rng.randn(2, n, 3).astype(np.float32) for n in sizes]
    indices = [np.stack([rng.permutation(300)[:n] for _ in range(2)]).astype(np.int32)
               for n in sizes]
    weights = [8.0, 4.0, 2.0]
    ref = jlosses.calc_pyramid_loss_3d([jnp.asarray(x) for x in levels], jnp.asarray(target),
                                       weights, order, [jnp.asarray(i) for i in indices])
    got = losses.calc_pyramid_loss_3d([t(x) for x in levels], t(target), weights, order,
                                      [t(i) for i in indices])
    close(float(got), float(ref))


@pytest.mark.parametrize("size", [(9, 11), (18, 22), (4, 7)])
def test_resize_flow2d(size):
    flow = np.random.RandomState(3).randn(2, 9, 11, 2).astype(np.float32)
    ref = jimage.resize_flow2d(jnp.asarray(flow), *size)
    got = timage.resize_flow2d(t(flow), *size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def metric_cases():
    """(name, JAX function, port function, args) for each metric form."""
    rng = np.random.RandomState(4)
    pred2, t2 = flows(4, 2, False)
    t2 = 3.0 * t2
    _, t2m = flows(5, 2, True)
    pred3, t3 = flows(6, 3, False)
    _, t3m = flows(7, 3, True)
    occ = (rng.rand(2, 300) > 0.7).astype(np.float32)
    # some 2D errors beyond 3 px and some 3D ones under 5 cm
    pred2 = pred2 * 4.0
    pred3 = t3 + 0.04 * pred3
    return {
        "2d": (jmetrics.compute_2d_metrics, metrics.compute_2d_metrics, (pred2, t2)),
        "2d_masked": (jmetrics.compute_2d_metrics, metrics.compute_2d_metrics, (pred2, t2m)),
        "3d": (jmetrics.compute_3d_metrics, metrics.compute_3d_metrics, (pred3, t3)),
        "3d_masked": (jmetrics.compute_3d_metrics, metrics.compute_3d_metrics,
                      (pred3, np.concatenate([t3, t3m[..., 3:]], -1))),
        "3d_occluded": (jmetrics.compute_3d_metrics, metrics.compute_3d_metrics,
                        (pred3, t3, occ)),
    }


@pytest.mark.parametrize("case", ["2d", "2d_masked", "3d", "3d_masked", "3d_occluded"])
def test_metrics_and_finalize(case):
    """(sum, count) pairs, merged over two batches, then finalize_metrics."""
    jfn, tfn, args = metric_cases()[case]
    ref = jmetrics.merge_metrics(jfn(*map(jnp.asarray, args)),
                                 jfn(*(jnp.asarray(a[::-1]) for a in args)))
    got = metrics.merge_metrics(tfn(*map(t, args)), tfn(*(t(a[::-1].copy()) for a in args)))
    assert set(got) == set(ref)
    for key in ref:
        close(float(got[key][0]), float(ref[key][0]))
        assert float(got[key][1]) == float(ref[key][1])
    final_ref = jmetrics.finalize_metrics(ref)
    final_got = metrics.finalize_metrics(got)
    assert set(final_got) == set(final_ref)
    for key in final_ref:
        assert isinstance(final_got[key], float)
        close(final_got[key], final_ref[key])


def test_scalar_metric_and_loss_fn_keys():
    """The flagship's loss_fn: the same keys as the JAX one, and the loss
    the sum of its two sequence losses."""
    pred2, t2 = flows(8, 2, True, n_preds=3)
    pred3, t3 = flows(9, 3, False, n_preds=3)
    occ = np.zeros((2, 300), np.float32)
    cfgs = {"loss2d": {"gamma": 0.8, "order": "l2-norm"},
            "loss3d": {"gamma": 0.9, "order": "l1"}}
    outputs = {"flow_2d_seq": pred2, "flow_3d_seq": pred3, "flow_2d": pred2[-1],
               "flow_3d": pred3[-1]}
    inputs = {"flow_2d": t2, "flow_3d": t3, "occ_mask_3d": occ}
    jloss, jmet = jm.loss_fn({k: jnp.asarray(v) for k, v in outputs.items()},
                             {k: jnp.asarray(v) for k, v in inputs.items()}, JConfig(cfgs))
    loss, met = tm.loss_fn({k: t(v) for k, v in outputs.items()},
                           {k: t(v) for k, v in inputs.items()}, cfgs)
    close(float(loss), float(jloss))
    assert set(met) == set(jmet)
    for key in jmet:
        close(float(met[key][0]), float(jmet[key][0]))
    assert tm.is_better({"epe2d": 1.0}, None) and tm.is_better({"epe2d": 1.0}, {"epe2d": 2.0})
    assert not tm.is_better({"epe2d": 2.0}, {"epe2d": 1.0})


@pytest.mark.parametrize("shape", [(64, 7), (2, 30, 7), (2, 5, 6, 7)])
def test_batchnorm_train_updates_running_stats_as_flax(shape):
    """Train mode: batch statistics, and the running variance moved toward
    the BIASED batch variance, momentum 0.1 (Flax 0.9); eval: the running
    statistics. To 1e-6."""
    import flax.linen as fnn

    rng = np.random.RandomState(10)
    x = (3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)
    mean0 = (0.1 * rng.randn(7)).astype(np.float32)
    var0 = (1.0 + rng.rand(7)).astype(np.float32)
    scale = (1.0 + 0.2 * rng.randn(7)).astype(np.float32)
    bias = (0.1 * rng.randn(7)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    ref, updates = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = layers.BatchNorm(7)
    with torch.no_grad():
        for name, value in (("weight", scale), ("bias", bias), ("running_mean", mean0),
                            ("running_var", var0)):
            getattr(port, name).copy_(t(value))
    got = port.train()(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(updates["batch_stats"][key]), rtol=1e-6, atol=1e-6)
    # eval: the (updated) running statistics
    ref_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": updates["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(port.eval()(t(x)).detach().numpy(), np.asarray(ref_eval),
                               rtol=1e-5, atol=1e-5)


def test_compute_precision_raises_on_an_unknown_dtype():
    """bf16 autocast for "bfloat16", nothing for None/"float32"; "bf16",
    which the JAX package turns into f32 without a word, raises."""
    lin = torch.nn.Linear(4, 4)
    x = torch.randn(3, 4)
    with layers.compute_precision("bfloat16", "cpu"):
        assert lin(x).dtype == torch.bfloat16
        with layers.full_precision("cpu"):
            assert lin(x).dtype == torch.float32
    for dtype in (None, "float32"):
        with layers.compute_precision(dtype, "cpu"):
            assert lin(x).dtype == torch.float32
    with pytest.raises(ValueError, match="bf16"):
        layers.compute_precision("bf16", "cpu")
    with pytest.raises(ValueError, match="bf16"):
        tm.CamLiRAFT({**small_cfgs(), "compute_dtype": "bf16"})


def test_bad_loss_checker():
    checker = BadLossChecker(threshold=10.0, patience=3)
    assert [checker.check(v) for v in (1.0, float("nan"), 11.0, 1.0, float("inf"),
                                       -20.0, 50.0)] == [False] * 6 + [True]


# --- the optimizer ----------------------------------------------------------


def small_cfgs(**overrides):
    cfgs = {"name": "camliraft", "backbone": {"depth": 18}, "n_iters_eval": 1,
            "n_iters_train": 1, "fast_inference": "auto", "freeze_bn": False,
            "fuse_fnet": True, "fuse_cnet": True, "fuse_corr": True, "fuse_motion": True,
            "fuse_hidden": True, "n_samples_list": [256, 128, 64, 32, 16]}
    return {**cfgs, **overrides}


@pytest.fixture(scope="module")
def flagship_params():
    """The JAX flagship's parameter tree (shapes only; every fusion point on,
    hidden included) and the port's model."""
    from test_models_forward import make_inputs

    cfgs = small_cfgs()
    model = jm.CamLiRAFT(cfgs=cfgs, train_mode=True)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            make_inputs(np.random.RandomState(0)))["params"]
    return shapes, tm.CamLiRAFT(cfgs)


def test_param_partition_matches_jax_name_by_name(flagship_params):
    """Every parameter lands in the group the JAX package gives it
    (`param_group_label` on the JAX module path), and every port parameter
    is a JAX one."""
    shapes, port = flagship_params
    params = dict(port.named_parameters())
    labelled = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jfactory.param_group_label(
            tuple(getattr(p, "key", str(p)) for p in path), leaf), shapes)
    seen = set()
    for path, label in tree_to_flat(labelled).items():
        name = our_path_to_torch(path, "camliraft")
        assert name in params, path
        assert factory.param_group_label(name, params[name], "camliraft") == label, name
        seen.add(name)
    assert seen == set(params)
    groups = {factory.param_group_label(n, p, "camliraft") for n, p in params.items()}
    assert groups == set(factory.GROUPS)


@pytest.mark.parametrize("warmup", [0, 2, 5])
def test_timm_cosine_schedule_matches_jax(warmup):
    args = dict(base_lr=4e-4, epochs=100, steps_per_epoch=7, warmup_epochs=warmup,
                warmup_lr=1e-5, min_lr=1e-6)
    ref = jfactory.timm_cosine_schedule(**args)
    got = factory.timm_cosine_schedule(**args)
    for step in [0, 1, 6, 7, 13, 14, 20, 34, 35, 36, 350, 693, 699, 700, 1000]:
        # the JAX schedule computes in f32 (its values round to ~1e-7 of
        # base_lr, absolute); the port's in float64
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-10)
    # the golden values of timm's CosineLRScheduler, stepped once an epoch
    if warmup == 5:
        close(got(3 * 7), 1e-5 + 3 * (4e-4 - 1e-5) / 5)
        close(got(50 * 7 + 6), 1e-6 + 0.5 * (4e-4 - 1e-6) * (1 + math.cos(math.pi / 2)))


@pytest.mark.parametrize("opt", ["adamw", "adam"])
def test_clipped_step_matches_optax(flagship_params, opt):
    """One step from the same parameters and gradients (global norm 24, so
    the clip to 1 acts): optax's 4-group chain against the port's
    clip_grad_norm_ + torch.optim (AdamW; Adam with L2 before the moments),
    every parameter to 1e-6, at a learning rate past the warm-up."""
    shapes, _ = flagship_params
    training = {"opt": opt, "lr_2d": 2e-4, "lr_3d": 2e-3, "weight_decay": 1e-2,
                "grad_max_norm": 1, "epochs": 10, "warmup_epochs": 0, "min_lr": 1e-5}
    rng = np.random.RandomState(11)
    flat = {k: np.asarray(0.1 * rng.randn(*v.shape), np.float32)
            for k, v in tree_to_flat(shapes).items()}
    grads = {k: np.asarray(rng.randn(*v.shape), np.float32) for k, v in flat.items()}
    norm = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    for k in grads:
        grads[k] *= 24.0 / norm
    from camliflow_tpu.runtime.checkpoint import flat_to_tree

    jparams, jgrads = flat_to_tree(flat), flat_to_tree(grads)
    tx = jfactory.optimizer_factory(JConfig(training), jparams, steps_per_epoch=3)
    state = tx.init(jparams)
    new = jparams
    for _ in range(2):  # two steps: the second reads the moments of the first
        updates, state = tx.update(jgrads, state, new)
        new = optax.apply_updates(new, updates)
    model = torch.nn.Module()
    params = {}
    for path, value in flat.items():
        name = our_path_to_torch(path, "camliraft")
        params[name] = torch.nn.Parameter(t(value))
    model.named_parameters = lambda: iter(params.items())
    optimizer = factory.optimizer_factory(training, model, steps_per_epoch=3)
    for step in range(2):
        for path, g in grads.items():
            params[our_path_to_torch(path, "camliraft")].grad = t(g)
        torch.nn.utils.clip_grad_norm_(list(params.values()), optimizer.max_norm)
        factory.set_learning_rates(optimizer, step)
        optimizer.step()
    for path, value in tree_to_flat(jax.tree.map(np.asarray, new)).items():
        got = params[our_path_to_torch(path, "camliraft")].detach().numpy()
        np.testing.assert_allclose(got, value, rtol=1e-6, atol=1e-6, err_msg=path)


def test_branch_grad_norms_split_by_the_partition(flagship_params):
    _, port = flagship_params
    for name, param in port.named_parameters():
        param.grad = torch.full_like(param, 2.0 if "branch_3d" in name else 1.0)
    norms = branch_grad_norms(port, "camliraft")
    n3 = sum(p.numel() for n, p in port.named_parameters() if "branch_3d" in n)
    n2 = sum(p.numel() for _, p in port.named_parameters()) - n3
    close(float(norms["grad_norm_3d"]), 2.0 * math.sqrt(n3), rtol=1e-5)
    close(float(norms["grad_norm_2d"]), math.sqrt(n2), rtol=1e-5)
