"""The port's training step (engine.py: TrainState, init_state, train_step)
against the JAX package's, on PoseResNet-18 at 64x64 crops (2 frames x 4
views, 4 joints, float32), from JAX's ``init_state`` weights through
``convert.from_flax``, on one batch made from a numpy seed:

  * step-1 gradients of the port's loss (``Engine.loss_and_grads``)
    against ``jax.grad`` of the same loss (the JAX engine's masked MSE over
    the real crops), each tensor within 1e-4 of its own max |gradient|.
    Both in float64 (the model's float32 final layer aside, as in both
    frameworks): in float32 the gradients of this random-init net are
    ill-conditioned where a train-mode BN normalizes few values (layer4's
    2x2 maps) or values whose variance is below BN's epsilon (the deconv
    head's), and flax's BN, which takes the variance as E[x^2] - E[x]^2,
    loses most of their digits there;
  * the losses of steps 1-3 within rtol 1e-4;
  * the parameters after 3 steps within 3 * 2 * lr absolute.  Adam's first
    steps move each weight by about lr * sign(g) whatever |g| is, and the
    sign of a gradient that is near zero (a few hundred conv weights a
    layer here) is float noise that differs between the frameworks, so a
    weight may move the other way in each of the 3 steps: 2 * lr a step.
    A wrong update (a missing bias correction moves a weight 3.2 * lr in
    the first step) breaks it;
  * the BN running statistics after 3 steps within 1e-5, on a run started
    at a step where the staircase LR has decayed to 0 in float32 (LR *
    0.1 ** 50), so the weights stay put and only the statistics move: the
    3 updates of the biased batch variance.  nn.BatchNorm2d's unbiased one
    is 3% off at layer4's 2x2 maps (n = 32) and misses by ~1e-3;
  * the port's init_state draws each tensor as flax does (std within 10%
    of JAX's init on the conv weights, BN and biases exact).

Port-only cases mirror tests/test_engine.py:25-207: the StepLR schedule,
the step-skip on a clipped loss and on an all-padding batch (weights, BN
statistics, Adam moments and count bit-equal; step and LR still advance),
padded frames adding no loss, TPU.REMAT equal to no REMAT on PoseResNet and
HRNet (BN statistics folded once although the rematerialized forward runs
each block's BN twice), INTEGRAL and MSE+INTEGRAL losses decreasing, and an unknown
TRAIN.LOSS raising.  Last, one step of the narrow HRNet of
tests/test_torch_hrnet.py against JAX's: loss rtol 1e-4, weights within
2 * lr, BN statistics within 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.engine import TrainState as JaxTrainState
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.models.pose_resnet import PoseResNet as FlaxPoseResNet
from multi_view_active_learning_tpu.ops import heatmap as jax_heatmap
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.engine import Engine, make_lr_schedule
from multi_view_active_learning_tpu_torch.models.convert import from_flax
from multi_view_active_learning_tpu_torch.models.layers import BatchNorm2d
from multi_view_active_learning_tpu_torch.ops.heatmap import render_gaussian_heatmaps

B, V, K, IMG, LR = 2, 4, 4, 64, 1e-5
FROZEN_STEP = 3000 * 50  # LR * 0.1 ** 50 underflows to 0 in float32



@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's many small CPU steps: under
    the suite's parallel workers, torch's default of one thread per core
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configure(cfg, img=IMG, **train):
    cfg.DATA.NUM_JOINTS = K
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = img
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.TRAIN.OPTIM.LR = LR
    for key, value in train.items():
        setattr(cfg.TRAIN, key, value)
    return cfg


def _batch(seed=0, b=B, v=V, img=IMG):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, v, img, img, 3)).astype(np.float32)
    kp = rng.uniform(2, img - 2, size=(b, v, K, 2)).astype(np.float32)
    gt = render_gaussian_heatmaps(torch.from_numpy(kp / 4), img // 4, img // 4, 2.0).numpy()
    pvjv = rng.random((b, v, K)) > 0.2
    return images, gt, pvjv, np.ones(b, bool)


def _jax_batch(batch):
    images, gt, pvjv, fv = batch
    return (jnp.asarray(images), jnp.asarray(np.moveaxis(gt, 2, -1)), jnp.asarray(pvjv),
            jnp.asarray(fv))


def _to_torch(state):
    return from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))


def _from_flax64(grads):
    """from_flax's names and layouts, keeping float64."""
    shapes = from_flax(grads, {})
    flat = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                flat[path + (key,)] = value

    walk(grads, ())
    out = {}
    for name, ref in zip(shapes, flat.values()):
        arr = np.asarray(ref, np.float64)
        if arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1] if name.startswith(
                "deconv_layers") else np.transpose(arr, (3, 2, 0, 1))
        out[name] = np.array(arr, dtype=np.float64, order="C")  # own, writable copy
    return out


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def jax_ref(batch):
    """JAX's init weights, its 3-step run, its 3 frozen-LR steps and the
    step-1 gradients."""
    engine = JaxEngine(_configure(jax_configs()))
    jbatch = _jax_batch(batch)
    state = engine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3))
    init = _to_torch(state)
    params64, stats64 = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), jax.device_get((state.params, state.batch_stats)))
    with jax.enable_x64(True):
        model64 = FlaxPoseResNet(num_joints=K, num_layers=18, dtype=jnp.float64)
        images, gt, pvjv, fv = (jnp.asarray(a) for a in
                                (batch[0], np.moveaxis(batch[1], 2, -1), batch[2], batch[3]))

        def loss_fn(params):
            out, _ = model64.apply({"params": params, "batch_stats": stats64},
                                   images.reshape((B * V,) + images.shape[2:]), train=True,
                                   mutable=["batch_stats"])
            mask = (pvjv & fv[:, None, None]).reshape(B * V, 1, 1, -1)
            return jax_heatmap.heatmap_mse_loss(out, gt.reshape((B * V,) + gt.shape[2:]), mask,
                                                num_samples=jnp.maximum(jnp.sum(fv) * V, 1.0))

        grads = jax.jit(jax.grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray, params64))
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(grads))
    grads = {name: torch.from_numpy(v) for name, v in _from_flax64(grads).items()}
    losses = []
    for _ in range(3):  # train_step donates its state
        state, metrics = engine.train_step(state, *jbatch)
        losses.append(float(metrics["loss"]))
    after = _to_torch(state)
    state = engine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3))
    state = state.replace(step=jnp.asarray(FROZEN_STEP, state.step.dtype))
    for _ in range(3):
        state, metrics = engine.train_step(state, *jbatch)
        assert float(metrics["lr"]) == 0.0
    frozen = _to_torch(state)
    return dict(init=init, grads=grads, losses=losses, after=after, frozen=frozen)


@pytest.fixture(scope="module")
def engine():
    return Engine(_configure(get_default_configs()), device="cpu")


def test_gradients_match_jax(batch, jax_ref):
    engine = Engine(_configure(get_default_configs()), device="cpu")
    engine.model.double()
    engine.model.compute_dtype = torch.float64
    params = {n: jax_ref["init"][n].double() for n in engine.param_names}
    _, grads = engine.loss_and_grads(types.SimpleNamespace(params=params), *batch)
    assert set(grads) == set(jax_ref["grads"])
    for name, g in grads.items():
        ref = jax_ref["grads"][name]
        scale = float(ref.abs().max())
        assert scale > 0, name
        err = float((g - ref).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_three_steps_match_jax(engine, batch, jax_ref):
    state = engine.state_from_state_dict(jax_ref["init"])
    losses = []
    for _ in range(3):
        state, metrics = engine.train_step(state, *batch)
        assert not bool(metrics["skipped"])
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jax_ref["losses"], rtol=1e-4)
    assert int(state.step) == 3 and int(state.count) == 3
    for name, p in state.params.items():
        err = float((p - jax_ref["after"][name]).abs().max())
        assert err <= 3 * 2 * LR, (name, err)


def test_bn_statistics_after_three_steps_match_jax(engine, batch, jax_ref):
    state = engine.state_from_state_dict(jax_ref["init"], step=FROZEN_STEP)
    for _ in range(3):
        state, metrics = engine.train_step(state, *batch)
        assert float(metrics["lr"]) == 0.0
    for name, p in state.params.items():
        assert torch.equal(p, jax_ref["init"][name]), name
    assert set(state.buffers) == {n for n in jax_ref["frozen"] if "running" in n}
    errs = {name: (stat - jax_ref["frozen"][name]).abs() for name, stat in state.buffers.items()}
    worst = max(errs, key=lambda name: float(errs[name].max()))
    i = int(errs[worst].argmax())
    assert float(errs[worst].max()) <= 1e-5, (
        worst, "port", float(state.buffers[worst].reshape(-1)[i]),
        "jax", float(jax_ref["frozen"][worst].reshape(-1)[i]))


def test_init_state_draws_as_flax(engine, jax_ref):
    state = engine.init_state(torch.Generator().manual_seed(0))
    for name, p in state.params.items():
        ref = jax_ref["init"][name]
        assert p.shape == ref.shape, name
        if p.dim() == 1:  # BN scale / bias, the final layer's bias
            assert torch.equal(p, ref), name
        else:
            ratio = float(p.std()) / float(ref.std())
            assert abs(ratio - 1.0) < 0.1, (name, ratio)
            assert float(p.abs().max()) <= 2.0 * float(p.std()) * 1.25 or p.numel() < 100 \
                or name.startswith(("deconv_layers", "final_layer")), name
    for name, stat in state.buffers.items():
        assert torch.equal(stat, jax_ref["init"][name]), name


# -- port-only cases, after tests/test_engine.py ------------------------------


def _small_engine(**train):
    return Engine(_configure(get_default_configs(), img=32, **train), device="cpu")


def _small_batch(seed=0):
    return _batch(seed, b=2, v=2, img=32)


def _snapshot(state):
    return {key: {n: t.clone() for n, t in getattr(state, key).items()}
            for key in ("params", "buffers", "mu", "nu")}, int(state.count)


def _assert_same(snapshot, state):
    tensors, count = snapshot
    for key, named in tensors.items():
        for name, t in named.items():
            assert torch.equal(t, getattr(state, key)[name]), (key, name)
    assert int(state.count) == count


def test_lr_schedule_steplr_semantics():
    cfg = _configure(get_default_configs())
    cfg.TRAIN.OPTIM.LR = 0.001
    cfg.TRAIN.OPTIM.LR_DECAY_STEP_SIZE = 3000
    sched = make_lr_schedule(cfg)
    for step, lr in ((0, 1e-3), (2999, 1e-3), (3000, 1e-4), (6000, 1e-5)):
        assert abs(float(sched(step)) - lr) < 1e-9
    assert float(sched(torch.tensor(FROZEN_STEP))) == 0.0


def test_train_step_skips_on_loss_clip():
    engine = _small_engine(LOSS_CLIP_VALUE=0.0)
    state = engine.init_state(torch.Generator().manual_seed(0))
    before = _snapshot(state)
    state, metrics = engine.train_step(state, *_small_batch())
    assert bool(metrics["skipped"]) and float(metrics["loss"]) > 0
    _assert_same(before, state)
    assert int(state.step) == 1


def test_lr_schedule_advances_across_skipped_steps():
    engine = _small_engine(LOSS_CLIP_VALUE=1e-12)
    engine.cfg.TRAIN.OPTIM.LR = 0.001
    engine.cfg.TRAIN.OPTIM.LR_DECAY_STEP_SIZE = 2
    engine.lr_schedule = make_lr_schedule(engine.cfg)
    state = engine.init_state()
    lrs = []
    for _ in range(4):
        state, metrics = engine.train_step(state, *_small_batch())
        assert bool(metrics["skipped"])
        lrs.append(float(metrics["lr"]))
    np.testing.assert_allclose(lrs, [1e-3, 1e-3, 1e-4, 1e-4], rtol=1e-6)
    assert int(state.count) == 0 and int(state.step) == 4


def test_all_padding_batch_applies_no_update():
    engine = _small_engine()
    state = engine.init_state()
    images, gt, pvjv, fv = _small_batch()
    # A real step first, so that Adam's moments are not zero.
    state, metrics = engine.train_step(state, images, gt, pvjv, fv)
    assert not bool(metrics["skipped"])
    before = _snapshot(state)
    state, metrics = engine.train_step(state, images, gt, pvjv, np.zeros(2, bool))
    assert bool(metrics["skipped"])
    _assert_same(before, state)
    assert int(state.step) == 2


def test_padded_frames_contribute_zero_loss():
    """A batch padded with a copy of its real frame trains like the
    pad-free batch: the copy leaves the BN statistics as they are, the
    padding adds no loss and the denominator counts the real crops."""
    engine = _small_engine()
    images, gt, pvjv, _ = _small_batch()
    images = np.concatenate([images[:1], images[:1]])
    gt = np.concatenate([gt[:1], gt[:1]])
    _, half = engine.train_step(engine.init_state(), images, gt, pvjv, np.array([True, False]))
    _, solo = engine.train_step(engine.init_state(), images[:1], gt[:1], pvjv[:1],
                                np.ones(1, bool))
    np.testing.assert_allclose(float(half["loss"]), float(solo["loss"]), rtol=1e-5)


@pytest.mark.parametrize("model", ["POSE_RESNET", "HRNET"])
def test_remat_matches_no_remat_and_folds_bn_once(model):
    def make(remat):
        if model == "HRNET":
            cfg = _narrow_hrnet(get_default_configs())
        else:
            cfg = _configure(get_default_configs(), img=32)
        cfg.TPU.REMAT = remat
        return Engine(cfg, device="cpu")

    plain, remat = make(False), make(True)
    calls = {}
    for name, module in remat.model.named_modules():
        if isinstance(module, BatchNorm2d):
            module.register_forward_hook(
                lambda m, i, o, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    batch = _batch(0, b=2, v=2) if model == "HRNET" else _small_batch()
    sa, ma = plain.train_step(plain.init_state(), *batch)
    sb, mb = remat.train_step(remat.init_state(), *batch)
    # The rematerialized blocks ran their BNs twice; the stem's once.
    assert calls["layer1.0.bn1"] == 2 and calls["bn1"] == 1, calls
    assert abs(float(ma["loss"]) - float(mb["loss"])) < 1e-6
    for key in ("params", "buffers", "mu", "nu"):
        for name, t in getattr(sa, key).items():
            torch.testing.assert_close(getattr(sb, key)[name], t, atol=1e-6, rtol=0)


@pytest.mark.parametrize("loss_type", ["INTEGRAL", "MSE+INTEGRAL"])
def test_integral_losses_decrease(loss_type):
    engine = _small_engine(LOSS=loss_type)
    engine.cfg.TRAIN.OPTIM.LR = 0.002
    engine.lr_schedule = make_lr_schedule(engine.cfg)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)
    kp = torch.from_numpy(rng.uniform(1, 7, size=(2, 2, K, 2)).astype(np.float32))
    gt = render_gaussian_heatmaps(kp, 8, 8, 1.0).numpy()
    state, losses = engine.init_state(), []
    for _ in range(8):
        state, metrics = engine.train_step(state, images, gt, np.ones((2, 2, K), bool),
                                           np.ones(2, bool))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] and not any(np.isnan(losses)), losses


def test_unknown_loss_raises():
    engine = _small_engine(LOSS="BOGUS")
    with pytest.raises(NotImplementedError):
        engine.train_step(engine.init_state(), *_small_batch())


# -- HRNet -----------------------------------------------------------------------


def _narrow_hrnet(cfg):
    _configure(cfg)
    cfg.POSE_ESTIMATOR.TYPE = "HRNET"
    hr = cfg.POSE_ESTIMATOR.HRNET
    for stage, modules, widths in ((hr.STAGE2, 1, [8, 16]), (hr.STAGE3, 2, [8, 16, 32]),
                                   (hr.STAGE4, 1, [8, 16, 32, 64])):
        stage.NUM_MODULES, stage.NUM_BRANCHES = modules, len(widths)
        stage.NUM_BLOCKS, stage.NUM_CHANNELS = [1] * len(widths), widths
    return cfg


def test_hrnet_train_step_matches_jax():
    """From the port's init (JAX's own init jit costs more than the step)."""
    engine = Engine(_narrow_hrnet(get_default_configs()), device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(1))
    params, stats = jax_convert.torch_state_dict_to_flax(
        {k: v.numpy() for k, v in state.state_dict().items()}, "HRNET")
    jengine = JaxEngine(_narrow_hrnet(jax_configs()))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=jengine.tx.init(params))
    batch = _batch(5, b=2, v=2)
    jstate, jmetrics = jengine.train_step(jstate, *_jax_batch(batch))
    ref = from_flax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats), "HRNET")
    state, metrics = engine.train_step(state, *batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    for name, p in state.params.items():
        assert float((p - ref[name]).abs().max()) <= 2 * LR, name
    for name, stat in state.buffers.items():
        assert float((stat - ref[name]).abs().max()) <= 1e-5, name
