"""The port's checkpoints (utils/checkpoint.py), in the reference's ``.pth``
format:

  * save -> restore (TRAIN.RESTORE_FROM's true resume) -> the next step
    gives the uninterrupted run's weights, BN statistics, Adam moments and
    count and step, bit for bit (the same CPU ops on the same values);
  * the file is the reference's dict: ``module.``-prefixed state dict with a
    ``num_batches_tracked`` per BN, ``global_step``, ``epoch``, and Adam's
    state in torch.optim.Adam's layout;
  * ``restore_params_only`` brings back weights and BN statistics and
    leaves the template's fresh optimizer and step;
  * a JAX orbax checkpoint exported by ``tools/export_checkpoint.py`` (run
    here on the CPU), with the ``module.`` prefix and without it, loads
    through ``restore_params_only`` (every tensor) and through
    TRAIN.INIT_WEIGHT (``load_pretrained``: PoseResNet's final layer
    dropped, the rest loaded), and the port's forward on it equals the JAX
    forward on the checkpoint's weights within 1e-4 of the heatmaps' scale
    (float32 convolutions summed in another order).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.engine import TrainState as JaxTrainState
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.utils import checkpoint as jax_ckpt
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.engine import Engine
from multi_view_active_learning_tpu_torch.ops.heatmap import render_gaussian_heatmaps
from multi_view_active_learning_tpu_torch.utils import checkpoint as ckpt

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import export_checkpoint  # noqa: E402

K, IMG = 4, 32



@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's many small CPU steps: under
    the suite's parallel workers, torch's default of one thread per core
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configure(cfg):
    cfg.DATA.NUM_JOINTS = K
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = IMG
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.TRAIN.OPTIM.LR = 1e-3
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(2, 2, IMG, IMG, 3)).astype(np.float32)
    kp = torch.from_numpy(rng.uniform(2, IMG - 2, size=(2, 2, K, 2)).astype(np.float32))
    gt = render_gaussian_heatmaps(kp / 4, IMG // 4, IMG // 4, 2.0).numpy()
    return images, gt, rng.random((2, 2, K)) > 0.2, np.ones(2, bool)


@pytest.fixture(scope="module")
def engine():
    return Engine(_configure(get_default_configs()), device="cpu")


def _assert_states_equal(a, b):
    for key in ("params", "buffers", "mu", "nu"):
        for name, t in getattr(a, key).items():
            assert torch.equal(t, getattr(b, key)[name]), (key, name)
    assert int(a.step) == int(b.step) and int(a.count) == int(b.count)


def test_resume_continues_the_uninterrupted_run(engine, tmp_path):
    state = engine.init_state(torch.Generator().manual_seed(0))
    for seed in (0, 1):
        state, _ = engine.train_step(state, *_batch(seed))
    path = str(tmp_path / "checkpoints" / "CKPT-E2-MKPE1.00")
    ckpt.save_checkpoints([path, str(tmp_path / "checkpoints" / "CKPT-FINAL")], state, epoch=1,
                          lr=1e-3)
    assert ckpt.checkpoint_exists(path)
    uninterrupted, _ = engine.train_step(state, *_batch(2))
    resumed = ckpt.restore_checkpoint(str(tmp_path / "checkpoints" / "CKPT-FINAL"),
                                      engine.init_state(torch.Generator().manual_seed(9)))
    assert int(resumed.step) == 2 and int(resumed.count) == 2
    resumed, _ = engine.train_step(resumed, *_batch(2))
    _assert_states_equal(resumed, uninterrupted)

    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"epoch", "global_step", "state_dict", "optimizer"}
    assert saved["epoch"] == 1 and saved["global_step"] == 2
    sd = saved["state_dict"]
    assert all(k.startswith("module.") for k in sd)
    assert int(sd["module.bn1.num_batches_tracked"]) == 2
    assert len(saved["optimizer"]["state"]) == len(engine.param_names)
    assert saved["optimizer"]["param_groups"][0]["lr"] == 1e-3
    model = engine.model.__class__(K, 18)
    model.load_state_dict({k[len("module."):]: v for k, v in sd.items()}, strict=True)


def test_restore_params_only_keeps_a_fresh_optimizer(engine, tmp_path):
    state = engine.init_state(torch.Generator().manual_seed(0))
    state, _ = engine.train_step(state, *_batch(0))
    path = ckpt.save_checkpoint(str(tmp_path / "CKPT-FINAL"), state)
    fresh = engine.init_state(torch.Generator().manual_seed(3))
    restored = ckpt.restore_params_only(path, fresh)
    for name, t in state.state_dict().items():
        assert torch.equal(restored.state_dict()[name], t), name
    assert int(restored.step) == 0 and int(restored.count) == 0
    assert all(float(t.abs().max()) == 0.0 for t in restored.mu.values())
    assert all(float(t.abs().max()) == 0.0 for t in restored.nu.values())


@pytest.fixture(scope="module")
def exported(engine, tmp_path_factory):
    """A JAX orbax checkpoint of a trained-looking state, exported to .pth
    with the module. prefix and without it; and the JAX forward on it."""
    tmp = tmp_path_factory.mktemp("export")
    weights = engine.init_state(torch.Generator().manual_seed(0)).state_dict()
    weights = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
               for k, v in weights.items()}
    weights = {k: (v.abs() + 0.5 if k.endswith("running_var") else v) for k, v in weights.items()}
    params, stats = jax_convert.torch_state_dict_to_flax(
        {k: v.numpy() for k, v in weights.items()}, "POSE_RESNET")
    jcfg = _configure(jax_configs())
    jengine = JaxEngine(jcfg)
    jstate = JaxTrainState(step=jnp.asarray(7, jnp.int32), params=params, batch_stats=stats,
                           opt_state=jengine.tx.init(params))
    orbax_dir = jax_ckpt.save_checkpoint(str(tmp / "CKPT-FINAL"), jstate)
    paths = {}
    payload = export_checkpoint.export_checkpoint(jcfg, orbax_dir, str(tmp / "prefixed.pth"))
    paths["prefixed"] = str(tmp / "prefixed.pth")
    payload["state_dict"] = {k[len("module."):]: v for k, v in payload["state_dict"].items()}
    torch.save(payload, str(tmp / "bare.pth"))
    paths["bare"] = str(tmp / "bare.pth")
    images = np.random.default_rng(4).integers(0, 256, size=(1, 3, IMG, IMG, 3)).astype(np.uint8)
    ref = np.asarray(jengine.forward(params, stats, jnp.asarray(images), use_int8=False))
    return weights, paths, images, np.moveaxis(ref, -1, 2)


@pytest.mark.parametrize("variant", ["prefixed", "bare"])
def test_exported_jax_checkpoint_loads(engine, exported, variant):
    weights, paths, images, ref = exported
    target = engine.init_state(torch.Generator().manual_seed(5))
    restored = ckpt.restore_params_only(paths[variant], target)
    for name, t in restored.state_dict().items():
        assert torch.equal(t, weights[name]), name
    engine.use_state(restored)
    got = engine.forward(images).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()

    cfg = _configure(get_default_configs())
    pretrained = ckpt.load_pretrained(cfg, paths[variant], target)
    for name, t in pretrained.state_dict().items():
        want = target.state_dict()[name] if name.startswith("final_layer.") else weights[name]
        assert torch.equal(t, want), name
