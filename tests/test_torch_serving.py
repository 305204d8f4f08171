"""The port's serving export (serving.py) against the JAX package's.

Small sizes: PoseResNet-18 and a narrow HRNet, 32x32 crops, 3 views, 4
joints, float32 compute, weights with O(1) activations from seeded numpy
carried by ``from_flax``; the JAX serve functions run once per module.

  * The port's serve function against ``jax.jit(serving.build_serve_fn)``:
    heatmaps within 1e-4 of their scale (float32 convolutions summed in
    another order), keypoints equal and confidence within that atol
    wherever the map's argmax is unique (its top two values more than
    twice the atol apart).
  * A static artifact, saved and loaded in a subprocess whose import hook
    refuses JAX, the JAX package and the port's engine, models and config,
    against the eager serve function: atol 1e-5.
  * A symbolic-batch artifact called at B = 1 and 3, against eager.
  * The int8-baked artifact: the port's own calibration against the JAX
    engine's on the same uint8 batch (the same keys, rtol 0.05, the bar of
    tests/test_torch_distributed.py for that comparison: the bf16
    activations, normalization included, round apart layer by layer;
    measured here 0.67% at most, at layer4_0/conv2), and the artifact
    built with the JAX scales against JAX's int8 serve function at the bar
    of the port's int8 tests (tests/test_torch_quantize.py): cosine > 0.999
    and per-map argmax agreement >= 0.95.
  * The K3 (TPU.PALLAS_HEAD) and K4 (TPU.INT8_DECONV) artifacts, whose
    graphs call the registered kernel operators three times each (and the
    int8 one K5 once a backbone conv), against eager (the plain versions
    under the operators on the CPU): atol 1e-5.
  * ``torch.library.opcheck`` on each registered operator.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import golden_fill_values
from multi_view_active_learning_tpu import serving as jax_serving
from multi_view_active_learning_tpu.config import get_default_configs as jax_default_configs
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu_torch import serving
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.engine import Engine
from multi_view_active_learning_tpu_torch.kernels import deconv, decode
from multi_view_active_learning_tpu_torch.models.convert import from_flax, scales_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, IMG, V, B = 4, 32, 3, 2
HEAT_ATOL_OF_SCALE = 1e-4
EAGER_ATOL = 1e-5
INT8_COS, INT8_AGREE = 0.999, 0.95
INT8_SCALE_RTOL = 0.05
HRNET_STAGES = {"STAGE2": ([1, 1], [8, 16]), "STAGE3": ([1, 1, 1], [8, 16, 32]),
                "STAGE4": ([1, 1, 1, 1], [8, 16, 32, 64])}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Artifacts hold the weights: remove each test's."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _configure(cfg, model="POSE_RESNET", **tpu):
    cfg.DATA.NUM_JOINTS = K
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = IMG
    cfg.POSE_ESTIMATOR.TYPE = model
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    if model == "HRNET":
        for name, (blocks, channels) in HRNET_STAGES.items():
            stage = getattr(cfg.POSE_ESTIMATOR.HRNET, name)
            stage.NUM_MODULES, stage.NUM_BLOCKS, stage.NUM_CHANNELS = 1, blocks, channels
    for key, value in tpu.items():
        setattr(cfg.TPU, key, value)
    return cfg


def _request(batch, seed):
    """uint8 frames and non-square boxes (the keypoints' x and y scale apart)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(batch, V, IMG, IMG, 3)).astype(np.uint8)
    lt = rng.uniform(0, 50, size=(batch, V, 2))
    wh = rng.uniform(100, 300, size=(batch, V, 2))
    return images, np.concatenate([lt, lt + wh], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """{model: flax (params, batch_stats)} with O(1) activations."""
    out = {}
    for seed, model in ((5, "POSE_RESNET"), (9, "HRNET")):
        jax_engine = JaxEngine(_configure(jax_default_configs(), model))
        shapes = jax.eval_shape(
            lambda: jax_engine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3)))
        zeros = jax_convert.flax_to_torch_state_dict(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.params),
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.batch_stats),
            model)
        values = golden_fill_values(list(zeros), [a.shape for a in zeros.values()], seed)
        out[model] = jax_convert.torch_state_dict_to_flax(values, model)
    return out


def _port(weights, model="POSE_RESNET", **tpu):
    engine = Engine(_configure(get_default_configs(), model, **tpu), device="cpu")
    return engine, from_flax(*weights[model], model)


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_runs(weights):
    """JAX's jitted serve functions on one request: float for both models,
    and PoseResNet's int8 with the JAX engine's calibration of it."""
    images, box = _request(B, 0)
    runs = {}
    for model in ("POSE_RESNET", "HRNET"):
        engine = JaxEngine(_configure(jax_default_configs(), model))
        params, stats = weights[model]
        serve = jax.jit(jax_serving.build_serve_fn(engine, params, stats))
        runs[model] = _numpy(serve(jnp.asarray(images), jnp.asarray(box)))
    engine = JaxEngine(_configure(jax_default_configs(), INT8_SCORING=True))
    params, stats = weights["POSE_RESNET"]
    scales = engine.int8_calibrate(params, stats, jnp.asarray(images))
    serve = jax.jit(jax_serving.build_serve_fn(engine, params, stats, int8_scales=scales))
    runs["int8"] = _numpy(serve(jnp.asarray(images), jnp.asarray(box)))
    runs["int8_scales"] = {k: np.asarray(v) for k, v in scales.items()}
    return images, box, runs


def _unique_argmax(heatmaps, atol):
    """[..., h, w, K] -> [..., K]: the map's top two values lie more than
    2 atol apart."""
    flat = np.moveaxis(heatmaps, -1, -3).reshape(heatmaps.shape[:-3] + (heatmaps.shape[-1], -1))
    top = np.sort(flat, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0] > 2 * atol


@pytest.mark.parametrize("model", ["POSE_RESNET", "HRNET"])
def test_serve_fn_matches_jax(weights, jax_runs, model):
    images, box, runs = jax_runs
    ref = runs[model]
    engine, sd = _port(weights, model)
    got = _numpy(serving.build_serve_fn(engine, sd)(torch.from_numpy(images), torch.from_numpy(box)))
    assert got["heatmaps"].shape == ref["heatmaps"].shape == (B, V, IMG // 4, IMG // 4, K)
    assert got["keypoints"].shape == (B, V, K, 2) and got["confidence"].shape == (B, V, K)
    assert all(v.dtype == np.float32 for v in got.values())
    atol = HEAT_ATOL_OF_SCALE * np.abs(ref["heatmaps"]).max()
    np.testing.assert_allclose(got["heatmaps"], ref["heatmaps"], rtol=0, atol=atol)
    unique = _unique_argmax(ref["heatmaps"], atol)
    assert unique.mean() > 0.9, unique.mean()
    np.testing.assert_array_equal(got["keypoints"][unique], ref["keypoints"][unique])
    np.testing.assert_allclose(got["confidence"], ref["confidence"], rtol=0, atol=atol)


LOADER = textwrap.dedent(
    """
    import sys
    BANNED = ("jax", "jaxlib", "flax", "optax", "multi_view_active_learning_tpu")
    PORT_BANNED = ("multi_view_active_learning_tpu_torch.engine",
                   "multi_view_active_learning_tpu_torch.models",
                   "multi_view_active_learning_tpu_torch.config")

    def banned(name):
        return name.split(".")[0] in BANNED or any(
            name == b or name.startswith(b + ".") for b in PORT_BANNED)

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if banned(name):
                raise ImportError("banned import: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from multi_view_active_learning_tpu_torch.serving import load_serving

    request = np.load(sys.argv[2])
    call = load_serving(sys.argv[1], device="cpu")
    out = call(request["images"], request["box"])
    np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})
    loaded = sorted(m for m in sys.modules if banned(m))
    assert not loaded, loaded
    print("LOADED_OK", call.meta["batch"])
    """
) % REPO


def test_static_artifact_loads_without_engine_models_or_config(weights, tmp_path):
    engine, sd = _port(weights)
    images, box = _request(B, 1)
    eager = _numpy(serving.build_serve_fn(engine, sd)(torch.from_numpy(images),
                                                      torch.from_numpy(box)))
    ep = serving.export_serving(engine, sd, B, V)
    assert serving.input_shapes(ep) == [(B, V, IMG, IMG, 3), (B, V, 4)]
    path = serving.save_serving(ep, str(tmp_path / ("model" + serving.SERVING_SUFFIX)))
    assert os.path.getsize(path) > 1e6  # the weights are baked in
    np.savez(str(tmp_path / "request.npz"), images=images, box=box)
    proc = subprocess.run(
        [sys.executable, "-c", LOADER, path, str(tmp_path / "request.npz"),
         str(tmp_path / "out.npz")], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "LOADED_OK %d" % B in proc.stdout, proc.stderr[-4000:]
    got = np.load(str(tmp_path / "out.npz"))
    for key in ("heatmaps", "keypoints", "confidence"):
        np.testing.assert_allclose(got[key], eager[key], rtol=0, atol=EAGER_ATOL, err_msg=key)


def test_symbolic_artifact_serves_any_batch(weights, tmp_path):
    engine, sd = _port(weights)
    serve = serving.build_serve_fn(engine, sd)
    ep = serving.export_serving(engine, sd, None, V)
    path = serving.save_serving(ep, str(tmp_path / ("model_b" + serving.SERVING_SUFFIX)))
    call = serving.load_serving(path, device="cpu")
    assert call.meta["batch"] == "b"
    shapes = serving.input_shapes(call.exported)  # the batch a symbol, the rest static
    assert all(isinstance(s[0], str) for s in shapes) and shapes[0][0] == shapes[1][0]
    assert [s[1:] for s in shapes] == [(V, IMG, IMG, 3), (V, 4)]
    for batch in (1, 3):  # one artifact, two request sizes
        images, box = _request(batch, 10 + batch)
        got = _numpy(call(images, box))
        ref = _numpy(serve(torch.from_numpy(images), torch.from_numpy(box)))
        assert got["heatmaps"].shape[0] == batch
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=EAGER_ATOL, err_msg=key)


def _cos_agree(got, ref):
    cos = float(np.sum(got * ref) / (np.linalg.norm(got) * np.linalg.norm(ref)))
    flat = lambda h: np.moveaxis(h, -1, -3).reshape(h.shape[:-3] + (h.shape[-1], -1))  # noqa: E731
    agree = float(np.mean(np.argmax(flat(got), -1) == np.argmax(flat(ref), -1)))
    return cos, agree


def test_int8_artifact_matches_jax_int8(weights, jax_runs, tmp_path):
    images, box, runs = jax_runs
    engine, sd = _port(weights, INT8_SCORING=True)
    engine.load_state_dict(sd)
    own = engine.int8_calibrate(images)
    jax_scales = runs["int8_scales"]
    assert set(own) == set(jax_scales)
    for name, value in own.items():
        np.testing.assert_allclose(value.numpy(), jax_scales[name], rtol=INT8_SCALE_RTOL,
                                   err_msg=name)

    ep = serving.export_serving(engine, None, B, V, int8_scales=scales_from_jax(jax_scales))
    path = serving.save_serving(ep, str(tmp_path / ("model_i8" + serving.SERVING_SUFFIX)))
    got = _numpy(serving.load_serving(path, device="cpu")(images, box))
    cos, agree = _cos_agree(got["heatmaps"], runs["int8"]["heatmaps"])
    assert cos > INT8_COS and agree >= INT8_AGREE, (cos, agree)
    # The artifact equals the eager int8 serve function on the same scales.
    eager = _numpy(serving.build_serve_fn(engine, None, scales_from_jax(jax_scales))(
        torch.from_numpy(images), torch.from_numpy(box)))
    for key in eager:
        np.testing.assert_allclose(got[key], eager[key], rtol=0, atol=EAGER_ATOL, err_msg=key)


def _op_calls(ep):
    return [str(n.target) for n in ep.graph.nodes if str(n.target).startswith("mval.")]


@pytest.mark.parametrize("head", ["k3", "k4"])
def test_head_kernel_artifacts_match_eager(weights, tmp_path, head):
    tpu = dict(PALLAS_HEAD=True) if head == "k3" else dict(INT8_SCORING=True, INT8_DECONV=True)
    engine, sd = _port(weights, **tpu)
    images, box = _request(B, 3)
    engine.load_state_dict(sd)
    scales = engine.int8_calibrate(images) if head == "k4" else None
    eager = _numpy(serving.build_serve_fn(engine, None, scales)(torch.from_numpy(images),
                                                                torch.from_numpy(box)))
    ep = serving.export_serving(engine, None, B, V, int8_scales=scales)
    op = "mval.fused_deconv_bn_relu" + ("_int8" if head == "k4" else "")
    # The int8 backbone's 20 convs (PoseResNet-18) are K5's units.
    trunk = ["mval.int8_conv_bn.default"] * 20 if head == "k4" else []
    assert _op_calls(ep) == trunk + [op + ".default"] * 3 + ["mval.fused_decode.default"]
    path = serving.save_serving(ep, str(tmp_path / (head + serving.SERVING_SUFFIX)))
    got = _numpy(serving.load_serving(path, device="cpu")(images, box))
    for key in eager:
        np.testing.assert_allclose(got[key], eager[key], rtol=0, atol=EAGER_ATOL, err_msg=key)


def _op_samples():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 8, 4, 4)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, size=8).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    k3 = deconv.pack_k3(w, scale, bias, torch.float32)
    k4 = deconv.pack_k4(*deconv.quantize_deconv_weight(w), scale, bias)
    wq3 = torch.from_numpy(rng.integers(-127, 128, size=(8, 3, 3, 16)).astype(np.int8))
    ws3 = torch.from_numpy(rng.uniform(0.01, 0.02, size=8).astype(np.float32))
    return {
        "fused_decode": (torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32)), 8, 4.0),
        "fused_deconv_bn_relu": (x, *k3),
        "fused_deconv_bn_relu_int8": (x, *k4, torch.tensor(0.02)),
        "int8_conv_bn": (x.to(torch.bfloat16), wq3, ws3, scale, bias, torch.tensor(0.02),
                         torch.from_numpy(rng.normal(size=(2, 2, 3, 8)).astype(np.float32)).to(
                             torch.bfloat16), 2, 1, 1, False),
    }


OPS = ("fused_decode", "fused_deconv_bn_relu", "fused_deconv_bn_relu_int8", "int8_conv_bn")


@pytest.mark.parametrize("name", OPS)
def test_registered_operators_pass_opcheck(name):
    torch.library.opcheck(getattr(torch.ops.mval, name), _op_samples()[name])


def test_operators_on_the_cpu_are_the_plain_versions_and_count_no_launch():
    samples = _op_samples()
    from multi_view_active_learning_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.testing.assert_close(torch.ops.mval.fused_decode(*samples["fused_decode"]),
                               decode.fused_decode_plain(*samples["fused_decode"]), rtol=0, atol=0)
    x, weight, scale, bias, _ = samples["fused_deconv_bn_relu"]
    torch.testing.assert_close(torch.ops.mval.fused_deconv_bn_relu(*samples["fused_deconv_bn_relu"]),
                               deconv.fused_deconv_bn_relu_plain(x, weight, scale, bias),
                               rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}
