"""Nothing the benchmark runs imports JAX or the JAX package, and nothing
it reads is the JAX package's benchmark."""

import os
import re
import subprocess
import sys

import harness

MODULES = ["harness", "rank", "datagen", "weights", "tracing", "faults", "readings", "kinds.sweep",
           "kinds.train", "reference.arch", "reference.counting", "reference.data",
           "reference.geometry", "reference.precision", "reference.training"]
PROGRAM = ["multi_view_active_learning_tpu_torch.strategy",
           "multi_view_active_learning_tpu_torch.data",
           "multi_view_active_learning_tpu_torch.data.pipeline",
           "multi_view_active_learning_tpu_torch.kernels.decode",
           "multi_view_active_learning_tpu_torch.device",
           "multi_view_active_learning_tpu_torch.config"]


def test_no_forbidden_top_level_module_after_importing_everything_run_imports():
    code = "\n".join([
        "import sys",
        "sys.path[:0] = [%r, %r]" % (harness.HERE, harness.ROOT),
        *["import %s" % m for m in MODULES + PROGRAM],
        "import harness, glob, os",
        "for f in sorted(glob.glob(os.path.join(harness.HERE, 'metrics', '*.py'))):",
        "    harness.metric_reader(os.path.basename(f)[:-3])",
        "print('FORBIDDEN=' + ','.join(harness.forbidden_modules()))",
    ])
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "FORBIDDEN="


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("multi_view_active_learning_tpu", None)
        sys.modules["multi_view_active_learning_tpu_torch_like"] = sys
        assert "multi_view_active_learning_tpu" not in harness.forbidden_modules()
        sys.modules["multi_view_active_learning_tpu.engine"] = sys
        assert "multi_view_active_learning_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_sources_name_neither_jax_nor_the_jax_benchmark():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|multi_view_active_learning_tpu)\b"
                        r"(?!_torch)", re.M)
    files = re.compile(r"\b(bench\.py|BENCH_r\d|MULTICHIP_r\d|BASELINE\.json)")
    for dirpath, _, names in os.walk(harness.HERE):
        if "tests" in dirpath:
            continue
        for name in names:
            if name.endswith(".py"):
                text = open(os.path.join(dirpath, name)).read()
                assert not banned.search(text), name
                assert not files.search(text), name
