"""The port's data layer against the JAX package's, on the same synthetic
trees:

  * the generators (Panoptic, heterogeneous, InterHand2.6M) write
    byte-equal JSON and JPEGs;
  * the indexers (Panoptic, InterHand2.6M, select_common_cameras) give the
    same frames, and FramePool moves them the same way;
  * prepare_views_host gives byte-equal images and equal camera math on the
    PIL path, on the native path (the port's own build of native/), and
    under DATA.DEVICE_CROP;
  * FrameLoader gives equal batches, padding, frame_valid, shard lists and
    global_batch_layout; worker batches equal inline ones, a warm sweep
    prepares every frame inline, and no worker initializes CUDA;
  * stop_decode_processes leaves no worker and no forkserver running;
  * ops/image.py::crop_resize_uint8 is within 1 LSB of JAX's on at least
    99.9% exact values (float32 bilinear weights summed in another order
    can land a value on the other side of a .5 rounding boundary).
"""

import ctypes
import fcntl
import filecmp
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.data import build_dataset as jax_build_dataset
from multi_view_active_learning_tpu.data import ih26m as jax_ih26m
from multi_view_active_learning_tpu.data import native_loader as jax_native
from multi_view_active_learning_tpu.data import pipeline as jax_pipeline
from multi_view_active_learning_tpu.data import synthetic as jax_synthetic
from multi_view_active_learning_tpu.data.pools import FramePool as JaxFramePool
from multi_view_active_learning_tpu.ops import image as jax_image
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data import build_dataset, ih26m, native, pipeline
from multi_view_active_learning_tpu_torch.data import synthetic
from multi_view_active_learning_tpu_torch.data.pools import FramePool
from multi_view_active_learning_tpu_torch.ops import image

JOINTS, CAMS, FRAMES, IMG = 5, 3, 5, 64


def _whole_jax_native_lib() -> None:
    """Leave a whole ``native/libmval_host.so`` in place for the JAX loader.

    The JAX loader runs ``make -C native`` when the library is missing, and
    make links it in place.  Under pytest-xdist every worker collects
    ``tests/test_native_loader.py``, whose skip condition calls the loader,
    so on a fresh checkout several workers link the same file at once; a
    worker that opens the library while another is still writing it fails
    the load ("file too short") and the loader stays off for the rest of
    that worker.  Here, under an fcntl lock in ``native/``, a library that
    does not load is rebuilt with the same Makefile in a temporary
    directory and renamed over the path, so a reader sees either no file or
    a whole one."""
    so_path = jax_native._SO_PATH
    native_dir = os.path.dirname(so_path)
    with open(os.path.join(native_dir, ".libmval_host.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            ctypes.CDLL(so_path)
            return
        except OSError:
            pass
        build = tempfile.mkdtemp(dir=native_dir)
        try:
            for name in ("Makefile", "mval_host.cc"):
                shutil.copy(os.path.join(native_dir, name), build)
            subprocess.run(["make", "-s", "-C", build], check=True, capture_output=True)
            os.replace(os.path.join(build, os.path.basename(so_path)), so_path)
        finally:
            shutil.rmtree(build, ignore_errors=True)


def _reset_jax_native_latch() -> None:
    """Let the JAX loader load again in this worker: it latches itself off
    after one failed load, and the collection of test_native_loader.py may
    have met a half-written library (above)."""
    jax_native._lib = None
    jax_native._unavailable = False


# Collection-time repair, once per worker and before any test runs: later
# JAX tests in this worker (tests/test_datasets.py's native path among them)
# then load the whole library instead of taking PIL.
try:
    _whole_jax_native_lib()
    _reset_jax_native_latch()
except (OSError, subprocess.CalledProcessError):
    pass  # no compiler or libjpeg: the native tests fail on their own


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, gen in (("port", synthetic.generate_panoptic_tree),
                      ("jax", jax_synthetic.generate_panoptic_tree)):
        out[name] = gen(str(tmp_path_factory.mktemp("panoptic_" + name)),
                        num_train_frames=FRAMES, num_val_frames=2, num_joints=JOINTS,
                        num_cameras=CAMS)
    return out


def _configure(cfg, root, **data):
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = root
    cfg.DATA.NUM_JOINTS = JOINTS
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = IMG
    cfg.DATA.USE_NATIVE_LOADER = False
    for key, value in data.items():
        setattr(cfg.DATA, key, value)
    return cfg


def _cfgs(trees, **data):
    return (_configure(get_default_configs(), trees["port"], **data),
            _configure(jax_configs(), trees["port"], **data))


def _assert_trees_equal(a, b):
    assert _tree_files(a) == _tree_files(b)
    for rel in _tree_files(a):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


def test_panoptic_generator_is_byte_equal(trees):
    _assert_trees_equal(trees["port"], trees["jax"])


def test_ih26m_generator_is_byte_equal(tmp_path):
    a = synthetic.generate_ih26m_tree(str(tmp_path / "port"), num_frames=2, num_joints=42,
                                      num_cameras=CAMS)
    b = jax_synthetic.generate_ih26m_tree(str(tmp_path / "jax"), num_frames=2, num_joints=42,
                                          num_cameras=CAMS)
    _assert_trees_equal(a, b)


def test_heterogeneous_generator_is_byte_equal(tmp_path):
    kw = dict(num_common=3, num_hard=2, num_hard_clusters=2, num_val_common=1, num_val_hard=2,
              num_joints=JOINTS, num_cameras=2, num_distractors=3)
    _assert_trees_equal(synthetic.generate_heterogeneous_tree(str(tmp_path / "port"), **kw),
                        jax_synthetic.generate_heterogeneous_tree(str(tmp_path / "jax"), **kw))


def _assert_frames_equal(got, ref):
    assert list(got.unlabeled_data) == list(ref.unlabeled_data)
    assert got.list_of_cameras == ref.list_of_cameras
    for guid, frame in ref.unlabeled_data.items():
        mine = got.unlabeled_data[guid]
        assert set(mine) == set(frame)
        for key in frame:
            if key == "views":
                assert list(mine["views"]) == list(frame["views"])
                for cam, view in frame["views"].items():
                    for vk, vv in view.items():
                        if vk == "camera":
                            for ck, cv in vv.items():
                                np.testing.assert_array_equal(
                                    np.asarray(mine["views"][cam]["camera"][ck], dtype=float)
                                    if cv is not None else mine["views"][cam]["camera"][ck],
                                    np.asarray(cv, dtype=float) if cv is not None else cv)
                        else:
                            np.testing.assert_array_equal(mine["views"][cam][vk], vv)
            else:
                np.testing.assert_array_equal(mine[key], frame[key])


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_panoptic_indexer_gives_the_same_frames(trees, split):
    cfg, jcfg = _cfgs(trees)
    _assert_frames_equal(build_dataset(cfg, split), jax_build_dataset(jcfg, split))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_ih26m_indexer_gives_the_same_frames(tmp_path_factory, split):
    root = synthetic.generate_ih26m_tree(str(tmp_path_factory.mktemp("ih26m")), num_frames=3,
                                         num_joints=42, num_cameras=4)
    cfg, jcfg = get_default_configs(), jax_configs()
    for c in (cfg, jcfg):
        c.DATA.TYPE = "ih26m"
        c.DATA.NUM_JOINTS = 42
        c.DATA.IH26M.HOME = root
        c.DATA.IH26M.CAPTURE_RANGE = [0, 1]
        c.DATA.IH26M.TEST_CAPTURE_RANGE = [0, 1]
        c.DATA.IH26M.NUM_VIEW_PER_FRAME = 3
        c.DATA.IH26M.TEST_NUM_VIEW_PER_FRAME = 3
    got, ref = build_dataset(cfg, split), jax_build_dataset(jcfg, split)
    assert len(ref.unlabeled_data) == 3
    _assert_frames_equal(got, ref)


@pytest.mark.parametrize("compat", [False, True])
def test_select_common_cameras_matches_jax(compat):
    rng = np.random.default_rng(3)
    all_cam = {cap: {"campos": {"c%02d" % i: rng.normal(size=3).tolist() for i in range(9)}}
               for cap in ("0", "1")}
    del all_cam["1"]["campos"]["c04"]
    for n in (3, 5, 8):
        assert (ih26m.select_common_cameras(all_cam, [0, 1], n, reference_compat=compat)
                == jax_ih26m.select_common_cameras(all_cam, [0, 1], n, reference_compat=compat))


def test_frame_pool_moves_frames_like_jax():
    frames = {"g%d" % i: {"guid": "g%d" % i, "3d_keypoints": np.full((3, 3), float(i))}
              for i in range(8)}
    pools = (FramePool(dict(frames)), JaxFramePool(dict(frames)))
    for pool in pools:
        pool.label_by_frame_guids(["g3", "g1"])
        pool.pseudo_label_by_frame_guids(["g5"], {"g5": np.ones((3, 3))})
        pool.resample_frames(-1, epoch_size=7, rng=np.random.default_rng(4))
    assert [f["guid"] for f in pools[0].data] == [f["guid"] for f in pools[1].data]
    assert list(pools[0].unlabeled_data) == list(pools[1].unlabeled_data)
    got, ref = pools[0].get_al_dict_for_coreset(), pools[1].get_al_dict_for_coreset()
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    for pool in pools:
        pool.resample_frames(2, rng=np.random.default_rng(5))
    assert [f["guid"] for f in pools[0].data] == [f["guid"] for f in pools[1].data]


def _assert_prepared_equal(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        if key == "guid":
            assert got[key] == ref[key]
        else:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("mode", ["pil", "native", "device_crop"])
def test_prepare_views_host_matches_jax(trees, mode, monkeypatch):
    """Byte-equal images: PIL, the native decoder (the port's own build),
    and full frames under DATA.DEVICE_CROP; equal camera math in each.  The
    JAX loader is pointed at a whole library with its latch reset for this
    test only (monkeypatch restores both), so nothing here turns it off for
    later tests in the worker."""
    data = {"VIEW_CACHE_SIZE": 0, "USE_NATIVE_LOADER": mode == "native",
            "DEVICE_CROP": mode == "device_crop"}
    if mode == "native":
        _whole_jax_native_lib()
        monkeypatch.setattr(jax_native, "_lib", None)
        monkeypatch.setattr(jax_native, "_unavailable", False)
        assert native.available() and jax_native.available(), "native decoder did not build"
    cfg, jcfg = _cfgs(trees, **data)
    ds, jds = build_dataset(cfg, "train"), jax_build_dataset(jcfg, "train")
    for guid, frame in jds.unlabeled_data.items():
        _assert_prepared_equal(pipeline.prepare_views_host(ds.unlabeled_data[guid], cfg.DATA, 4),
                               jax_pipeline.prepare_views_host(frame, jcfg.DATA, 4))


def test_failed_native_build_takes_the_pil_path(trees, tmp_path, monkeypatch):
    """A native build that fails is recorded, not retried, and the frames
    are prepared on the PIL path: the JAX package's PIL images."""
    bad = tmp_path / "bad.cc"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "SO_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "FAILED_PATH", str(tmp_path / "lib.failed"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_unavailable", False)
    assert not native.available() and (tmp_path / "lib.failed").exists()
    monkeypatch.setattr(native, "_unavailable", False)
    monkeypatch.setattr(native, "_build", lambda: pytest.fail("a failed build was retried"))
    assert not native.available()
    cfg, jcfg = _cfgs(trees, VIEW_CACHE_SIZE=0, USE_NATIVE_LOADER=True)
    jcfg.DATA.USE_NATIVE_LOADER = False
    ds, jds = build_dataset(cfg, "train"), jax_build_dataset(jcfg, "train")
    guid = next(iter(jds.unlabeled_data))
    _assert_prepared_equal(pipeline.prepare_views_host(ds.unlabeled_data[guid], cfg.DATA, 4),
                           jax_pipeline.prepare_views_host(jds.unlabeled_data[guid], jcfg.DATA, 4))


def _batches_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _assert_prepared_equal(a, b)


@pytest.mark.parametrize("shards", [1, 2])
def test_frame_loader_matches_jax(trees, shards):
    """Batches of 2 over 5 frames: the last padded and flagged; with two
    shards each emits the longer shard's count, and every batch's
    global_batch_layout is JAX's."""
    cfg, jcfg = _cfgs(trees, VIEW_CACHE_SIZE=0)
    ds, jds = build_dataset(cfg, "train"), jax_build_dataset(jcfg, "train")
    for pool in (ds, jds):
        pool.resample_unlabeled_data()
    for shard in range(shards):
        loader = pipeline.FrameLoader(ds, cfg.DATA, 4, batch_size=2, num_shards=shards,
                                      shard_index=shard)
        ref = jax_pipeline.FrameLoader(jds, jcfg.DATA, 4, batch_size=2, num_shards=shards,
                                       shard_index=shard)
        got_batches, ref_batches = list(loader), list(ref)
        _batches_equal(got_batches, ref_batches)
        assert len(loader) == len(ref) == len(got_batches)
        assert not got_batches[-1]["frame_valid"].all()
        for b in range(len(loader)):
            g, r = loader.global_batch_layout(b), ref.global_batch_layout(b)
            assert g[0] == r[0]
            np.testing.assert_array_equal(g[1], r[1])
        assert loader._shard_guid_lists() == ref._shard_guid_lists()


def test_frame_loader_workers_match_inline_and_warm_sweep_is_inline(trees, monkeypatch):
    """Two worker processes give the inline batches; they never initialize
    CUDA; the second sweep finds every view in this process's cache and
    submits nothing to the workers."""
    cfg, _ = _cfgs(trees)
    ds = build_dataset(cfg, "train")
    ds.resample_unlabeled_data()
    pipeline.VIEW_CACHE.clear()
    inline = list(pipeline.FrameLoader(ds, cfg.DATA, 4, batch_size=2, prefetch=0))
    pipeline.VIEW_CACHE.clear()
    loader = pipeline.FrameLoader(ds, cfg.DATA, 4, batch_size=2, num_workers=2)
    try:
        _batches_equal(list(loader), inline)
        ex = pipeline._shared_executor(2)
        assert not any(ex.submit(pipeline.cuda_initialized).result() for _ in range(4))
        submitted = []
        monkeypatch.setattr(ex, "submit", lambda *a, **k: submitted.append(a))
        hits = pipeline.VIEW_CACHE.hits
        _batches_equal(list(loader), inline)
        assert not submitted
        assert pipeline.VIEW_CACHE.hits - hits >= FRAMES * CAMS
    finally:
        loader.close()


STOP_SCRIPT = textwrap.dedent(
    """
    import os, sys, time
    sys.path.insert(0, %r)
    from multi_view_active_learning_tpu_torch.data import pipeline

    def running(pid):
        try:
            with open("/proc/%%d/stat" %% pid) as f:
                return f.read().rsplit(")", 1)[1].split()[0] != "Z"
        except OSError:
            return False

    def children():
        out = []
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open("/proc/%%s/stat" %% pid) as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                with open("/proc/%%s/cmdline" %% pid, "rb") as f:
                    command = f.read().decode(errors="replace")
            except OSError:
                continue
            if ppid == os.getpid() and running(int(pid)):
                out.append(command)
        return out

    ex = pipeline._shared_executor(2)
    assert not any(ex.submit(pipeline.cuda_initialized).result() for _ in range(4))
    workers = list(ex._processes)
    assert workers and all(map(running, workers)), workers  # started on demand
    assert any("forkserver" in c for c in children()), children()
    pipeline.stop_decode_processes()
    assert not any(map(running, workers)), workers
    assert not any("forkserver" in c for c in children()), children()
    # A pool after the stop starts a new forkserver and works.
    assert not pipeline._shared_executor(1).submit(pipeline.cuda_initialized).result()
    pipeline.stop_decode_processes()
    assert not any("forkserver" in c for c in children()), children()
    print("STOPPED_OK")
    """
) % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stop_decode_processes_leaves_no_worker_or_forkserver():
    """The decode workers and their forkserver have exited when
    stop_decode_processes returns (left alone, the forkserver outlives its
    parent until it reads the end of its pipe).  In a fresh process: the
    forkserver is one per process and this one's may serve other pools."""
    proc = subprocess.run([sys.executable, "-c", STOP_SCRIPT], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "STOPPED_OK" in proc.stdout, proc.stderr[-4000:]


def test_crop_resize_uint8_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(2, 3, 48, 40, 3)).astype(np.uint8)
    boxes = np.stack([rng.uniform(-10, 20, size=(2, 3)), rng.uniform(-10, 20, size=(2, 3))],
                     axis=-1)
    size = rng.uniform(15, 45, size=(2, 3, 1))
    boxes = np.concatenate([boxes, boxes + size], axis=-1).astype(np.float32)  # square
    got = image.crop_resize_uint8(torch.from_numpy(frames), torch.from_numpy(boxes), 32, 32)
    ref = np.asarray(jax_image.crop_resize_uint8(jnp.asarray(frames), jnp.asarray(boxes), 32, 32))
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999, (diff.max(), np.mean(diff == 0))
