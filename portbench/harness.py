"""The harness: reads ``BENCHMARK.json``, finds a cell's files by name, runs
the cell's traffic kind once and prints its result line.

A cell (an entry of ``workloads``) names a configuration, whose file the
manifest gives, and a traffic mix, ``portbench/traffic/<traffic>.json``,
whose ``kind`` names the module under ``portbench/kinds/`` that drives
it; its correctness limits are ``portbench/limits/<workload>.json``; each
per-layer metric is read by ``portbench/metrics/<name>.py``.  A cell or a
metric added as such files and manifest entries needs no change here.

A cell with ``chips`` > 1 runs one process a card.  The harness's process
is rank 0: it alone measures, traces and checks, and prints the result.
Its traffic kind starts ranks 1..n-1 (``Context.start_ranks``), each
``portbench/rank.py`` with torchrun's environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), from which
the program joins the run through its own
``parallel.initialize_distributed``; each follows rank 0's sequence of
calls (``Context.follow``) on its own card.  A rank that ends with an
error ends the run; ranks that outlive it are killed and reported.

The program under test is the PyTorch port; nothing here, and nothing it
runs, imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from typing import Callable, Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "multi_view_active_learning_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_view_active_learning_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def forbidden_code(where: str) -> int:
    """4, with what was found named on standard error, where `where` has
    loaded a forbidden module; else 0."""
    found = forbidden_modules()
    if found:
        print("portbench: forbidden modules loaded in %s: %s" % (where, found), file=sys.stderr,
              flush=True)
        return 4
    return 0


class Cell:
    """A workload of the manifest and the files it names."""

    def __init__(self, manifest: Dict, name: str, root: str = ROOT, base: str = HERE):
        self.manifest = manifest
        self.base = base
        self.workload = _named(manifest["workloads"], name, "workload")
        self.name = name
        entry = _named(manifest["configs"], self.workload["config"], "config")
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(base, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(base, "limits", name + ".json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def kind(self):
        return importlib.import_module("kinds." + self.traffic["kind"])

    SAVED = ("name", "base", "workload", "config", "traffic", "limits", "end_to_end", "per_layer")

    def saved(self) -> Dict:
        """What another rank needs to run this cell as it stands (its files
        as read, and as a test may have cut them)."""
        return {key: getattr(self, key) for key in self.SAVED}

    @classmethod
    def restore(cls, saved: Dict) -> "Cell":
        cell = cls.__new__(cls)
        cell.__dict__.update(saved)
        return cell


def _named(entries: Sequence[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError("no %s named %r in BENCHMARK.json" % (what, name))


def metric_reader(name: str, base: str = HERE) -> Callable:
    """``read(readings)`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@contextlib.contextmanager
def float32_reference():
    """TF32 off while the reference runs (cuDNN takes it by default for
    float32 convolutions), restored after."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class FrameList:
    """A list of frames as the program's loader takes a pool (its `data`)."""

    def __init__(self, frames):
        self.data = list(frames)


class NoFaults:
    def install(self, cell):
        pass

    def remove(self):
        pass


def threads_a_rank(world: int) -> int:
    """Each rank's share of the cores for its intra-op threads, as a
    launcher of one process a card sets OMP_NUM_THREADS: the ranks'
    threads then do not outnumber the cores."""
    return max(1, (os.cpu_count() or 1) // world)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """Ranks 1..n-1 of a multi-card cell, each ``rank.py`` in a process of
    its own, and a thread that ends the run when one of them fails (rank 0
    would otherwise wait in a collective that never completes)."""

    def __init__(self, shared: Dict, path: str, script: str = os.path.join(HERE, "rank.py")):
        world = int(shared["world"])
        with open(path, "w") as f:
            json.dump(shared, f)
        self.procs = []
        for rank in range(1, world):
            env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=str(shared["port"]))
            env.setdefault("OMP_NUM_THREADS", str(threads_a_rank(world)))
            self.procs.append(subprocess.Popen([sys.executable, script, path, str(rank)], env=env))
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._done.wait(0.5):
            for rank, proc in enumerate(self.procs, start=1):
                code = proc.poll()
                if code not in (None, 0):
                    print("portbench: rank %d ended with code %d; ending the run" % (rank, code),
                          file=sys.stderr, flush=True)
                    for other in self.procs:
                        other.kill()
                    os._exit(5)

    def end(self, timeout_s: float = 60.0):
        """Wait for every rank; kill those alive after `timeout_s`.  Returns
        (their exit codes, the pids killed)."""
        self._done.set()
        self._thread.join()
        deadline, killed = time.monotonic() + timeout_s, []
        for proc in self.procs:
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                killed.append(proc.pid)
        return [proc.returncode for proc in self.procs], killed


def _watch_parent() -> None:
    """Another rank ends itself when rank 0, its parent, has ended."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(6)

    threading.Thread(target=watch, daemon=True).start()


class Context:
    """What a traffic kind gets: the cell's files, the run's arguments, the
    device, and the harness's helpers.  `rank` and `world` place it in a
    multi-card cell (`world` is the cell's ``chips``); rank 0 is the
    harness's own process, the others get what rank 0 shares with them in
    `shared`."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float, overrides: Optional[Dict] = None, faults=None, rank: int = 0,
                 shared: Optional[Dict] = None):
        import torch

        self.cell = cell
        self.config, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.rank, self.world = int(rank), int(cell.workload["chips"])
        self.device = torch.device(device)
        if self.world > 1 and self.device.type == "cuda":
            self.device = torch.device("cuda", self.rank)
        self.t_start = t_start
        self.overrides = overrides or {}
        self.fault = faults or NoFaults()
        self.peaks = load_json(os.path.join(HERE, "peaks.json"))["peaks"]
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self._cfg = None
        # What the other ranks repeat of rank 0's run besides set-up and the
        # window: the traced window, the per-layer probes.
        self.plan = {"traced_window": self.trace, "probes": self.trace}
        self.shared = shared or {}
        self.ranks: Optional[Ranks] = None
        self.rank_codes: List[int] = []
        self.ranks_killed: List[int] = []
        self.group = False

    # -- the ranks of a multi-card cell ----------------------------------------

    def start_ranks(self, **extra) -> None:
        """On rank 0 of a multi-card cell: start ranks 1..n-1, sharing the
        cell, the run's arguments and `extra` (such as the data's path) with
        them.  Elsewhere nothing."""
        if self.world == 1 or self.rank != 0:
            return
        import torch

        self._threads = torch.get_num_threads()
        torch.set_num_threads(threads_a_rank(self.world))
        self.shared = dict(extra, cell=self.cell.saved(), seed=self.seed, seconds=self.seconds,
                           trace=self.trace, device=self.device.type, overrides=self.overrides,
                           plan=self.plan, world=self.world, port=free_port(),
                           traces=os.path.join(self.tmp, "traces"))
        os.makedirs(self.shared["traces"])
        self.ranks = Ranks(self.shared, os.path.join(self.tmp, "ranks.json"))

    def join_group(self) -> None:
        """Join the ranks' process group through the program's own
        ``parallel.initialize_distributed`` (NCCL on cards, gloo on the CPU):
        rank 0 with the address it chose, the others from torchrun's
        environment.  Nothing in a one-card cell."""
        if self.world == 1:
            return
        from multi_view_active_learning_tpu_torch import parallel

        if self.rank == 0:
            parallel.initialize_distributed("localhost:%d" % self.shared["port"], self.world, 0,
                                            device=self.device)
        else:
            parallel.initialize_distributed(device=self.device)
        self.group = True

    def barrier(self, name: str) -> None:
        if self.group:
            from multi_view_active_learning_tpu_torch import parallel

            parallel.process_barrier("portbench/" + name)

    def end_ranks(self) -> None:
        """Leave the process group and, on rank 0, wait for the other ranks
        (killing those that outlive the run).  A rank that failed fails the
        run."""
        if self.group:
            from multi_view_active_learning_tpu_torch import parallel

            parallel.shutdown()
            self.group = False
        if self.ranks is not None:
            import torch

            torch.set_num_threads(self._threads)
            ranks, self.ranks = self.ranks, None
            self.rank_codes, self.ranks_killed = ranks.end()
            failed = [r for r, code in enumerate(self.rank_codes, start=1)
                      if code != 0 and ranks.procs[r - 1].pid not in self.ranks_killed]
            if failed:
                raise RuntimeError("rank(s) %s of the cell failed: codes %s"
                                   % (failed, self.rank_codes))

    def rank_traces(self) -> List[Dict]:
        """The traced window's reduction that each other rank left."""
        out = []
        for rank in range(1, self.world):
            path = os.path.join(self.shared["traces"], "rank%d.json" % rank)
            if os.path.exists(path):
                out.append(load_json(path))
        return out

    # -- the program's configuration -------------------------------------------

    def _merged_config(self):
        from multi_view_active_learning_tpu_torch.config import get_default_configs

        cfg = get_default_configs()
        for layer in (self.config["program"], self.traffic["program"], self.overrides):
            cfg.merge_from_dict(layer)
        return cfg

    def program_config(self, tree_root: str):
        cfg = self._merged_config()
        cfg.DATA.TYPE = "synthetic"
        cfg.DATA.SYNTHETIC_ROOT = tree_root
        cfg.RANDOM_SEED = self.seed
        cfg.LOG_DIR = os.path.join(self.tmp, "logs")
        cfg.EXPR_NAME = self.cell.name
        self._cfg = cfg
        return cfg

    def cfg_value(self, dotted: str):
        """A key of the program configuration as this cell sets it."""
        node = self._cfg if self._cfg is not None else self._merged_config()
        for part in dotted.split("."):
            node = getattr(node, part)
        return node

    # -- helpers ---------------------------------------------------------------

    def make_weights(self, spec):
        import weights

        return weights.make_state_dict(spec, self.seed, self.device)

    def fill_view_cache(self, strategy, frames, batch: int) -> None:
        """Read `frames` once through the program's loader with a decode
        worker a core (at most 8), so its view cache holds them: set-up
        work, done on every core the machine has."""
        workers = max(1, min(8, os.cpu_count() or 1))
        if self.device.type != "cuda":
            workers = 0
        loader = strategy._get_loader(FrameList(frames), batch, workers)
        try:
            for _ in loader:
                pass
        finally:
            loader.close()

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self):
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def time_ms(self, fn: Callable, steps: int, warmup: int = 2) -> float:
        """Mean milliseconds of `fn` over `steps` calls after `warmup`: CUDA
        events on a card, the host clock around synchronized calls on the
        CPU."""
        import torch

        for _ in range(warmup):
            fn()
        self.sync()
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / steps
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / steps

    # -- one run ---------------------------------------------------------------

    def drive(self, cell) -> Dict:
        """Set-up, the window (with `trace`, then a traced one and the
        per-layer probes), then the check once the program is released."""
        import torch

        import tracing

        cell.setup()
        setup_s = time.perf_counter() - self.t_start
        e2e = cell.window(self.seconds)
        window, traced, summary = dict(cell.window_info), None, None
        if self.trace:
            # A second window, the same work, traced: the profiler slows a
            # host-bound loop, so rates and shares of time take the first
            # window's time, and the trace gives the device's work per frame.
            spans = tracing.Spans(True)
            cell.install_spans(spans)
            self.sync()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                clock = tracing.Clock(self.device)
                with spans.mark("window"):
                    cell.window(self.seconds)
                clock.end()
            spans.remove()
            traced = dict(cell.window_info)
            summary = tracing.reduce(prof, spans.records, clock)
            del prof
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        probes = cell.probes() if self.plan["probes"] else {}
        attempted, failed = cell.attempted_failed()
        cell.release()
        if summary is not None and self.world > 1:
            # busy_s: the mean over the cards of each one's traced window.
            busy = [summary["busy_s"]] + [t["busy_s"] for t in self.rank_traces()]
            summary["busy_s_by_rank"] = busy
            summary["busy_s"] = sum(busy) / len(busy)
        with float32_reference():
            numbers = cell.check()
        return {"setup_s": setup_s, "e2e": e2e, "window": window, "traced_window": traced,
                "trace": summary, "probes": probes, "attempted": attempted, "failed": failed,
                "memory_peak_bytes": int(peak), "numbers": numbers}

    def follow(self, cell) -> None:
        """Another rank's run: what rank 0's ``drive`` calls of the program,
        in its order, each collective of rank 0 met here; its traced window
        reduced and left for rank 0; no result, no check."""
        import torch

        import tracing

        cell.setup()
        cell.window(self.seconds)
        if self.plan["traced_window"]:
            spans = tracing.Spans(True)
            self.sync()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                clock = tracing.Clock(self.device)
                with spans.mark("window"):
                    cell.window(self.seconds)
                clock.end()
            summary = tracing.reduce(prof, spans.records, clock)
            del prof
            path = os.path.join(self.shared["traces"], "rank%d.json" % self.rank)
            with open(path, "w") as f:
                json.dump({"busy_s": summary["busy_s"], "window_s": summary["window_s"],
                           "device_ops": summary["device_ops"]}, f)
        if self.plan["probes"]:
            cell.probes()
        cell.release()

    def close(self):
        import shutil

        try:
            self.end_ranks()
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit; a number passes at or under it.  A
    number that is missing or not finite reads None and fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is not None and not math.isfinite(value):
            value = None
        out[name] = {"value": value, "limit": limit}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             overrides: Optional[Dict] = None, faults=None) -> Dict:
    """One run of `cell`: the result object the command prints."""
    import torch

    sys.path.insert(0, HERE)
    ctx = Context(cell, seed, seconds, trace, device, t_start, overrides, faults)
    try:
        out = cell.kind().run(ctx)
        checks = judge(out["numbers"], cell.limits["limits"])
        correct = out["failed"] == 0 and all(
            c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
        units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
        if trace:
            readings = types.SimpleNamespace(
                kind=cell.traffic["kind"], window=out["window"], traced_window=out["traced_window"],
                trace=out["trace"], probes=out["probes"], ctx=ctx, module=cell.kind())
            metrics = {}
            for m in cell.per_layer:
                value = metric_reader(m["name"], cell.base)(readings)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
        else:
            values = dict(out["e2e"], setup_s=out["setup_s"])
            metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                       for m in cell.end_to_end}
        dev = torch.device(device)
        result = {
            "correct": bool(correct),
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]),
            "metrics": metrics,
            "device": {
                "platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": int(cell.workload["chips"]),
                "memory_peak_bytes": out["memory_peak_bytes"],
            },
        }
        if trace:
            tr = out["trace"]
            result["device"]["busy_s"] = tr["busy_s"]
            result["device"]["window_s"] = tr["window_s"]
            result["breakdown"] = {"device_ops": [list(kv) for kv in tr["device_ops"]],
                                   "idle_gaps": [list(kv) for kv in tr["idle_gaps"]]}
        result["diagnostics"] = {"window": out["window"], "traced_window": out["traced_window"],
                                 "setup_s": out["setup_s"], "probes": out["probes"],
                                 "numbers": out["numbers"]}
        if ctx.world > 1:
            result["diagnostics"]["ranks"] = {"codes": ctx.rank_codes, "killed": ctx.ranks_killed}
            if trace:
                result["diagnostics"]["busy_s_by_rank"] = out["trace"]["busy_s_by_rank"]
        if trace:
            top = sorted(out["trace"]["kernels"].items(), key=lambda kv: -kv[1][0])[:12]
            result["diagnostics"]["top_kernels"] = [[n[:120], s, k] for n, (s, k) in top]
            result["diagnostics"]["idle_gap_count"] = out["trace"]["gaps"]
            result["diagnostics"]["clock_skew_us"] = out["trace"]["clock_skew_us"]
        result["checks"] = checks
        return result
    finally:
        ctx.close()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return "nvidia-smi: %s" % e


def stop_child_processes(timeout_s: float = 30.0) -> List[int]:
    """Stop the program's decode workers, their forkserver and
    multiprocessing's resource tracker, and wait for every child; a child
    still alive after `timeout_s` is killed.  Returns those killed."""
    import signal

    pipeline = sys.modules.get(PROGRAM + ".data.pipeline")
    if pipeline is not None:
        pipeline.stop_decode_processes()
    tracker = sys.modules.get("multiprocessing.resource_tracker")
    if tracker is not None and tracker._resource_tracker._fd is not None:
        os.close(tracker._resource_tracker._fd)
        tracker._resource_tracker._fd = tracker._resource_tracker._pid = None
    deadline = time.monotonic() + timeout_s
    left = _children()
    while left and time.monotonic() < deadline:
        try:
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        except ChildProcessError:
            pass
        time.sleep(0.05)
        left = _children()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return left


def _children() -> List[int]:
    me, out = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % entry) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me:
            out.append(int(entry))
    return out


def main(argv: Optional[Sequence[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(manifest, args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: the cell needs %d CUDA device(s); this machine has %d"
              % (chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    print("portbench: card %s; peaks are the H100 SXM's published figures" % card_line(),
          file=sys.stderr, flush=True)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    finally:
        killed = stop_child_processes()
    killed = killed + result["diagnostics"].get("ranks", {}).get("killed", [])
    if killed:
        print("portbench: killed child processes left running: %s" % killed, file=sys.stderr)
        return 3
    if forbidden_code("this process"):
        return 4
    for name, c in result["checks"].items():
        print("check %s %s limit %s" % (name, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def follow_main(path: str, rank: int, t_start: float) -> int:
    """Rank `rank` of a multi-card cell (``rank.py``): what rank 0 shared in
    the file `path`, followed on this rank's card."""
    _watch_parent()
    shared = load_json(path)
    sys.path.insert(0, HERE)
    cell = Cell.restore(shared["cell"])
    ctx = Context(cell, shared["seed"], shared["seconds"], shared["trace"], shared["device"],
                  t_start, shared["overrides"], rank=rank, shared=shared)
    ctx.plan = shared["plan"]
    try:
        ctx.follow(cell.kind().CELL(ctx))
    finally:
        try:
            ctx.close()
        finally:
            stop_child_processes()
    # A rank that ends with another code than 0 ends rank 0's run (`Ranks`).
    return forbidden_code("rank %d" % rank)
