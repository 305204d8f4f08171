"""Data parallelism across cards through ``torch.distributed``.

The port's counterpart of the JAX package's parallel/__init__.py (:29-136
there), under its names.  JAX runs one controller over a ``('data',
'view')`` mesh; the port runs one process a card, as the reference's DDP
does (reference: workflow.py:125-139, 239-266): NCCL between cards, gloo on
the CPU (or for ranks that share a card, where NCCL refuses a second
rank).  Only the ``'data'`` axis is ported: ``TPU.VIEW_AXIS > 1`` (view
sharding) raises, naming ROADMAP Queue A9b.

  * ``initialize_distributed`` joins the run's processes: from explicit
    arguments (JAX's signature) or from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``).  On a card it first makes ``LOCAL_RANK`` the
    current device.
  * Host-only coordination (``process_barrier``, ``broadcast_string``) runs
    over a gloo group even under NCCL, as JAX's KV-store barrier touches no
    device (JAX :61-76).
  * The device collectives the engine, BatchNorm and the strategy call
    (``all_reduce_sum``, ``all_reduce_max``, ``all_gather_rows``) run
    whenever a group exists, a world of one included, and are the identity
    without one, so a group of one computes the same bits as no group.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

# The gloo group of host-only coordination: the default group under gloo,
# a second group under NCCL.  Set by initialize_distributed, as
# torch.distributed keeps its default group per process.
_HOST_GROUP = None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None) -> bool:
    """Join the other processes of a run; True when a process group is (or
    already was) initialized, False when there is nothing to join.

    `coordinator_address` (``host:port``, or a ``tcp://`` URL), with
    `num_processes` and `process_id`, gives the rendezvous explicitly;
    without it torchrun's environment does (``WORLD_SIZE`` and
    ``MASTER_ADDR``; neither set: one process, False).  `device` is where
    the run computes (None: the card when there is one): on a card the
    process takes card ``LOCAL_RANK`` (default: its rank) before the group
    is made, and the backend is NCCL, else gloo.  `backend` overrides that
    choice: ranks that share one card need ``"gloo"``."""
    global _HOST_GROUP
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
            if num_processes not in (None, 1):
                raise ValueError("num_processes=%r needs a coordinator_address (or torchrun's "
                                 "environment)" % num_processes)
            return False
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else "tcp://" + coordinator_address)
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if on_card:
        # Before the group: NCCL binds each rank to the current card, and
        # every rank would otherwise land on card 0.
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    backend = backend or ("nccl" if on_card else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _HOST_GROUP = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def active() -> bool:
    """A process group exists (of any size, one included): the collectives
    run."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a group); it stands in for
    ``jax.process_index``."""
    return dist.get_rank() if active() else 0


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0, the one process that writes logs, checkpoints and records."""
    return process_index() == 0


def process_barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Wait for every process at `name` (which names the wait in the error
    of a rank that does not come), over the gloo group: host-side only, so
    safe around rank-0 critical sections such as checkpoint writes.  A
    no-op without a group."""
    if not active():
        return
    try:
        dist.monitored_barrier(group=_HOST_GROUP, timeout=timedelta(milliseconds=timeout_ms))
    except RuntimeError as e:
        raise RuntimeError("barrier %r failed: %s" % (name, e)) from e


def broadcast_string(key: str, value: str, timeout_ms: int = 600_000) -> str:
    """Process 0's `value` in every process (over the gloo group), for host
    metadata that must agree, such as the run's stamp.  Every process must
    reach each call, in the same order; `key` and `timeout_ms` keep JAX's
    signature.  The identity without a group."""
    if not active():
        return value
    obj = [value]
    dist.broadcast_object_list(obj, src=0, group=_HOST_GROUP)
    return obj[0]


class Mesh(NamedTuple):
    """The ``('data', 'view')`` mesh of a run: `data` processes, one card
    each; `view` is 1 (view sharding is Queue A9b)."""

    data: int
    view: int = 1


def make_mesh(data_axis: int = -1, view_axis: int = 1, world: Optional[int] = None) -> Mesh:
    """The mesh over `world` processes (default: the group's size).
    ``data_axis == -1`` means all of them; any other value must equal the
    world size (ValueError, as JAX's make_mesh raises for a mesh that does
    not match the devices).  ``view_axis > 1`` raises NotImplementedError
    (ROADMAP Queue A9b)."""
    world = process_count() if world is None else int(world)
    if view_axis < 1:
        raise ValueError("view_axis (%d) must be at least 1" % view_axis)
    if view_axis != 1:
        raise NotImplementedError(
            "TPU.VIEW_AXIS=%r (view sharding) is not ported to PyTorch yet (ROADMAP Queue "
            "A9b)" % view_axis)
    if data_axis == -1:
        data_axis = world
    if data_axis != world:
        raise ValueError("mesh %dx%d does not match %d processes (one card each); set "
                         "TPU.DATA_AXIS to -1 or to the world size" % (data_axis, view_axis, world))
    return Mesh(data_axis, view_axis)


def mesh_from_config(cfg) -> Mesh:
    return make_mesh(cfg.TPU.DATA_AXIS, cfg.TPU.VIEW_AXIS)


# -- device collectives: the identity without a group --------------------------


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, in place; every rank gets the same bits."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """`t`'s elementwise maximum over the ranks, in place."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (the same shape on each), concatenated along dim 0 in
    rank order: global row ``r * n + i`` is rank r's row i, the order of
    ``FrameLoader.global_batch_layout``."""
    if not active():
        return t
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)
