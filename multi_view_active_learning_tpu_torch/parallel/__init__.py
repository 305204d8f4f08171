"""Data and view parallelism across cards through ``torch.distributed``.

The port's counterpart of the JAX package's parallel/__init__.py (:29-139
there), under its names.  JAX runs one controller over a ``('data',
'view')`` mesh and GSPMD inserts the collectives; the port runs one
process a card, as the reference's DDP does (reference:
workflow.py:125-139, 239-266): NCCL between cards, gloo on the CPU (or for
ranks that share a card, where NCCL refuses a second rank), and makes the
collectives explicit.  Rank r is data row ``r // view`` and view column
``r % view`` of the ``Mesh``: the ranks of a data row (its view group)
load the same frames, each its block of a frame's views when the view
axis divides their count (``views_split``) and all of them otherwise; the
ranks of a view column (its data group) hold every data row once.

  * ``initialize_distributed`` joins the run's processes: from explicit
    arguments (JAX's signature) or from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``).  On a card it first makes ``LOCAL_RANK`` the
    current device.
  * Host-only coordination (``process_barrier``, ``broadcast_string``) runs
    over a gloo group even under NCCL, as JAX's KV-store barrier touches no
    device (JAX :61-76).
  * The device collectives the engine, BatchNorm, the ops and the strategy
    call (``all_reduce_sum``, ``all_reduce_max``, ``all_gather_rows``,
    ``all_gather_views``) take a ``Group`` (default: every rank).  Over the
    default group they run whenever a process group exists, a world of one
    included, so a group of one computes the same bits as no group; over a
    group of one rank, and without a process group, they are the identity.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

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
    """Leave the process group, if there is one, and forget its mesh."""
    global _HOST_GROUP, _LAYOUT
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = _LAYOUT = None
    _GROUPS.clear()


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
    """The ``('data', 'view')`` mesh of a run, one process a card: `data`
    rows of `view` ranks each.  Rank r is data row ``r // view`` and view
    column ``r % view`` (JAX's ``devices.reshape(data, view)``)."""

    data: int
    view: int = 1


class Group(NamedTuple):
    """Ranks that run a collective together: `ranks` in the group's order,
    `handle` the torch process group (None: the default group)."""

    ranks: Tuple[int, ...]
    handle: object = None


def make_mesh(data_axis: int = -1, view_axis: int = 1, world: Optional[int] = None) -> Mesh:
    """The mesh over `world` processes (default: the group's size), with
    JAX's checks (JAX parallel/__init__.py:113-124): `view_axis` must
    divide the world, ``data_axis == -1`` takes the rest, and any other
    `data_axis` must make data x view the world (ValueError)."""
    world = process_count() if world is None else int(world)
    if view_axis < 1 or world % view_axis != 0:
        raise ValueError("view_axis (%d) must divide the device count (%d)" % (view_axis, world))
    if data_axis == -1:
        data_axis = world // view_axis
    if data_axis * view_axis != world:
        raise ValueError("mesh %dx%d does not match %d processes (one card each); set "
                         "TPU.DATA_AXIS to -1 or to the world size over TPU.VIEW_AXIS"
                         % (data_axis, view_axis, world))
    return Mesh(data_axis, view_axis)


# The run's mesh and this rank's groups of it: (mesh, view group, data
# group), set by use_mesh.  Groups are made once a mesh, by every rank.
_LAYOUT = None
_GROUPS: Dict[Mesh, Tuple[List[Group], List[Optional[Group]]]] = {}


def use_mesh(mesh: Mesh) -> Mesh:
    """Make `mesh` the layout the collectives follow.  Under a process group
    every rank must call this at the same points (``mesh_from_config`` does,
    from every Engine): the first call for a mesh makes its view groups (the
    ranks of each data row) and data groups (the ranks of each view column)
    with ``dist.new_group``, all of them on every rank, in one order, on the
    default group's backend.  With one view column the data group is the
    default group, as in a run without a view axis."""
    global _LAYOUT
    rank = process_index()
    if active() and mesh.data * mesh.view != process_count():
        raise ValueError("mesh %dx%d does not match %d processes"
                         % (mesh.data, mesh.view, process_count()))
    if mesh not in _GROUPS:
        view_rows = [tuple(range(d * mesh.view, (d + 1) * mesh.view)) for d in range(mesh.data)]
        data_cols = [tuple(range(v, mesh.data * mesh.view, mesh.view)) for v in range(mesh.view)]
        if mesh.view == 1:
            views, datas = [Group(ranks) for ranks in view_rows], [None]
        elif not active():
            views, datas = [Group(ranks) for ranks in view_rows], [Group(r) for r in data_cols]
        elif mesh.data == 1:
            views, datas = [Group(view_rows[0])], [Group(ranks) for ranks in data_cols]
        else:
            views = [Group(ranks, dist.new_group(list(ranks))) for ranks in view_rows]
            datas = [Group(ranks, dist.new_group(list(ranks))) for ranks in data_cols]
        _GROUPS[mesh] = (views, datas)
    views, datas = _GROUPS[mesh]
    _LAYOUT = (mesh, views[rank // mesh.view], datas[rank % mesh.view])
    return mesh


def mesh_from_config(cfg) -> Mesh:
    """``make_mesh(TPU.DATA_AXIS, TPU.VIEW_AXIS)``, made the run's layout."""
    return use_mesh(make_mesh(cfg.TPU.DATA_AXIS, cfg.TPU.VIEW_AXIS))


def current_mesh() -> Mesh:
    """The layout of the last ``use_mesh``, or every process on the data
    axis when none was set."""
    return _LAYOUT[0] if _LAYOUT is not None else Mesh(process_count(), 1)


def data_index() -> int:
    """This rank's data row: which shard of the frames it loads."""
    return process_index() // current_mesh().view


def view_index() -> int:
    """This rank's view column."""
    return process_index() % current_mesh().view


def view_group() -> Group:
    """The ranks of this rank's data row (one rank without a view axis)."""
    return _LAYOUT[1] if _LAYOUT is not None else Group((process_index(),))


def data_group() -> Optional[Group]:
    """The ranks of this rank's view column, which hold every data row
    once (None: the default group, every rank)."""
    return _LAYOUT[2] if _LAYOUT is not None else None


def view_block(num_views: int, view_axis: int, column: int) -> slice:
    """The views of a frame of `num_views` that view column `column` of a
    `view_axis`-wide view axis holds.  JAX's rule (strategy.py:176-183
    there): the views shard over the axis when it divides them, each column
    holding one block; otherwise every column holds all of them."""
    if view_axis <= 1 or num_views % view_axis:
        return slice(0, num_views)
    n = num_views // view_axis
    return slice(column * n, (column + 1) * n)


def views_split(num_views: int) -> bool:
    """Whether a frame's `num_views` views shard over the run's view axis."""
    view = current_mesh().view
    return view > 1 and num_views % view == 0


def view_slice(num_views: int) -> slice:
    """The views of a frame of `num_views` this rank holds."""
    return view_block(num_views, current_mesh().view, view_index())


def batch_group(num_views: int) -> Optional[Group]:
    """The ranks over which a batch's sums run (loss counts, gradients,
    BatchNorm statistics): every rank when the views shard, each crop then
    being on one rank; the data group when they do not, since the ranks of
    a data row then hold the same crops and would count them `view` times."""
    return None if views_split(num_views) else data_group()


def group_size(group: Optional[Group] = None) -> int:
    return process_count() if group is None else len(group.ranks)


# -- device collectives: the identity without a group --------------------------


def _runs(group: Optional[Group]) -> bool:
    """A collective runs under a process group, over the default group (a
    world of one included) or over a group of more than one rank."""
    return active() and (group is None or len(group.ranks) > 1)


def _handle(group: Optional[Group]):
    return None if group is None else group.handle


def all_reduce_sum(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """`t` summed over `group`'s ranks (default: every rank), in place;
    every rank gets the same bits."""
    if _runs(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_handle(group))
    return t


def all_reduce_max(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """`t`'s elementwise maximum over `group`'s ranks, in place."""
    if _runs(group):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_handle(group))
    return t


def _all_gather(t: torch.Tensor, group: Optional[Group], dim: int) -> torch.Tensor:
    if not _runs(group):
        return t
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t, group=_handle(group))
    return torch.cat(parts, dim=dim)


def all_gather_rows(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """Every rank's `t` (the same shape on each) of `group` (default: every
    rank), concatenated along dim 0 in the group's rank order: over the
    data group, global row ``d * n + i`` is data row d's row i, the order
    of ``FrameLoader.global_batch_layout``."""
    return _all_gather(t, group, 0)


def all_gather_views(t: torch.Tensor) -> torch.Tensor:
    """`t` [B, V_local, ...] of every rank of this rank's data row,
    concatenated along dim 1 in view-column order: the frame's views, as
    GSPMD gathers the keypoints the triangulation contracts over (JAX
    parallel/__init__.py:11-14).  The identity without a view axis."""
    return _all_gather(t, view_group(), 1)
