"""Meshes: the port of ``repro.launch.mesh``.

The reference builds one single-controller mesh over every chip.  The
port splits it in two:

  * :class:`ServingMesh` — the devices the serving table is row-sharded
    over (axis ``"data"``); the sharded top-k
    (``kernels.ops.topk_cosine_sharded``) puts one row block on each.
    A device may repeat: several shards on one card (or on the CPU) run
    the same per-shard contract as shards on distinct cards.
  * :class:`MeshShape` — ordered axis names and sizes with no devices:
    what the sharding rules (``models.sharding``) and the dry run
    (``launch.dryrun``) read.

and adds the multi-process half the reference's mesh also covers:

  * :class:`ProcessMesh` — one process a mesh position over a
    ``torch.distributed`` world, with the process groups the port's
    collectives use: ``"model"``, the data axes and all axes.  It has
    the ``axis_names`` / ``shape`` surface of a ``MeshShape``, so the
    sharding rules take it unchanged;
    ``models.runtime.use_mesh`` makes it the active mesh of the model
    code (the expert-parallel MoE, the sequence-sharded residual) and
    ``KGETrainer(mesh=)`` row-shards its tables over it.
  * :func:`init_world` and :func:`run_world` — join a world with an
    explicit backend (gloo on the CPU; NCCL with one rank a card; gloo
    for several ranks sharing one card, as NCCL refuses two ranks on one
    device), and run one function in a world of N fresh processes under
    a time limit.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """One ``"data"`` axis of ``torch.device``\\ s, in shard order."""

    devices: Tuple[torch.device, ...]

    @classmethod
    def of(cls, devices: Sequence) -> "ServingMesh":
        """A mesh over ``devices`` (repeats allowed)."""
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a serving mesh needs at least one device")
        return cls(devs)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names mapped to sizes, in mesh order; no devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 ``("data", "model")``; with ``multi_pod`` two of them on a
    leading ``"pod"`` axis."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> MeshShape:
    return MeshShape(("data", "model"), (data, model))


def make_serving_mesh(min_devices: int = 2, kind: str = "cuda"
                      ) -> Optional[ServingMesh]:
    """A ``ServingMesh`` over every visible device of ``kind`` (``cuda``:
    each card; ``cpu``: the one host device), or None when there are fewer
    than ``min_devices``: the caller then serves from one device."""
    n = torch.cuda.device_count() if kind == "cuda" else 1
    if n < min_devices:
        return None
    return ServingMesh(tuple(torch.device(kind, i) for i in range(n)))


# --------------------------------------------------------------------- #
# several processes: torch.distributed
# --------------------------------------------------------------------- #
#: the axes a process mesh may have, in mesh order
PROCESS_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This process's place in a mesh of ``torch.distributed`` ranks.

    Ranks lie on the mesh in row-major order (rank ``r`` sits at
    ``numpy.unravel_index(r, sizes)``), as ``Mesh(np.array(devices)
    .reshape(sizes), names)`` lays devices out.  ``groups`` holds the
    process groups of ``("model",)``, of the data axes (``"pod"`` and
    ``"data"``, where the mesh has them) and of all the axes: each the
    ranks that share this rank's coordinates on every other axis."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    device: torch.device
    groups: Dict[Tuple[str, ...], Any]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def _axes(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if not names or any(a not in self.axis_names for a in names):
            raise ValueError(f"axes {names} not on the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes) -> int:
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes, coords=None) -> int:
        """The position of this rank (or of the rank at ``coords``) along
        ``axes`` taken together, row-major in mesh order (its block of a
        dim sharded over them)."""
        coords = self.coords if coords is None else coords
        i = 0
        for a in self._axes(axes):
            k = self.axis_names.index(a)
            i = i * self.sizes[k] + coords[k]
        return i

    def group(self, axes):
        """The process group of ``axes`` (a name or several: ``"model"``,
        the data axes or all axes) that holds this rank."""
        axes = self._axes(axes)
        if axes not in self.groups:
            raise ValueError(f"no group of axes {axes}: the mesh keeps "
                             f"{sorted(self.groups)}")
        return self.groups[axes]

    @classmethod
    def build(cls, axis_names: Sequence[str], sizes: Sequence[int],
              device) -> "ProcessMesh":
        """The mesh of the initialised world (:func:`init_world`), whose
        size must be the product of ``sizes``.  Collective: every rank
        calls it with the same axes, and every group is made on every
        rank in the same order, as ``new_group`` asks."""
        import torch.distributed as dist
        names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
        if "model" not in names or len(set(names)) != len(names) or any(
                a not in PROCESS_AXES for a in names) or list(names) != [
                a for a in PROCESS_AXES if a in names]:
            raise ValueError(f"axes {names}: want 'model' after any of "
                             f"'pod', 'data', in that order")
        world, rank = dist.get_world_size(), dist.get_rank()
        n = 1
        for s in sizes:
            n *= s
        if n != world or len(sizes) != len(names):
            raise ValueError(f"mesh {dict(zip(names, sizes))} needs {n} "
                             f"ranks; the world has {world}")
        positions = list(itertools.product(*(range(s) for s in sizes)))
        coords = positions[rank]
        dp = tuple(a for a in names if a in ("pod", "data"))
        groups: Dict[Tuple[str, ...], Any] = {}
        for axes in dict.fromkeys(a for a in (("model",), dp, names) if a):
            rest = [i for i, a in enumerate(names) if a not in axes]
            buckets: Dict[tuple, List[int]] = {}
            for r, pos in enumerate(positions):
                buckets.setdefault(tuple(pos[i] for i in rest), []).append(r)
            for key in sorted(buckets):
                g = dist.new_group(buckets[key])
                if rank in buckets[key]:
                    groups[axes] = g
        return cls(names, sizes, coords, torch.device(device), groups)


def init_world(rank: int, world_size: int, *, port: int, backend: str,
               device, timeout_s: float = 300.0) -> torch.device:
    """Join a ``torch.distributed`` world at ``tcp://localhost:port`` as
    ``rank`` of ``world_size`` on ``backend`` (``"gloo"`` or ``"nccl"``,
    never chosen for the caller), its collectives bounded by
    ``timeout_s``.  Returns ``device``, made current for NCCL."""
    import torch.distributed as dist
    dev = torch.device(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL needs a CUDA device a rank")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return dev


def _free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, device, timeout_s, inbox,
               results) -> None:
    import torch.distributed as dist
    try:
        args = inbox.get(timeout=timeout_s)
        torch.set_num_threads(1)        # the ranks share the host's cores
        init_world(rank, world, port=port, backend=backend, device=device,
                   timeout_s=timeout_s)
        out = fn(rank, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, *, backend: str,
              devices, args: tuple = (), timeout_s: float = 300.0
              ) -> List[Any]:
    """``fn(rank, *args)`` in each of ``world_size`` fresh processes
    (the ``spawn`` start method), joined into one world on a free port;
    returns the ranks' results in rank order.  ``fn`` must be importable
    by name, and its results picklable.

    ``devices`` is one device for every rank or one a rank.  Each rank
    uses one CPU thread.  Raises ``RuntimeError`` with the
    traceback of every rank that raised, and ``TimeoutError`` naming the
    ranks that had not finished after ``timeout_s`` (each collective is
    bounded by it too); either way every process is stopped first."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * world_size
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = mp.get_context("spawn")
    # the arguments go through a queue: a start() blocks until its child
    # has read what start() sends it, so large arguments there would
    # start the ranks one after another
    inbox, results = ctx.Queue(), ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, port, backend, str(devices[r]), timeout_s,
        inbox, results)) for r in range(world_size)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put(args)
    deadline = time.monotonic() + timeout_s
    got: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    try:
        while len(got) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if not p.is_alive()
                        and r not in got and r not in errors]
                if dead and results.empty():
                    time.sleep(0.5)       # its last message may be in flight
                    if results.empty():
                        errors.update({r: f"rank {r} exited with "
                                          f"{procs[r].exitcode} and no result"
                                       for r in dead})
                continue
            (got if ok else errors)[rank] = out
            if errors:
                break
        for p in procs:
            p.join(timeout=max(0.0, min(30.0, deadline - time.monotonic()))
                   if not errors else 0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(errors.items())))
    missing = [r for r in range(world_size) if r not in got]
    if missing:
        raise TimeoutError(f"ranks {missing} of {world_size} did not finish "
                           f"within {timeout_s} s")
    return [got[r] for r in range(world_size)]
