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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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
