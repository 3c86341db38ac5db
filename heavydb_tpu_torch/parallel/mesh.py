"""Device-mesh management for multi-device query execution.

Counterpart of heavydb_tpu/parallel/mesh.py.  There a jax.sharding Mesh
row-partitions tables over a 1-D 'shards' axis and partial aggregates merge
with collectives.  Here the mesh is a 1-D array of torch devices and a
sharding is a description of where a column's rows live: contiguous row
blocks of ceil(size / n) rows, one a shard, or a whole copy on each.

On the CPU, make_mesh gives n virtual shards, all the CPU device: the role
that --xla_force_host_platform_device_count plays for the reference.  A
Mesh may also be built from any list of devices, repeats included, as
jax.sharding.Mesh can (four shards on one card, say).  `shard_blocks`
places a scan's rows on the mesh as the executor runs them
(Config.num_shards): a block of ceil(rows / n) rows a shard, on the
shard's device; blocks cross fragment boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

SHARD_AXIS = "shards"


class Mesh:
    """A 1-D mesh: `devices` is a numpy object array of torch.device."""

    def __init__(self, devices: Sequence, axis_names=(SHARD_AXIS,)):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), object)
        self.devices[:] = devs
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: int(self.devices.size)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices.tolist()))

    def __repr__(self):
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


class Block(NamedTuple):
    """A shard's rows [lo, hi) of a scan, and the device they live on."""

    shard: int
    lo: int
    hi: int
    device: torch.device


def shard_blocks(mesh: Mesh, rows: int) -> List[Block]:
    """Each shard's row block of a scan of `rows` rows, from the row
    sharding's `shard_slices`: the last blocks shorter, or empty when rows
    < shards.  On a mesh whose shards repeat one device a block is a view
    of the column there; on distinct devices it is the device's own copy."""
    return [Block(s, sl.start, sl.stop, mesh.devices[s])
            for s, sl in enumerate(row_sharding(mesh).shard_slices(rows))]


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda") -> Mesh:
    """The first n distinct cards for 'cuda' (all of them by default); n
    virtual shards of the CPU for 'cpu'."""
    if device_type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or k
    if n > k:
        raise ValueError(f"requested {n} devices, only {k} available")
    return Mesh([torch.device("cuda", i) for i in range(n)])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array lives on a mesh: row blocks (`rows`), or a whole copy
    on every shard."""

    mesh: Mesh
    rows: bool

    def block_rows(self, size: int) -> int:
        return -(-size // self.mesh.size) if self.rows else size

    def shard_slices(self, size: int) -> List[slice]:
        """Each shard's rows: contiguous blocks of block_rows(size), the last
        shorter (or empty); the whole range on every shard if replicated."""
        if not self.rows:
            return [slice(0, size)] * self.mesh.size
        b = self.block_rows(size)
        return [slice(min(s * b, size), min((s + 1) * b, size))
                for s in range(self.mesh.size)]


def row_sharding(mesh: Mesh) -> Sharding:
    """Rows partitioned across the shard axis."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)
