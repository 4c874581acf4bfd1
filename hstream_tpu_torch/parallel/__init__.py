"""Sharded execution over a (data, key) mesh (the port of
hstream_tpu/parallel): the window lattice, the session arena and the
interval join's stores.

A `Mesh` is a [n_data, n_key] grid of torch devices with the axis names
("data", "key"). Every shard (d, k) holds a partial lattice of the key
range k owns on its device; the step runs with no merge, and the merges
run at the drain points (close, changelog, peek, snapshot) in the merged
kernels (parallel/lattice.py). A session arena and a join's stores shard
on the key axis alone: key shard k owns the codes with code mod n_key ==
k and keeps them on the device of shard (0, k). The design is
single-controller, as the reference's is: one process drives every
shard.

Shards wrap round the devices when there are fewer devices than shards
(`make_mesh(2, 2)` on one card puts all four shards on it, and the CPU
tests pass `devices=["cpu"]`): the port's counterpart of the reference's
virtual CPU devices, since CUDA has nothing like XLA's forced host
device count. A deliberate difference (ROADMAP C).
"""

from __future__ import annotations

import numpy as np
import torch

from hstream_tpu_torch.common.errors import DeviceUnavailable
from hstream_tpu_torch.device import resolve


class Mesh:
    """A (data, key) grid of devices: `devices[d, k]` holds shard (d, k);
    `shape` maps each axis name to its size, as jax.sharding.Mesh's."""

    axis_names = ("data", "key")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or 0 in devices.shape:
            raise ValueError("a mesh is a non-empty [n_data, n_key] grid")
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]),
                      "key": int(devices.shape[1])}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["key"]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, key={self.shape['key']}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def make_mesh(n_data: int | None = None, n_key: int = 1,
              devices=None) -> Mesh:
    """A (data, key) mesh over `devices` (the visible cards by default),
    row-major: shard (d, k) takes device (d * n_key + k) mod the device
    count, so shards wrap round fewer devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "make_mesh() places shards on the CUDA cards and none is "
                "available; pass devices=['cpu'] for the plain versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    if n_key < 1:
        raise ValueError("n_key must be at least 1")
    if n_data is None:
        n_data = max(1, len(devs) // n_key)
    grid = np.empty((n_data, n_key), dtype=object)
    for i in range(n_data * n_key):
        grid[i // n_key, i % n_key] = devs[i % len(devs)]
    return Mesh(grid)


from hstream_tpu_torch.parallel.lattice import (  # noqa: E402
    ShardedJoinLattice,
    ShardedLattice,
    ShardedSessionLattice,
)
from hstream_tpu_torch.parallel.executor import (  # noqa: E402
    ShardedQueryExecutor,
)

__all__ = ["Mesh", "ShardedJoinLattice", "ShardedLattice",
           "ShardedQueryExecutor", "ShardedSessionLattice", "make_mesh"]
