"""Shard meshes for the sharded data and control planes.

Counterpart of ``repro.launch.mesh``'s debug and lookup meshes. The
reference's mesh is a ``jax.sharding.Mesh`` over devices, and its
sharded entries run one shard per device under ``shard_map``. The
port's :class:`ShardMesh` holds only axis names and sizes, no devices:
a sharded entry (kernels/knn/ops.py, kernels/knn/gains.py,
core/objective.py) runs its shards in turn on the device of the tensors
it is given. The shard count is therefore the caller's choice and does
not depend on the number of cards — on one card the sharded path is a
loop over contiguous balanced chunks, one kernel launch per shard,
carrying out exactly what the reference's ``shard_map`` does.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """Named axes and their sizes; ``shape`` is the ordered dict of axis
    to size that ``jax.sharding.Mesh.shape`` is."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"axis sizes must be positive: {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, (int(s) for s in self.sizes)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= int(s)
        return n


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> ShardMesh:
    """The two-axis ("data", "model") mesh of the reference's tests."""
    return ShardMesh(("data", "model"), (int(n_data), int(n_model)))


def make_lookup_mesh(n_shards: int) -> ShardMesh:
    """The one-axis ("data",) mesh of the sharded lookup: ``n_shards``
    contiguous balanced key chunks."""
    return ShardMesh(("data",), (int(n_shards),))
