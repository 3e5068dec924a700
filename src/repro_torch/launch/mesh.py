"""Shard meshes for the sharded data and control planes, the production
meshes of the dry run, and the card's peak constants.

Counterpart of ``repro.launch.mesh``. The
reference's mesh is a ``jax.sharding.Mesh`` over devices, and its
sharded entries run one shard per device under ``shard_map``. The
port's :class:`ShardMesh` holds only axis names and sizes, no devices:
a sharded entry (kernels/knn/ops.py, kernels/knn/gains.py,
core/objective.py) runs its shards in turn on the device of the tensors
it is given. The shard count is therefore the caller's choice and does
not depend on the number of cards — on one card the sharded path is a
loop over contiguous balanced chunks, one kernel launch per shard,
carrying out exactly what the reference's ``shard_map`` does.

The production meshes keep the reference's shapes — one pod of 16 × 16
devices on ("data", "model"), two pods on ("pod", "data", "model") — so
that every spec the mesh policy (launch/sharding.py) resolves on them
can be held against the reference's. With H100s a "pod" is a cluster
of 8-GPU NVLink nodes: the 16-wide model axis spans two nodes, and the
pod axis crosses the data-centre network.

The constants feed the roofline (launch/roofline.py). They are NVIDIA's
H100 SXM5 datasheet values at its 700 W power limit, not measurements:
a card set below 700 W runs slower under load.
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


def make_production_mesh(multi_pod: bool = False) -> ShardMesh:
    """(16, 16) on ("data", "model"), or (2, 16, 16) on ("pod", "data",
    "model") with ``multi_pod``: the reference's 256- and 512-device
    meshes."""
    if multi_pod:
        return ShardMesh(("pod", "data", "model"), (2, 16, 16))
    return ShardMesh(("data", "model"), (16, 16))


# H100 SXM5 datasheet constants (per GPU, 700 W power limit), used by the
# roofline analysis
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
# B/s per GPU for a collective: one 400 Gb/s NDR InfiniBand port per GPU,
# because a 16-wide mesh axis crosses an 8-GPU NVLink node. Within a node
# NVLink gives 450e9 B/s each way; a model axis of 8 or fewer GPUs would
# run at that rate instead.
LINK_BW = 50e9
