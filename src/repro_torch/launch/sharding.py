"""Which mesh axes the similarity cache shards over.

Counterpart of the lookup half of ``repro.launch.sharding``: the
divisibility resolver ``_resolve`` and :class:`LookupShardPolicy`. The
language-model half (``MeshShardPolicy``) belongs with the training
scaffolding, a later slice of the port (ROADMAP queue 1, item 14).

``_resolve`` returns, per dimension, the tuple of mesh axes chosen for
it (or None), where the reference returns a ``PartitionSpec`` of the
same entries.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.knn.ops import mesh_axes_size
from repro_torch.launch.mesh import ShardMesh


def _resolve(shape: tuple, axes: tuple, rules: dict, mesh) -> tuple:
    """Map logical axis names to mesh axes honoring divisibility: per
    dimension, the rule's axes that are in the mesh, not yet used by
    another dimension, and divide what is left of the dimension."""
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        chosen: list = []
        rem = int(dim)
        for ax in rules.get(name, ()):
            if ax in mesh.shape and ax not in used and \
                    rem % mesh.shape[ax] == 0:
                chosen.append(ax)
                used.add(ax)
                rem //= mesh.shape[ax]
        out.append(tuple(chosen) if chosen else None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class LookupShardPolicy:
    """Key-axis sharding policy of the similarity cache.

    The sharded data plane (core/simcache.py) cuts the segmented key
    tensor into ``n_shards`` contiguous balanced chunks; this policy
    decides over which mesh axes, preferring "model", then "data", then
    "pod" (lookup shards then sit with tensor-parallel shards), and
    falling back to every axis of a mesh that has none of those. The key
    axis is padded to a multiple of the shard count, so the axes are
    resolved against the full product of the present candidates.

    ``prune`` selects the per-shard candidate tables (kernels/knn/lsh.py):
    shard s builds its own tables over its chunk from
    ``policy.for_shard(s)``, seeded from ``table_seed``.

    The control plane rides the same axes: :meth:`gain_shard_args` gives
    the (mesh, axes) that a ``DeviceInstance`` takes, which shards the
    gain oracle's candidate axis (``sharded_placement_gains``) and the
    best-two tables' request axis (``sharded_best_two_tables``). Either
    way every value is bitwise the unsharded one.
    """
    mesh: ShardMesh
    axes: tuple[str, ...]
    prune: str | None = None
    table_seed: int = 0

    @classmethod
    def create(cls, mesh: ShardMesh,
               candidates: tuple[str, ...] = ("model", "data", "pod"),
               prune: str | None = None,
               table_seed: int = 0) -> "LookupShardPolicy":
        present = tuple(ax for ax in candidates if ax in mesh.shape)
        if not present:                  # unrecognised axes: use them all
            present = tuple(mesh.axis_names)
        total = mesh_axes_size(mesh, present)
        chosen = _resolve((total,), ("keys",), {"keys": present}, mesh)[0]
        return cls(mesh=mesh, axes=chosen or (), prune=prune,
                   table_seed=table_seed)

    @property
    def n_shards(self) -> int:
        return mesh_axes_size(self.mesh, self.axes)

    def candidate_policy(self):
        """The base CandidatePolicy of this deployment (None when pruning
        is off); SimCacheNetwork derives per-shard tables from it through
        ``for_shard``."""
        if self.prune is None:
            return None
        from repro_torch.kernels.knn.lsh import default_policy
        return default_policy(self.prune, seed=self.table_seed)

    def gain_shard_args(self) -> tuple[ShardMesh, tuple[str, ...]] | None:
        """(mesh, axes) for sharding the control plane, or None when the
        policy resolves to one shard (everything then runs unsharded)."""
        if self.n_shards <= 1:
            return None
        return (self.mesh, self.axes)

    def control_plane_args(self, enabled: bool = True
                           ) -> tuple[ShardMesh, tuple[str, ...]] | None:
        """:meth:`gain_shard_args` when the engine's data plane is sharded
        (``enabled``), else None — a policy held for its table seeds alone
        never shards a solve. The engine passes ``mesh`` and ``axes``
        straight to its DeviceInstance, which gives the same answer."""
        if not enabled:
            return None
        return self.gain_shard_args()
