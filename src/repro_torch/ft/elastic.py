"""Elastic scaling: checkpoint → a different mesh.

Counterpart of ``repro.ft.elastic``. Checkpoints are mesh-agnostic
(whole arrays per leaf, checkpoint/ckpt.py), so scaling a job up or down
is: stop, ``restore_for_mesh`` with the new mesh's spec tree, continue.
The deterministic data pipeline (data/pipeline.py) is keyed by step, so
the new world size re-partitions batches without skipping or repeating
data. This module picks the new mesh for a changed device count and
gives the spec tree every parameter restores by.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import MeshShardPolicy
from repro_torch.models.schema import stacked_schema


def plan_mesh(n_devices: int, model_parallelism: int = 16) -> ShardMesh:
    """A (data, model) mesh for ``n_devices``: the tensor-parallel degree
    halved until it divides the device count."""
    while n_devices % model_parallelism and model_parallelism > 1:
        model_parallelism //= 2
    return ShardMesh(("data", "model"),
                     (n_devices // model_parallelism, model_parallelism))


def reshard_plan(cfg: ArchConfig, mesh: ShardMesh,
                 mode: str = "train") -> dict:
    """The parameter spec tree on ``mesh`` (the reference's layout), for
    ``checkpoint.restore_for_mesh``."""
    policy = MeshShardPolicy.create(cfg, mesh, mode)
    return policy.param_sharding_tree(stacked_schema(cfg))
