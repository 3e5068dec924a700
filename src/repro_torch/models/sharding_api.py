"""Sharding policy interface the models are written against.

Counterpart of ``repro.models.sharding_api``. Models never import mesh
machinery: they call ``shard(x, logical_axes)`` at the places the
reference constrains an activation's layout, and read the two knobs
below. launch/sharding.py's ``MeshShardPolicy`` is the mesh-aware
implementation; the default, :data:`NO_SHARD`, returns ``x`` as it is
(one process holds every tensor whole), so a caller that passes no
policy computes exactly what it computed before policies existed.

Attention strategies (resolved per arch × mode by launch/sharding.py):

* "heads" — tensor parallelism over the q heads; the KV heads are
  repeated up to the TP degree where there are fewer of them
  (``kv_repeat``), so both operands of the attention carry the model
  axis;
* "batch" — the attention sublayer's batch over (data × model), for
  archs whose head count does not divide the model axis;
* "seq" — the attention's sequence axis over the model axis;
* "kv_seq" — decode: the KV cache's sequence axis over the model axis;
* "none" — no attention-specific sharding.

``kv_repeat`` is the one knob that changes what the model computes:
the repeated heads give the same attention up to f32 rounding.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    attn_strategy: str = "none"      # heads | batch | seq | kv_seq | none
    kv_repeat: int = 1               # KV head repetition under heads-TP

    def __call__(self, x, axes):
        """Constrain ``x``'s layout to logical ``axes``; a no-op here."""
        return x


NO_SHARD = ShardPolicy()
