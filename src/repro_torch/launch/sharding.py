"""Mesh-aware sharding: logical axes → mesh axes with divisibility
fallbacks, for the language models and for the similarity cache.

Counterpart of ``repro.launch.sharding``, all of it:

* the resolver ``_resolve``: per dimension, the longest run of a rule's
  candidate axes that are in the mesh, unused by another dimension and
  divide what is left of the dimension;
* :class:`MeshShardPolicy`, the models' policy (models/sharding_api.py):
  parameter, optimizer-moment, cache, batch and activation specs per
  arch × mode, with the reference's knobs (``seq_shard``, ``ffn_mode``,
  ``attn_override``, ``serve_fsdp``);
* :class:`LookupShardPolicy`, the similarity cache's key-axis policy.

A spec is a tuple with one entry a dimension: the tuple of mesh axes the
dimension is split over, or None — the entries of the reference's
``PartitionSpec``. The mesh is a ``ShardMesh`` (launch/mesh.py), axis
names and sizes with no devices. A spec is applied in one of two ways:

* ``MeshShardPolicy.__call__`` returns a plain tensor as it is (one
  process holds it whole) and redistributes a ``DTensor`` to the spec's
  placements on the DTensor's own device mesh (the dry run's collective
  count, launch/dryrun.py);
* :func:`local_shard` cuts one device's block out of a whole tensor
  (the dry run's per-device bytes, elastic restore in
  checkpoint/ckpt.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.knn.ops import mesh_axes_size
from repro_torch.launch.mesh import ShardMesh
from repro_torch.models.schema import ParamSpec
from repro_torch.models.sharding_api import ShardPolicy


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



def attn_strategy_for(cfg: ArchConfig, mesh: ShardMesh, mode: str) -> str:
    """"kv_seq" in decode, else "heads" where the heads divide the model
    axis and "batch" where they do not."""
    if mode == "decode":
        return "kv_seq"
    if cfg.n_heads % mesh.shape.get("model", 1) == 0:
        return "heads"
    return "batch"


def kv_repeat_for(cfg: ArchConfig, mesh: ShardMesh, strategy: str) -> int:
    """Repeat KV heads up to the TP degree under heads-TP (GQA)."""
    model = mesh.shape.get("model", 1)
    if strategy != "heads" or cfg.n_kv_heads >= model:
        return 1
    if model % cfg.n_kv_heads == 0:
        return model // cfg.n_kv_heads
    return 1


def spec_placements(spec: tuple, mesh_dim_names: tuple) -> list:
    """The DTensor placements of ``spec`` on a device mesh whose
    dimensions are named ``mesh_dim_names``: ``Shard(d)`` on each mesh
    dimension that splits tensor dimension d, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    placements = [Replicate()] * len(mesh_dim_names)
    for dim, axes in enumerate(spec):
        for ax in axes or ():
            placements[mesh_dim_names.index(ax)] = Shard(dim)
    return placements


def shard_slices(shape: tuple, spec: tuple, mesh: ShardMesh,
                 coords: dict) -> tuple:
    """The index of the block of a ``shape`` tensor that the device at
    ``coords`` (mesh axis → index; an axis left out is 0) holds under
    ``spec``: a dimension split over axes (a, b) is cut into
    size(a)·size(b) blocks, a the major index, as the reference's
    ``NamedSharding`` lays them out."""
    sizes = mesh.shape
    index = []
    for dim, axes in enumerate(spec):
        n, idx = 1, 0
        for ax in axes or ():
            n *= sizes[ax]
            idx = idx * sizes[ax] + int(coords.get(ax, 0))
        block = shape[dim] // n
        index.append(slice(idx * block, (idx + 1) * block))
    return tuple(index)


def local_shard(x: torch.Tensor, spec: tuple, mesh: ShardMesh,
                coords: dict) -> torch.Tensor:
    """The block of ``x`` that the device at ``coords`` holds under
    ``spec`` (:func:`shard_slices`), a view (a meta tensor stays one: the
    dry run counts bytes with it)."""
    return x[shard_slices(tuple(x.shape), spec, mesh, coords)]


@dataclasses.dataclass(frozen=True)
class MeshShardPolicy(ShardPolicy):
    """ShardPolicy backed by a mesh (models call it).

    Perf knobs, the reference's (defaults are its baseline):

    * ``ffn_mode="dp"``: no tensor parallelism; activations
      sequence-shard over the model axis; ``"dp_batch"``: pure data
      parallelism over every axis, the model axis included;
    * ``attn_override``: the attention strategy in place of the one
      :func:`attn_strategy_for` picks (``create``'s argument);
    * ``serve_fsdp=False``: serving parameters replicate over the data
      axis.

    Strategy per arch × mode: parameters TP (heads, ff, vocab, experts
    over "model" where they divide) and FSDP (embed over "data");
    moments inherit the parameter specs; train and prefill shard the
    batch over (pod, data), the attention by heads where they divide the
    model axis (KV heads repeated up to it) and by batch otherwise;
    decode shards the KV cache's sequence axis over "model"."""
    cfg: ArchConfig = None
    mesh: ShardMesh = None
    mode: str = "train"
    seq_shard: bool = False          # prefill sequence parallelism knob
    ffn_mode: str = "tp"             # tp | dp | dp_batch
    serve_fsdp: bool = True

    @classmethod
    def create(cls, cfg: ArchConfig, mesh: ShardMesh, mode: str,
               seq_shard: bool = False, ffn_mode: str = "tp",
               attn_override: str | None = None,
               serve_fsdp: bool = True) -> "MeshShardPolicy":
        strategy = attn_override or attn_strategy_for(cfg, mesh, mode)
        if ffn_mode == "dp" and mode != "decode":
            strategy = "seq"
        if ffn_mode == "dp_batch" and mode != "decode":
            strategy = "batch"
        return cls(attn_strategy=strategy,
                   kv_repeat=kv_repeat_for(cfg, mesh, strategy),
                   cfg=cfg, mesh=mesh, mode=mode, seq_shard=seq_shard,
                   ffn_mode=ffn_mode, serve_fsdp=serve_fsdp)

    # ------------------------------------------------- activation rules
    def act_rules(self) -> dict:
        dp = self.ffn_mode in ("dp", "dp_batch")
        # dp_batch: pure data parallelism over every axis, model included
        batch = ("pod", "data", "model") if self.ffn_mode == "dp_batch" \
            else ("pod", "data")
        heads = ("model",) if self.attn_strategy == "heads" else ()
        return {
            "batch": batch,
            "attn_batch": batch + (("model",) if self.attn_strategy
                                   == "batch" else ()),
            "seq": ("model",) if (self.seq_shard or self.ffn_mode == "dp")
            else (),
            "attn_seq": ("model",) if self.attn_strategy == "seq" else (),
            "kv_seq": ("model",),
            "heads": heads,
            "rep_kv_heads": heads,
            "kv_heads": (),
            "head_dim": (),
            "embed": (),
            "ff": () if dp else ("model",),
            "vocab": () if dp else ("model",),
            "experts": () if dp else ("model",),
            # MoE dispatch groups follow the token sharding
            "moe_group": batch + (("model",) if self.ffn_mode == "dp"
                                  else ()),
            "layers": (),
            "state": (),
        }

    def spec_for(self, shape: tuple, axes: tuple) -> tuple:
        return _resolve(shape, axes, self.act_rules(), self.mesh)

    def __call__(self, x, axes):
        """``x`` as it is where it is a plain tensor; a DTensor
        redistributed to the spec of ``axes`` on its own device mesh."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        spec = self.spec_for(tuple(x.shape), axes)
        mesh = x.device_mesh
        return x.redistribute(mesh, spec_placements(spec,
                                                    mesh.mesh_dim_names))

    # ------------------------------------------------------ param rules
    def param_rules(self) -> dict:
        dp = self.ffn_mode in ("dp", "dp_batch")
        heads_tp = ("model",) if not dp \
            and self.attn_strategy in ("heads", "kv_seq") \
            and self.cfg.n_heads % self.mesh.shape.get("model", 1) == 0 \
            else ()
        # serving without FSDP replicates over data; FSDP stays on the
        # data axis alone, also in the dp modes
        fsdp = ("data",) if (self.mode == "train" or self.serve_fsdp) else ()
        # decode of head-indivisible archs: attention weights split on
        # head_dim instead
        head_dim_tp = ("model",) if (self.mode == "decode" and not dp
                                     and not heads_tp) else ()
        return {
            "heads": heads_tp,
            "kv_heads": heads_tp,        # divisibility usually drops this
            "head_dim": head_dim_tp,
            "embed": fsdp,
            "ff": () if dp else ("model",),
            "vocab": () if dp else ("model",),
            "experts": () if dp else ("model",),
            "layers": (),
            None: (),
        }

    def param_spec(self, ps: ParamSpec) -> tuple:
        return _resolve(ps.shape, ps.axes, self.param_rules(), self.mesh)

    def param_sharding_tree(self, schema_tree: Any) -> Any:
        """Nested dict of specs mirroring a schema tree (the reference's
        layout: ``models.schema.stacked_schema``)."""
        def walk(node):
            if isinstance(node, ParamSpec):
                return self.param_spec(node)
            return {k: walk(v) for k, v in node.items()}
        return walk(schema_tree)

    def moment_sharding_tree(self, schema_tree: Any, moment_dtype: str
                             ) -> Any:
        """Optimizer-moment specs: the parameter's; an int8 moment's
        ``{"q", "s"}``, the scale's last dimension unsharded."""
        def walk(node):
            if isinstance(node, ParamSpec):
                spec = self.param_spec(node)
                if moment_dtype != "int8":
                    return spec
                parts = list(spec) + [None] * (len(node.shape) - len(spec))
                return {"q": spec, "s": tuple(parts[:-1] + [None])}
            return {k: walk(v) for k, v in node.items()}
        return walk(schema_tree)

    # ------------------------------------------------------ cache rules
    def cache_spec(self, key: str, shape: tuple) -> tuple:
        """The spec of a stacked cache leaf ``key`` (the reference's
        layout: the super-block axis first)."""
        batch = ("pod", "data")
        by_key = {
            "k": (None, batch, ("model",), None, None),
            "v": (None, batch, ("model",), None, None),
            "xk": (None, batch, ("model",), None, None),
            "xv": (None, batch, ("model",), None, None),
            "k_s": (None, batch, ("model",), None, None),
            "v_s": (None, batch, ("model",), None, None),
            "h": (None, batch, ("model",), None),          # mamba (Di)
            "conv": (None, batch, None, ("model",)),       # mamba conv buf
            "C": (None, batch, None, ("model",), None),    # mlstm
            "n": (None, batch, None, ("model",)),
            "c": (None, batch, None, ("model",)),          # slstm
        }
        cands = by_key.get(key, (None,) * len(shape))
        used: set = set()
        parts = []
        for dim, cand in zip(shape, cands):
            if cand is None:
                parts.append(None)
                continue
            chosen = []
            rem = int(dim)
            for ax in cand:
                if ax in self.mesh.shape and ax not in used and \
                        rem % self.mesh.shape[ax] == 0:
                    chosen.append(ax)
                    used.add(ax)
                    rem //= self.mesh.shape[ax]
            parts.append(tuple(chosen) if chosen else None)
        return tuple(parts)

    def cache_sharding_tree(self, cache_shapes: Any) -> Any:
        """Specs of a stacked cache tree (block key → {leaf: shaped})."""
        def walk(node):
            return {k: (walk(v) if isinstance(v, dict) else
                        self.cache_spec(k, tuple(v.shape)))
                    for k, v in node.items()}
        return walk(cache_shapes)

    # ------------------------------------------------------ batch rules
    def batch_sharding_tree(self, batch_shapes: dict) -> dict:
        out = {}
        for k, v in batch_shapes.items():
            shape = tuple(v.shape)
            if k == "mrope_positions":              # (3, B, S)
                out[k] = _resolve(shape, (None, "batch", "seq"),
                                  self.act_rules(), self.mesh)
            elif len(shape) >= 2:
                axes = ("batch", "seq") + (None,) * (len(shape) - 2)
                out[k] = _resolve(shape, axes, self.act_rules(), self.mesh)
            else:
                out[k] = ()
        return out

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


def replicated(mesh: ShardMesh) -> tuple:
    """The spec of a tensor every device holds whole."""
    return ()


def count_devices(mesh: ShardMesh) -> int:
    return math.prod(mesh.shape.values())
