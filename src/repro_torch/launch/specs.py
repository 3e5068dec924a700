"""Input specs and step builders for every (arch × shape) cell of the dry
run.

Counterpart of ``repro.launch.specs``. The reference's abstract inputs
are ``jax.ShapeDtypeStruct``s; the port's are tensors on the ``meta``
device, which carry a shape and a dtype and allocate nothing. The trees
keep the reference's layout (every block's leaves stacked on the
super-block axis, ``models.schema.stacked_schema``), so the mesh
policy's spec trees apply to them leaf for leaf.

The steps are the port's own: the train step is ``train/trainer.py``'s
``make_step`` (autograd through the model, each super-block
rematerialised where ``cfg.remat`` is set, then AdamW), the serve step
and the prefill ``models/model.py``'s — so the operations the dry run
counts are the ones the card runs. A step takes a ``DecoderLM``, not a
tree: :meth:`Cell.model` builds one on the meta device, with plain or
(given a device mesh) DTensor parameters, and :meth:`Cell.step_args`
the rest of the step's arguments in the same form.

Two deviations from the reference's inputs: token ids and M-RoPE
positions are int64 (the port's embedding and trainer take int64; the
reference's are int32), and the decode cache is the port's list of one
dict a layer (:func:`abstract_caches` gives the stacked tree its specs
resolve on).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import (MeshShardPolicy, replicated,
                                         spec_placements)
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.models.schema import ParamSpec, layer_kinds, stacked_schema
from repro_torch.models.transformer import DecoderLM, init_cache
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.train.trainer import make_step

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing: a pure
    full-attention arch skips it, and says so."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: long_500k skipped per "
                       "assignment (needs sub-quadratic attention)")
    return True, ""


def _dtype(name) -> torch.dtype:
    return getattr(torch, name) if isinstance(name, str) else name


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=_dtype(dtype), device=META)


# -------------------------------------------------------- abstract trees
def abstract_params(cfg: ArchConfig, dtype: str | None = None) -> Any:
    """The parameter tree in the reference's layout, meta tensors of
    ``dtype`` (default the parameter dtype)."""
    dt = dtype or cfg.param_dtype

    def walk(node):
        if isinstance(node, ParamSpec):
            return _meta(node.shape, dt)
        return {k: walk(v) for k, v in node.items()}
    return walk(stacked_schema(cfg))


def abstract_opt_state(cfg: ArchConfig, opt: AdamWConfig) -> Any:
    """AdamW's state as ``optim.adamw_init`` builds it, in the
    reference's layout: f32, bf16 or int8 moments (``{"q", "s"}``, one
    f32 scale a row of the trailing axis), the step an int32 scalar."""
    def moment(node):
        if isinstance(node, ParamSpec):
            if opt.moment_dtype == "int8":
                return {"q": _meta(node.shape, torch.int8),
                        "s": _meta(node.shape[:-1] + (1,), torch.float32)}
            return _meta(node.shape, opt.moment_dtype)
        return {k: moment(v) for k, v in node.items()}
    tree = stacked_schema(cfg)
    return {"m": moment(tree), "v": moment(tree),
            "step": _meta((), torch.int32)}


def train_batch_shapes(cfg: ArchConfig, cell: ShapeCell,
                       with_labels: bool = True) -> dict:
    """A batch of ``cell``'s size, meta tensors: the reference's keys and
    shapes (64+ audio frames' worth of decoder tokens for an
    encoder-decoder, a quarter of the sequence as image patches with
    M-RoPE ids for the VLM), int64 ids."""
    B, S = cell.batch, cell.seq
    ct, i64 = cfg.compute_dtype, torch.int64
    out: dict = {}
    if cfg.is_encdec:
        s_dec = max(S // 4, 64)
        out["audio_embeds"] = _meta((B, S, 128), ct)
        out["tokens"] = _meta((B, s_dec), i64)
        if with_labels:
            out["labels"] = _meta((B, s_dec), i64)
    elif cfg.mrope:
        s_img = S // 4
        out["image_embeds"] = _meta((B, s_img, 1280), ct)
        out["tokens"] = _meta((B, S - s_img), i64)
        out["mrope_positions"] = _meta((3, B, S), i64)
        if with_labels:
            out["labels"] = _meta((B, S - s_img), i64)
    else:
        out["tokens"] = _meta((B, S), i64)
        if with_labels:
            out["labels"] = _meta((B, S), i64)
    return out


def abstract_caches(cfg: ArchConfig, B: int, S: int) -> dict:
    """The serving cache in the reference's layout (block key → leaves
    stacked over the super-blocks), meta tensors."""
    layers = init_cache(cfg, B, S, device=META)
    out: dict = {}
    for (key, _), layer in zip(layer_kinds(cfg), layers):
        for name, t in layer.items():
            out.setdefault(key, {}).setdefault(name, []).append(t)
    return {key: {name: torch.stack(ts) for name, ts in leaves.items()}
            for key, leaves in out.items()}


# ----------------------------------------------------------- step fns --
def make_train_step(cfg: ArchConfig, policy: MeshShardPolicy,
                    opt: AdamWConfig, bf16_flows: bool = False
                    ) -> Callable:
    """(model, opt_state, batch) → (loss, metrics), the model and state
    updated in place: the trainer's step (``make_step``, the reference's
    default warmup-cosine schedule). ``bf16_flows``: the forward and
    backward run on a copy of the parameters cast to the compute dtype
    (the FSDP gathers and gradient reductions then move bf16), and the
    update applies those bf16 gradients to the f32 parameters."""
    if not bf16_flows:
        return make_step(cfg, opt, 100, 10000, shard=policy)
    ct = _dtype(cfg.compute_dtype)

    def train_step(model: DecoderLM, opt_state: dict, batch: dict):
        low = copy.deepcopy(model).to(ct)
        loss, metrics, grads = model_api.loss_and_grads(cfg, low, batch,
                                                        policy)
        adamw_update(grads, opt_state, dict(model.named_parameters()), opt,
                     lr_scale=cosine_schedule(opt_state["step"]))
        return loss, metrics
    return train_step


def make_serve_step(cfg: ArchConfig, policy: MeshShardPolicy) -> Callable:
    """``models.model.make_serve_step``'s step under ``torch.no_grad``
    in place of its ``inference_mode``: the same operations, but a
    DTensor refuses the in-place cache write on an inference tensor, and
    an inference tensor left from one cell's run in another's."""
    def serve_step(params: DecoderLM, tokens: torch.Tensor, caches: list,
                   pos: int):
        with torch.no_grad():
            logits, caches, _ = model_api.forward(
                cfg, params, model_api.serve_batch(cfg, tokens, pos),
                mode="decode", caches=caches, pos=pos, shard=policy)
        return logits, caches
    return serve_step


def make_prefill_step(cfg: ArchConfig, policy: MeshShardPolicy
                      ) -> Callable:
    """``models.model.make_prefill``'s forward under ``torch.no_grad``
    (as :func:`make_serve_step`)."""
    def prefill(params: DecoderLM, batch: dict):
        with torch.no_grad():
            logits, caches, _ = model_api.forward(
                cfg, params, batch, mode="prefill", shard=policy)
        return logits, caches
    return prefill


# ------------------------------------------------- cell assembly (dryrun)
def _to_dtensor(x: torch.Tensor, spec: tuple, device_mesh) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, device_mesh, spec_placements(
        spec, device_mesh.mesh_dim_names))


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


@dataclasses.dataclass
class Cell:
    """One dry-run cell: its step ``fn``, the step's abstract inputs in
    the reference's layout (``abstract``: params, then the other
    arguments) and their spec trees (``specs``, the same structure)."""
    cfg: ArchConfig
    cell: ShapeCell
    mesh: ShardMesh
    policy: MeshShardPolicy
    fn: Callable
    abstract: tuple
    specs: tuple
    param_dtype: torch.dtype

    def model(self, device_mesh=None) -> DecoderLM:
        """A ``DecoderLM`` on the meta device in the cell's parameter
        dtype; with ``device_mesh`` every parameter is a DTensor laid
        out by its spec (a layer's spec is its stacked leaf's without
        the super-block axis, which no rule splits)."""
        model = DecoderLM(self.cfg, META).to(self.param_dtype)
        model.requires_grad_(False)
        if device_mesh is None:
            return model
        for name, (path, idx) in convert._tree_slots(self.cfg,
                                                     model).items():
            spec = _leaf(self.specs[0], path)
            spec = spec if idx is None else spec[1:]
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            p = mod._parameters[leaf]
            mod._parameters[leaf] = torch.nn.Parameter(
                _to_dtensor(p.detach(), spec, device_mesh),
                requires_grad=False)
        return model

    def step_args(self, model: DecoderLM, device_mesh=None) -> tuple:
        """The step's arguments after the model, meta tensors (DTensors
        laid out by their specs with ``device_mesh``): the optimizer
        state keyed by the model's parameter names and the batch
        (train), the batch (prefill), or the tokens, the cache (one
        dict a layer) and the position (decode). A layer's leaf is entry
        s of its stacked leaf, its spec the stacked spec without the
        super-block axis."""
        def place(x, spec, idx=None):
            if idx is not None:
                x, spec = x[idx], spec[1:]
            return x if device_mesh is None else \
                _to_dtensor(x, spec, device_mesh)
        kind = self.cell.kind
        if kind == "train":
            (opt_state, batch), (ospec, bspec) = self.abstract[1:], \
                self.specs[1:]
            state = {"step": torch.zeros((), dtype=torch.int32,
                                         device=META)}
            for key in ("m", "v"):
                state[key] = {}
                for name, (path, idx) in convert._tree_slots(
                        self.cfg, model).items():
                    leaf, spec = _leaf(opt_state[key], path), \
                        _leaf(ospec[key], path)
                    state[key][name] = (
                        {k: place(leaf[k], spec[k], idx) for k in leaf}
                        if isinstance(leaf, dict) else
                        place(leaf, spec, idx))
            return state, {k: place(v, bspec[k]) for k, v in batch.items()}
        if kind == "prefill":
            batch, bspec = self.abstract[1], self.specs[1]
            return ({k: place(v, bspec[k]) for k, v in batch.items()},)
        tokens, caches, pos = self.abstract[1:]
        tspec, cspec = self.specs[1:3]
        layers = [{name: place(t, cspec[key][name], s)
                   for name, t in caches[key].items()}
                  for key, s in convert._layer_slices(self.cfg)]
        return place(tokens, tspec), layers, pos


def build_cell(cfg: ArchConfig, cell: ShapeCell | str, mesh: ShardMesh,
               opt: AdamWConfig, seq_shard: bool = False,
               ffn_mode: str = "tp", attn_override: str | None = None,
               serve_fsdp: bool = True, bf16_flows: bool = False) -> Cell:
    """The :class:`Cell` of ``cfg`` at ``cell`` (a ``SHAPES`` name or a
    ``ShapeCell``) on ``mesh``, with the policy's knobs."""
    cell = SHAPES[cell] if isinstance(cell, str) else cell
    schema_tree = stacked_schema(cfg)
    pol = dict(ffn_mode=ffn_mode, attn_override=attn_override,
               serve_fsdp=serve_fsdp)
    if cell.kind == "train":
        policy = MeshShardPolicy.create(cfg, mesh, "train",
                                        seq_shard=seq_shard, **pol)
        batch = train_batch_shapes(cfg, cell)
        moments = policy.moment_sharding_tree(schema_tree, opt.moment_dtype)
        return Cell(
            cfg, cell, mesh, policy,
            make_train_step(cfg, policy, opt, bf16_flows=bf16_flows),
            (abstract_params(cfg), abstract_opt_state(cfg, opt), batch),
            (policy.param_sharding_tree(schema_tree),
             {"m": moments, "v": moments, "step": replicated(mesh)},
             policy.batch_sharding_tree(batch)),
            _dtype(cfg.param_dtype))
    serving = _dtype(cfg.compute_dtype)
    if cell.kind == "prefill":
        policy = MeshShardPolicy.create(cfg, mesh, "prefill",
                                        seq_shard=seq_shard, **pol)
        batch = train_batch_shapes(cfg, cell, with_labels=False)
        return Cell(cfg, cell, mesh, policy, make_prefill_step(cfg, policy),
                    (abstract_params(cfg, cfg.compute_dtype), batch),
                    (policy.param_sharding_tree(schema_tree),
                     policy.batch_sharding_tree(batch)), serving)
    # decode: one new token against a seq_len cache
    policy = MeshShardPolicy.create(cfg, mesh, "decode", **pol)
    tokens = _meta((cell.batch, 1), torch.int64)
    caches = abstract_caches(cfg, cell.batch, cell.seq)
    return Cell(cfg, cell, mesh, policy, make_serve_step(cfg, policy),
                (abstract_params(cfg, cfg.compute_dtype), tokens, caches,
                 cell.seq - 1),
                (policy.param_sharding_tree(schema_tree),
                 policy.batch_sharding_tree({"tokens": tokens})["tokens"],
                 policy.cache_sharding_tree(caches), replicated(mesh)),
                serving)
