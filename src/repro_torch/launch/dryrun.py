"""Multi-pod dry run: every (arch × shape) cell on the production meshes,
with nothing allocated and no device touched.

Counterpart of ``repro.launch.dryrun``. The reference lowers and
compiles each cell's step for 256 or 512 fake XLA devices and reads
XLA's memory and cost analyses and its HLO. PyTorch has no such
compiler, so each of the record's terms comes from its own pass:

* **memory** — per-device argument bytes: every leaf of the step's
  inputs (parameters, optimizer state, batch, cache) cut by its spec
  (launch/sharding.py's ``local_shard``, on meta tensors);
* **FLOPs** — the step run once on the ``meta`` device under
  ``torch.utils.flop_counter.FlopCounterMode``: the global FLOPs of the
  port's own step (the remat recompute included), divided by the device
  count and max'ed with ``roofline.analytic_flops`` / devices, as the
  reference max'es XLA's count with it;
* **bytes** — ``roofline.analytic_bytes``;
* **collectives** — the step run once more with DTensor parameters and
  inputs laid out by their specs, on a device mesh of the production
  shape over a fake process group of the mesh's size (meta local
  tensors: the collectives are recorded, never sent), under
  ``CommDebugMode``; each collective is priced by
  ``roofline._ring_bytes`` from its output's bytes and its group's
  size. The run goes through :func:`dtensor_seam`, the one place the
  dry run touches torch's internals, which also runs the ops DTensor
  has no strategy for shard by shard. Where a step still fails, the
  record holds ``"collectives": null`` and names the op
  (``collectives_error``); a cell whose FLOPs cannot be counted on meta
  says so in the same way and keeps the analytic FLOPs.

Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(resumable: existing cells are skipped unless ``--force``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh single multi [--force] [--seq-shard]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import ShardMesh, make_production_mesh
from repro_torch.launch.sharding import count_devices, local_shard
from repro_torch.launch.specs import SHAPES, Cell, ShapeCell, build_cell, \
    supported
from repro_torch.models.schema import param_count
from repro_torch.optim import AdamWConfig

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# the functional collectives a DTensor run issues, by the reference's
# HLO op names
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_reduce": "all-reduce",
                   "all_to_all_single": "all-to-all",
                   "shard_dim_alltoall": "all-to-all"}


def opt_for(cfg) -> AdamWConfig:
    """8-bit moments for ≥30B models (otherwise f32), as the reference."""
    big = param_count(cfg) > 30e9
    return AdamWConfig(moment_dtype="int8" if big else "float32")


# ----------------------------------------------------------------- memory
def _tree_bytes(tree, specs, mesh: ShardMesh) -> int:
    """Bytes of one device's blocks of a tree of meta tensors."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], specs[k], mesh) for k in tree)
    if not isinstance(tree, torch.Tensor):
        return 0                              # the decode position
    block = local_shard(tree, specs, mesh, {})
    return block.numel() * block.element_size()


def argument_bytes(c: Cell) -> dict:
    """Per-device bytes of the step's inputs, by part: ``params``,
    ``opt_state`` and ``batch`` (train), ``batch`` (prefill), ``tokens``
    and ``cache`` (decode); ``argument_size_in_bytes`` their sum. Every
    device holds the same amount (the specs divide evenly), so device 0's
    blocks are counted."""
    names = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "tokens", "cache", "pos")}[c.cell.kind]
    parts = {n: _tree_bytes(a, s, c.mesh)
             for n, a, s in zip(names, c.abstract, c.specs) if n != "pos"}
    return dict(parts, argument_size_in_bytes=sum(parts.values()))


# ------------------------------------------------------------------ FLOPs
def count_flops(c: Cell) -> float:
    """Global FLOPs of one run of the cell's step on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    model = c.model()
    args = c.step_args(model)
    with FlopCounterMode(display=False) as fc:
        c.fn(model, *args)
    return float(fc.get_total_flops())


# ------------------------------------------------------------ collectives
# The dry run's one seam with torch's internals. torch moves them between
# releases (the build box runs 2.13, the card's machine 2.11), so each
# is named here; ``seam_missing`` lists those this torch lacks, and
# ``dtensor_seam`` refuses to start without them.
SEAM_INTERNALS = (
    # the fake process group's store: collectives recorded, never sent
    "torch.testing._internal.distributed.fake_pg.FakeStore",
    # DTensor's shard-to-shard move, swapped for the all-to-all op
    "torch.distributed.tensor._collective_utils.shard_dim_alltoall",
    "torch.ops._dtensor.shard_dim_alltoall",
    "torch.distributed._functional_collectives._resolve_group_name",
    # a collective's group, for its size in the ring model
    "torch.distributed.distributed_c10d._resolve_process_group",
    # Replicate → Partial(sum), kept exact for integer tensors
    "torch.distributed.tensor.placement_types.Partial._partition_value",
)
# DTensor's errors for a view it will not run on a split dimension, from
# which the uneven-view fix reads the mesh dimension to replicate: torch
# 2.13 names it (the split does not unflatten evenly), torch 2.11 names
# the tensor dimension (it splits or flattens no sharded dimension in a
# view)
UNEVEN_VIEW_ERROR = r"evenly divisible by mesh dimension (\d+)"
SHARDED_VIEW_ERROR = r"sharded dimension (\d+)|dimension (\d+) being sharded"


def seam_missing() -> list[str]:
    """The names of ``SEAM_INTERNALS`` this torch does not have."""
    import importlib
    missing = []
    for path in SEAM_INTERNALS:
        parts = path.split(".")
        for i in range(len(parts), 0, -1):     # the longest module prefix
            try:
                obj = importlib.import_module(".".join(parts[:i]))
                break
            except ImportError:
                continue
        try:
            for name in parts[i:]:
                obj = getattr(obj, name)
        except AttributeError:
            missing.append(path)
    return missing


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks (this process is rank 0):
    collectives are recorded by the modes that watch them and never
    sent. Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry run needs one of its own")
    dist.init_process_group("fake", rank=0, world_size=n_ranks,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def dtensor_seam(n_ranks: int):
    """Everything the dry run changes in torch to count a DTensor step,
    in one block: a fake process group of ``n_ranks`` ranks
    (:func:`fake_world`), inside which it yields ``step(counter)``, a
    context manager for the step itself. ``step`` enters, in this
    order (the first outermost, so ``counter`` also sees the
    collectives the others issue):

    * ``counter``, a ``CommDebugMode`` (:func:`_collective_counter`);
    * the uneven-view fix (:func:`_uneven_view_fix`; it reads
      ``UNEVEN_VIEW_ERROR`` or ``SHARDED_VIEW_ERROR``);
    * the local ops (:func:`_local_ops`: ``gather`` and
      ``log_sigmoid_backward`` shard by shard where DTensor has no
      strategy for them);
    * ``implicit_replication`` (a plain tensor counts as replicated);
    * the all-to-all swap (:func:`_alltoall_on_cpu_mesh`);
    * exact integer partials (:func:`_exact_integer_partial`).

    Nothing is registered with DTensor: the modes end with the block,
    and each patched attribute is put back as it was, so DTensor
    behaves afterwards exactly as before. Raises ``RuntimeError``
    naming the internals of ``SEAM_INTERNALS`` this torch lacks."""
    missing = seam_missing()
    if missing:
        raise RuntimeError(
            f"torch {torch.__version__} lacks internals the dry run's "
            f"DTensor seam uses (launch/dryrun.py, SEAM_INTERNALS): "
            + ", ".join(missing))
    from torch.distributed.tensor.experimental import implicit_replication

    @contextlib.contextmanager
    def step(counter):
        with counter, _uneven_view_fix(), _local_ops(), \
                implicit_replication(), _alltoall_on_cpu_mesh(), \
                _exact_integer_partial():
            yield
    with fake_world(n_ranks):
        yield step


def _collective_counter():
    """A ``CommDebugMode`` that also keeps, for each functional
    collective, its op, its output's bytes and its group's size."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveCounter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records: list[tuple[str, int, int]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            op = _COLLECTIVE_OPS.get(getattr(func, "_overloadpacket",
                                             func).__name__)
            if op is not None and out is not NotImplemented:
                group = (kwargs or {}).get("group_name", args[-1])
                n = _resolve_process_group(group).size()
                self.records.append((op, out.numel() * out.element_size(),
                                     n))
            return out
    return CollectiveCounter()


def view_error_mesh_dim(text: str, placements) -> int | None:
    """The mesh dimension a view's DTensor error asks to replicate (the
    last one that splits the named tensor dimension, where the error
    names a tensor dimension), or None where the text is neither of
    ``UNEVEN_VIEW_ERROR`` and ``SHARDED_VIEW_ERROR``."""
    import re
    m = re.search(UNEVEN_VIEW_ERROR, text)
    if m is not None:
        return int(m.group(1))
    m = re.search(SHARDED_VIEW_ERROR, text)
    if m is None:
        return None
    d = int(next(g for g in m.groups() if g is not None))
    dims = [i for i, p in enumerate(placements)
            if getattr(p, "dim", None) == d]
    return dims[-1] if dims else None


def _uneven_view_fix():
    """A dispatch mode that lets a view run where DTensor's strategy has
    left it impossible: DTensor may split a flattened dimension (a
    projection's heads × head_dim, local-chunked from a replicated
    weight because chunking costs nothing) that then does not unflatten
    evenly (fewer KV heads than the model axis). The view's input is
    then replicated on that mesh dimension first — an all-gather, which
    the count includes, as the DTensor run issues it. (torch 2.11 runs no
    view that splits or flattens a sharded dimension; the same fix
    replicates it first there.)"""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode
    views = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)

    class UnevenViewFix(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in views or not isinstance(args[0], DTensor):
                return func(*args, **kwargs)
            x = args[0]
            while True:
                try:
                    return func(x, *args[1:], **kwargs)
                except RuntimeError as e:
                    placements = list(x.placements)
                    dim = view_error_mesh_dim(str(e), placements)
                    if dim is None or isinstance(placements[dim],
                                                 Replicate):
                        raise
                    placements[dim] = Replicate()
                    x = x.redistribute(x.device_mesh, placements)
    return UnevenViewFix()


def _local_ops():
    """A dispatch mode that runs two ops shard by shard (a ``local_map``
    with the inputs' own placements) where DTensor has no strategy:

    * ``aten.gather`` whose input and index are laid out alike and not
      split on the gathered dimension: the loss's label gather under
      ``ffn_mode="dp"``, whose logits' rows DTensor splits as a
      ``_StridedShard`` (its own rule has no such case, and pricing its
      mask-partial case raises). No collective, as a gather row by row
      needs none.
    * ``aten.log_sigmoid_backward`` (the gradient of xlstm's
      ``F.logsigmoid`` gates; DTensor registers no rule): pointwise, so
      the gradient (and the buffer, where it is not empty) first moves
      to ``self``'s placements — a collective DTensor would issue as
      well, which the count includes.

    Every other call goes on to DTensor."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    def plain(placements) -> bool:
        """Each mesh dimension replicates or splits one tensor dim."""
        return all(p.is_replicate() or hasattr(p, "dim")
                   for p in placements)

    def wrap(out, like: DTensor, shape):
        return DTensor.from_local(
            out, like.device_mesh, like.placements, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    class LocalOps(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is aten.gather.default:
                x, dim, index = args[:3]
                if (isinstance(x, DTensor) and isinstance(index, DTensor)
                        and x.placements == index.placements
                        and plain(x.placements)
                        and all(getattr(p, "dim", None) != dim % x.ndim
                                for p in x.placements)):
                    out = func(x.to_local(), dim, index.to_local(),
                               *args[3:], **kwargs)
                    return wrap(out, index, index.shape)
            if func is aten.log_sigmoid_backward.default:
                grad, x, buf = args
                if (isinstance(x, DTensor) and isinstance(grad, DTensor)
                        and isinstance(buf, DTensor)
                        and plain(x.placements)):
                    mesh, pl = x.device_mesh, x.placements
                    buf = (buf.redistribute(mesh, pl)
                           if buf.shape == x.shape else buf)
                    out = func(grad.redistribute(mesh, pl).to_local(),
                               x.to_local(), buf.to_local())
                    return wrap(out, x, x.shape)
            return func(*args, **kwargs)
    return LocalOps()


@contextlib.contextmanager
def _alltoall_on_cpu_mesh():
    """On a CPU device mesh DTensor sends a shard-to-shard
    redistribution as an all-gather and a chunk (gloo has no
    all-to-all). The dry run's mesh stands for CUDA devices, so inside
    this block it issues the all-to-all op, as on a CUDA mesh (its meta
    kernel runs on the meta tensors)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))
    saved = [(m, m.shard_dim_alltoall)
             for m in (_collective_utils, placement_types)
             if hasattr(m, "shard_dim_alltoall")]
    for m, _ in saved:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, fn in saved:
            m.shard_dim_alltoall = fn


@contextlib.contextmanager
def _exact_integer_partial():
    """DTensor turns a replicated tensor into a ``Partial(sum)`` one by
    dividing it by the mesh dimension's size, which makes an integer
    tensor float: in the MoE decode, ``counts + mask_k.sum(-2)`` of
    ``models/moe.py::_positions_in_expert`` comes out float, and the
    ``F.one_hot`` that reads the positions refuses it. Inside this
    block an integer tensor is split as its value on the mesh
    dimension's first coordinate and zeros on the others: the same sum,
    exact, in its own dtype. Neither form sends a collective."""
    from torch.distributed.tensor.placement_types import Partial
    own = "_partition_value" in vars(Partial)
    partition = Partial._partition_value

    def exact(self, tensor, mesh, mesh_dim):
        if (self.reduce_op != "sum" or tensor.is_floating_point()
                or tensor.is_complex() or tensor.dtype == torch.bool):
            return partition(self, tensor, mesh, mesh_dim)
        return tensor if mesh.get_local_rank(mesh_dim) == 0 \
            else torch.zeros_like(tensor)
    Partial._partition_value = exact
    try:
        yield
    finally:
        if own:
            Partial._partition_value = partition
        else:
            del Partial._partition_value


def count_collectives(c: Cell) -> dict:
    """The collectives of one run of the cell's step on DTensors over a
    fake process group of the mesh's size, priced by the ring model:
    {"bytes_per_device", "per_op_bytes", "counts"} (the reference's
    ``parse_collectives`` keys) and ``comm_counts``, CommDebugMode's
    count by functional op."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = c.mesh
    with dtensor_seam(count_devices(mesh)) as step:
        device_mesh = init_device_mesh("cpu", tuple(mesh.sizes),
                                       mesh_dim_names=mesh.axis_names)
        model = c.model(device_mesh)
        args = c.step_args(model, device_mesh)
        counter = _collective_counter()
        with step(counter):
            c.fn(model, *args)
    per_op: dict = {}
    counts: dict = {}
    total = 0.0
    for op, out_bytes, n in counter.records:
        moved = rf._ring_bytes(op, out_bytes, n)
        total += moved
        counts[op] = counts.get(op, 0) + 1
        per_op[op] = per_op.get(op, 0.0) + moved
    return {"bytes_per_device": total, "per_op_bytes": per_op,
            "counts": counts,
            "comm_counts": {str(k): v for k, v in
                            counter.get_comm_counts().items()}}


def _cause(e: BaseException) -> str:
    """The failing op's line of an exception, for a null term."""
    text = str(e).strip().splitlines()
    for line in text:
        if "propagation failed for" in line or "aten." in line:
            return line.strip()[:400]
    return (f"{type(e).__name__}: {text[0] if text else ''}")[:400]


# ------------------------------------------------------------------- cells
def measure_cell(cfg, cell: ShapeCell, mesh: ShardMesh, opt: AdamWConfig,
                 seq_shard: bool = False, collectives: bool = True,
                 **pol) -> dict:
    """One cell's terms and each pass's seconds: ``memory`` (argument
    bytes), ``flops`` (counted, or None with ``flops_error``),
    ``collectives`` (or None with ``collectives_error``; skipped with
    ``collectives=False``)."""
    seconds = {}
    t = time.perf_counter()
    c = build_cell(cfg, cell, mesh, opt, seq_shard=seq_shard, **pol)
    mem = argument_bytes(c)
    seconds["memory"] = time.perf_counter() - t
    out = {"memory_analysis": mem, "seconds": seconds}
    t = time.perf_counter()
    try:
        out["flops_counted"] = count_flops(c)
    except Exception as e:                  # the cause goes in the record
        out["flops_counted"], out["flops_error"] = None, _cause(e)
    seconds["flops"] = time.perf_counter() - t
    if collectives:
        t = time.perf_counter()
        try:
            out["collectives"] = count_collectives(c)
        except Exception as e:              # the cause goes in the record
            out["collectives"], out["collectives_error"] = None, _cause(e)
        seconds["collectives"] = time.perf_counter() - t
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             seq_shard: bool = False, verbose: bool = True,
             ffn_mode: str = "tp", attn_override: str | None = None,
             serve_fsdp: bool = True, moe_dispatch: str | None = None,
             bf16_flows: bool = False, kv_int8: bool = False) -> dict:
    cfg = get_config(arch)
    if moe_dispatch:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    pol = dict(ffn_mode=ffn_mode, attn_override=attn_override,
               serve_fsdp=serve_fsdp, bf16_flows=bf16_flows)
    ok, reason = supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = count_devices(mesh)
    cell = SHAPES[shape_name]
    opt = opt_for(cfg)

    t0 = time.time()
    m = measure_cell(cfg, cell, mesh, opt, seq_shard=seq_shard, **pol)
    analytic = rf.analytic_flops(cfg, cell)
    counted = m["flops_counted"]
    flops_dev = analytic / n_dev if counted is None \
        else max(counted / n_dev, analytic / n_dev)
    bytes_dev = rf.analytic_bytes(cfg, cell, n_dev, opt.moment_dtype,
                                  ffn_mode=ffn_mode)
    coll = m.get("collectives")
    coll_bytes = None if coll is None else coll["bytes_per_device"]
    roof = rf.roofline(flops_dev, bytes_dev, coll_bytes, coll or {}, cfg,
                       cell, n_dev)
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "devices": n_dev,
        "wall_s": round(time.time() - t0, 1),
        "seconds": m["seconds"],
        "memory_analysis": m["memory_analysis"],
        "raw_flops_per_device": None if counted is None
        else counted / n_dev,
        "extrapolated": {"flops": None if counted is None
                         else counted / n_dev,
                         "bytes": bytes_dev, "coll_bytes": coll_bytes},
        "analytic_flops_global": analytic,
        "collectives": coll,
        "roofline": roof,
        "seq_shard": seq_shard,
        "policy": {**pol, "moe_dispatch": cfg.moe_dispatch,
                   "kv_cache_dtype": cfg.kv_cache_dtype,
                   "moment_dtype": opt.moment_dtype},
    }
    for key in ("flops_error", "collectives_error"):
        if key in m:
            res[key] = m[key]
    if verbose:
        ppd = m["memory_analysis"]["argument_size_in_bytes"] / 2 ** 30
        coll_s = roof["collective_s"]
        print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: OK "
              f"({n_dev} dev, args {ppd:.2f} GiB/dev, "
              f"compute {roof['compute_s']:.3e}s, "
              f"mem {roof['memory_s']:.3e}s, coll "
              + ("null" if coll_s is None else f"{coll_s:.3e}s")
              + f" → {roof['dominant']}, "
              f"roofline {roof['roofline_fraction'] * 100:.1f}%, "
              f"wall {res['wall_s']:.0f}s)", flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"],
                    choices=["single", "multi"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-shard prefill activations (perf knob)")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--tag", default="",
                    help="suffix for result files (perf experiments)")
    ap.add_argument("--ffn-mode", default="tp",
                    choices=["tp", "dp", "dp_batch"])
    ap.add_argument("--attn-strategy", default=None,
                    choices=[None, "heads", "batch", "seq", "kv_seq"])
    ap.add_argument("--no-serve-fsdp", action="store_true")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "einsum", "gather"])
    ap.add_argument("--bf16-flows", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    args = ap.parse_args()

    archs = list_archs() if args.arch == ["all"] else args.arch
    shapes = list(SHAPES) if args.shape == ["all"] else args.shape
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in args.mesh:
                tag = f"_{args.tag}" if args.tag else ""
                path = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh_kind}{tag}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] {arch} × {shape} × {mesh_kind}: cached")
                    continue
                try:
                    res = run_cell(arch, shape, mesh_kind,
                                   seq_shard=args.seq_shard,
                                   ffn_mode=args.ffn_mode,
                                   attn_override=args.attn_strategy,
                                   serve_fsdp=not args.no_serve_fsdp,
                                   moe_dispatch=args.moe_dispatch,
                                   bf16_flows=args.bf16_flows,
                                   kv_int8=args.kv_int8)
                    if res["status"] == "ok":
                        n_ok += 1
                    else:
                        n_skip += 1
                        print(f"[dryrun] {arch} × {shape} × {mesh_kind}: "
                              f"SKIP ({res['reason']})")
                except Exception as e:           # a failed cell is a bug
                    n_fail += 1
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "failed", "error": str(e),
                           "traceback": traceback.format_exc()}
                    print(f"[dryrun] {arch} × {shape} × {mesh_kind}: "
                          f"FAILED — {e}")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
