"""The port's dry run (launch/dryrun.py, launch/specs.py,
launch/reanalyze.py) at smoke size.

* The argument bytes a cell counts from its spec trees equal the bytes of
  the state the trainer builds (parameters, AdamW's f32 or int8 moments,
  the batch) on a 1 × 1 mesh, and a device's share of them on a 4 × 2
  mesh.
* The FLOPs counted on the meta device equal the FLOPs of the same step
  run on CPU tensors.
* A smoke cell's step on DTensors over a fake 8-rank process group
  issues collectives, counted by CommDebugMode and priced by the ring
  model; a redistribution of known size is priced exactly. So do the
  three steps DTensor cannot run unaided (the MoE decode at the
  production routing, xlstm's train step, ``ffn_mode="dp"``), through
  the dry run's seam (``dryrun.dtensor_seam``), which names every torch
  internal it uses and leaves DTensor as it found it.
* Where DTensor itself raises on ``flip``, ``index_put`` or ``index``
  (torch 2.11 does, in every train cell; here its refusal is put in by
  hand), the seam's fallback gives the plain op's values and issues the
  collectives DTensor 2.13 issues for the same call (as many, of one
  other kind, at one layout).
* ``reanalyze`` recomputes a stored record's roofline to the value it
  had; the command line writes a skipped record for an unsupported cell.
"""
import contextlib
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch import dryrun, reanalyze, roofline
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import local_shard
from repro_torch.models import convert
from repro_torch.models.model import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from torch_threads import one_thread  # noqa: F401

ONE = ShardMesh(("data", "model"), (1, 1))
FOUR_TWO = ShardMesh(("data", "model"), (4, 2))
TWO_FOUR = ShardMesh(("data", "model"), (2, 4))


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_argument_bytes_equal_the_trainers_state(moment_dtype):
    cfg = get_smoke_config("granite-3-2b")
    B, S = 4, 32
    opt = AdamWConfig(moment_dtype=moment_dtype)
    cell = tspecs.ShapeCell("smoke", S, B, "train")
    mem = dryrun.argument_bytes(tspecs.build_cell(cfg, cell, ONE, opt))
    model = init_params(cfg, 0, device="cpu")
    params = dict(model.named_parameters())
    state = adamw_init(params, opt)
    batch = {k: torch.as_tensor(v).long() for k, v in SyntheticLMData(
        vocab=cfg.vocab, batch=B, seq=S).batch_at(0).items()}
    assert mem["params"] == nbytes(params)
    assert mem["opt_state"] == nbytes(state)
    assert mem["batch"] == nbytes(batch)
    assert mem["argument_size_in_bytes"] == \
        nbytes(params) + nbytes(state) + nbytes(batch)

    # on 4 × 2 every device holds its blocks of the stacked tree
    c = tspecs.build_cell(cfg, cell, FOUR_TWO, opt)
    tree = convert.to_jax_params(cfg, model)
    specs = c.specs[0]

    def blocks(t, s):
        if isinstance(t, dict):
            return sum(blocks(t[k], s[k]) for k in t)
        x = torch.as_tensor(np.asarray(t))
        return nbytes(local_shard(x, s, FOUR_TWO, {"data": 3, "model": 1}))
    assert dryrun.argument_bytes(c)["params"] == blocks(tree, specs)
    assert dryrun.argument_bytes(c)["params"] < nbytes(params)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_flops_equal_a_cpu_run(kind):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_smoke_config("granite-3-2b")
    cell = tspecs.ShapeCell("smoke", 16, 2, kind)
    c = tspecs.build_cell(cfg, cell, FOUR_TWO, dryrun.opt_for(cfg))
    counted = dryrun.count_flops(c)
    # the same step on CPU tensors of the same shapes
    model = init_params(cfg, 0, device="cpu").to(c.param_dtype)
    args = c.step_args(model)

    def real(x):
        if isinstance(x, dict):
            return {k: real(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(real(v) for v in x)
        if isinstance(x, torch.Tensor):
            return torch.zeros(x.shape, dtype=x.dtype)
        return x
    args = real(args)
    with FlopCounterMode(display=False) as fc:
        c.fn(model, *args)
    assert counted == fc.get_total_flops() > 0


@pytest.mark.parametrize("mesh", [FOUR_TWO, TWO_FOUR], ids=["4x2", "2x4"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_smoke_cell_on_a_fake_eight_rank_group(kind, mesh):
    """On 2 × 4 the smoke config's 2 KV heads are fewer than the model
    axis: the K/V projections' views go through the dry run's uneven-view
    fix (and the train step through the repeated heads)."""
    cfg = get_smoke_config("granite-3-2b")
    m = dryrun.measure_cell(cfg, tspecs.ShapeCell("smoke", 16, 8, kind),
                            mesh, dryrun.opt_for(cfg))
    coll = m["collectives"]
    assert coll is not None, m.get("collectives_error")
    assert m["flops_counted"] > 0
    assert coll["bytes_per_device"] > 0
    assert sum(coll["counts"].values()) == \
        sum(coll["comm_counts"].values())
    assert set(coll["counts"]) <= set(roofline.COLLECTIVES)
    assert coll["bytes_per_device"] == pytest.approx(
        sum(coll["per_op_bytes"].values()), rel=1e-12)
    assert set(m["seconds"]) == {"memory", "flops", "collectives"}


def moe_routing_cfg():
    """granite-moe's smoke widths with its production routing (top 8 of
    40 experts, capacity 1.25): from the third choice on, the expert
    counts of ``moe._positions_in_expert`` add a replicated and a
    partial integer tensor, which DTensor alone makes float (the
    production MoE decode's null term before the seam)."""
    full = get_config("granite-moe-3b-a800m")
    return dataclasses.replace(
        get_smoke_config("granite-moe-3b-a800m"),
        moe_experts=full.moe_experts, moe_topk=full.moe_topk,
        capacity_factor=full.capacity_factor)


@pytest.mark.parametrize("arch,kind", [("granite-moe-3b-a800m", "decode"),
                                       ("xlstm-350m", "train")],
                         ids=["moe_decode", "xlstm_train"])
def test_steps_dtensor_cannot_run_alone_are_counted(arch, kind):
    """The MoE decode (the seam's exact integer partials) and xlstm's
    train step (its local ``log_sigmoid_backward``; one super-block of an
    mLSTM and an sLSTM layer, ``slstm_every=2``: both mixers at a
    quarter of the smoke super-block's eight layers) have a collective
    term, CommDebugMode's count equal to the ring model's."""
    cfg = moe_routing_cfg() if kind == "decode" else \
        dataclasses.replace(get_smoke_config(arch), n_layers=2,
                            slstm_every=2)
    m = dryrun.measure_cell(cfg, tspecs.ShapeCell("smoke", 16, 8, kind),
                            FOUR_TWO, dryrun.opt_for(cfg))
    coll = m["collectives"]
    assert coll is not None, m.get("collectives_error")
    assert coll["bytes_per_device"] > 0
    assert sum(coll["counts"].values()) == \
        sum(coll["comm_counts"].values())
    assert coll["bytes_per_device"] == pytest.approx(
        sum(coll["per_op_bytes"].values()), rel=1e-12)


def test_seam_names_the_torch_internals_it_uses(monkeypatch):
    """Fails, naming them, where this torch has moved an internal of the
    dry run's seam, or reworded the view errors it reads."""
    missing = dryrun.seam_missing()
    assert not missing, (
        f"torch {torch.__version__} moved internals the dry run uses "
        f"(launch/dryrun.py, SEAM_INTERNALS): {missing}")
    with dryrun.dtensor_seam(8) as step:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(2, 8, device="meta"), mesh,
                              [Replicate(), Shard(1)])
        with pytest.raises(RuntimeError) as err:
            x.view(2, 2, 4)
        assert dryrun.view_error_mesh_dim(str(err.value),
                                          x.placements) == 1, (
            "DTensor's error for a view of a split dimension matches "
            "neither dryrun.UNEVEN_VIEW_ERROR nor SHARDED_VIEW_ERROR: "
            f"{err.value}")
        counter = dryrun._collective_counter()
        with step(counter):
            y = x.view(2, 2, 4)              # replicated first
        assert tuple(y.placements) == (Replicate(), Replicate())
        assert [r[0] for r in counter.records] == ["all-gather"]
    monkeypatch.setattr(dryrun, "SEAM_INTERNALS", dryrun.SEAM_INTERNALS
                        + ("torch.distributed.tensor.no_such_internal",))
    with pytest.raises(RuntimeError, match="no_such_internal"):
        with dryrun.dtensor_seam(8):
            pass


def expert_counts_one_hot():
    """``F.one_hot`` of the MoE's expert-count pattern on DTensors (a
    replicated integer tensor plus a partial one): the output's dtype, or
    the error."""
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    mask = DTensor.from_local(
        torch.zeros(1, 2, 8, dtype=torch.long, device="meta"), mesh,
        [Shard(1), Replicate()], run_check=False)
    counts = 0 + mask.sum(-2)
    counts = counts + mask.sum(-2)
    try:
        return str(F.one_hot(counts, 8).dtype)
    except RuntimeError as e:
        return str(e)


def test_the_dry_run_leaves_dtensor_as_it_found_it():
    """After a dry run, ``F.one_hot`` on DTensors behaves exactly as
    before it, whatever DTensor alone does with the counts (torch 2.13
    makes them float and refuses them), and nothing of the seam is left
    in place: ``Partial``'s partition, DTensor's strategies for the ops
    the seam runs, the dispatch modes."""
    from torch.distributed.tensor.placement_types import Partial
    prop = DTensor._op_dispatcher.sharding_propagator
    ops = (torch.ops.aten.gather.default,
           torch.ops.aten.log_sigmoid_backward.default,
           torch.ops.aten.one_hot.default)
    strategies = {op: prop.op_strategy_funcs.get(op) for op in ops}
    partition = Partial._partition_value
    with dryrun.fake_world(8):
        before = expert_counts_one_hot()
    m = dryrun.measure_cell(moe_routing_cfg(),
                            tspecs.ShapeCell("smoke", 16, 8, "decode"),
                            FOUR_TWO, dryrun.opt_for(moe_routing_cfg()))
    assert m["collectives"] is not None, m.get("collectives_error")
    with dryrun.fake_world(8):
        after = expert_counts_one_hot()
    assert after == before
    with dryrun.dtensor_seam(8) as step:
        with step(dryrun._collective_counter()):
            assert expert_counts_one_hot() == "torch.int64"
    assert Partial._partition_value is partition
    assert {op: prop.op_strategy_funcs.get(op) for op in ops} == strategies
    assert torch._C._len_torch_dispatch_stack() == 0


@pytest.mark.parametrize("kind,knob", [
    ("prefill", dict(seq_shard=True)),
    ("train", dict(ffn_mode="dp")),
    ("train", dict(ffn_mode="dp_batch")),
    ("train", dict(attn_override="batch")),
    ("decode", dict(serve_fsdp=False)),
    ("train", dict(bf16_flows=True))],
    ids=["seq_shard", "dp", "dp_batch", "attn_batch", "no_serve_fsdp",
         "bf16_flows"])
def test_policy_knobs_run_through_the_dry_run(kind, knob):
    """Each knob's cell is counted. Under ``ffn_mode="dp"`` the loss's
    gather meets logits whose rows DTensor splits as a ``_StridedShard``
    over the model axis, which its gather rule has no case for: the
    seam's local gather runs it row block by row block (no collective)."""
    cfg = get_smoke_config("granite-3-2b")
    m = dryrun.measure_cell(cfg, tspecs.ShapeCell("smoke", 16, 8, kind),
                            FOUR_TWO, dryrun.opt_for(cfg), **knob)
    assert m["flops_counted"] > 0
    coll = m["collectives"]
    assert coll is not None, m.get("collectives_error")
    assert sum(coll["counts"].values()) == \
        sum(coll["comm_counts"].values()) > 0


def test_collective_pricing_of_a_known_redistribution():
    """One all-gather of a (64, 64) f32 tensor split 4 ways on the data
    axis: 16 KiB out, 3/4 of it over the links."""
    with dryrun.dtensor_seam(8) as step:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(64, 64, device="meta"), mesh,
                              [Shard(0), Replicate()])
        counter = dryrun._collective_counter()
        with step(counter):
            x.redistribute(mesh, [Replicate(), Replicate()])
            x.redistribute(mesh, [Shard(1), Replicate()])
    assert counter.records == [("all-gather", 64 * 64 * 4, 4),
                               ("all-to-all", 64 * 16 * 4, 4)]
    assert roofline._ring_bytes("all-gather", 64 * 64 * 4, 4) == 12288.0


# ----------------------------------------- the ops torch 2.11 refuses
R, S = Replicate(), Shard
# shapes no other test here uses: DTensor caches a sharding decision per
# op and input layout, and a cached one would not ask the refusal below
TABLE, IDX = (96, 24), (8, 6)


@contextlib.contextmanager
def dtensor_refuses(op, refuse=lambda schema: True):
    """DTensor's sharding propagation raising on ``op`` where
    ``refuse(schema)`` holds, as torch 2.11's does on the dry run's
    train steps (no ``flip`` rule, an unnormalized ``index_put`` split,
    no index split twice on one dimension)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    names = ("propagate_op_sharding", "propagate_op_sharding_non_cached")
    own = {n: getattr(prop, n) for n in names}
    held = {n: n in vars(prop) for n in names}      # set on the instance

    def refusing(name):
        def propagate(schema):
            if schema.op is op and refuse(schema):
                refused.append(op)
                raise RuntimeError(f"no sharding for {op} (torch 2.11)")
            return own[name](schema)
        return propagate
    refused = []
    for n in names:
        setattr(prop, n, refusing(n))
    try:
        yield refused
    finally:
        for n in names:
            if held[n]:
                setattr(prop, n, own[n])
            else:
                delattr(prop, n)


def seam_call(mesh_shape, fn, args, refuse=None):
    """``fn(*args)`` on meta DTensors (``args``: (shape, dtype,
    placements)) through the seam on a fake 8-rank group, with DTensor
    refusing ``refuse`` (an op, or (op, predicate)); the output's
    placements and the collectives recorded."""
    with dryrun.dtensor_seam(8) as step:
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        ts = [distribute_tensor(torch.zeros(shape, dtype=dt,
                                            device="meta"), mesh, pl)
              for shape, dt, pl in args]
        counter = dryrun._collective_counter()
        refusing = contextlib.nullcontext() if refuse is None else \
            dtensor_refuses(*(refuse if isinstance(refuse, tuple)
                              else (refuse,)))
        with step(counter), refusing as refused:
            out = fn(*ts)
    assert refuse is None or refused, "DTensor was not asked"
    return tuple(out.placements), counter.records


def blocks(t, mesh_shape, placements) -> dict:
    """Each mesh coordinate's block of ``t`` under ``placements``
    (replicated or evenly split dims, split in mesh-dim order)."""
    out = {}
    for coord in itertools.product(*map(range, mesh_shape)):
        b = t
        for m, p in enumerate(placements):
            if p.is_shard():
                b = b.chunk(mesh_shape[m], dim=p.dim)[coord[m]]
        out[coord] = b
    return out


def assemble(local: dict, mesh_shape, placements, shape):
    """The global tensor of ``local`` blocks; the coordinates that hold
    one block (a replicated mesh dim) must agree on it."""
    g = torch.full(shape, float("nan"), dtype=torch.float64)
    for coord, b in local.items():
        view = blocks(g, mesh_shape, placements)[coord]
        if view.isnan().any():
            view.copy_(b)
        else:
            assert torch.equal(view, b.double())
    return g


# DTensor 2.13's own output layout and collectives for each call below
AG = "all-gather"


@pytest.mark.parametrize("mesh_shape,placements,want", [
    ((4, 2), [S(0), S(1)], ((S(0), S(1)), [])),
    ((4, 2), [S(0), S(2)], ((S(0), R), [(AG, 192, 2)])),
    ((2, 4), [R, S(2)], ((R, R), [(AG, 1024, 4)]))],
    ids=["unsplit", "split_model", "split_2x4"])
def test_flip_where_dtensor_has_no_rule(mesh_shape, placements, want):
    """xlstm's ``flip`` (2.11 has no rule): a mesh dim that splits the
    flipped dim is gathered first, then each shard flips — DTensor
    2.13's layout and collectives, and the plain flip."""
    shape = (8, 4, 6)

    def flip(x):
        return torch.flip(x, [-1])
    got = seam_call(mesh_shape, flip, [(shape, torch.float32, placements)],
                    refuse=torch.ops.aten.flip.default)
    assert got == want
    x = torch.as_tensor(np.random.default_rng(0).normal(size=shape))
    local = {c: b.flip(-1) for c, b in blocks(x, mesh_shape,
                                              got[0]).items()}
    assert torch.equal(assemble(local, mesh_shape, got[0], shape),
                       x.flip(-1))


@pytest.mark.parametrize("mesh_shape,idx_pl,val_pl,want,exact", [
    ((4, 2), [S(0), R], [S(2), S(1)],
     ((S(1), R), [(AG, 384, 4), (AG, 1152, 2)]), True),
    ((2, 4), [S(0), R], [S(2), S(2)],
     ((S(1), S(1)), [(AG, 384, 2)]), True),
    ((4, 2), [S(0), S(0)], [S(2), R],
     ((S(1), R), [(AG, 96, 2), (AG, 384, 4)]), True),
    ((4, 2), [S(0), R], [S(0), R],
     ((R, S(1)), [(AG, 384, 4), (AG, 2304, 4)]), True),
    ((4, 2), [S(0), S(1)], [S(0), S(1)],
     ((R, R), [(AG, 96, 2), (AG, 384, 4), (AG, 1152, 2), (AG, 4608, 4)]),
     False)],
    ids=["2.13_4x2", "2.13_2x4", "2.13_dp_batch", "2.11_4x2", "2.11_dp"])
def test_embedding_backward_where_dtensor_refuses(mesh_shape, idx_pl,
                                                  val_pl, want, exact):
    """The embedding's backward, ``index_put(table, [ids], grads,
    accumulate=True)``, at the layouts the train steps give it under
    2.13 and 2.11. The seam replicates the ids and keeps or gathers
    the gradients' splits (``_index_put_placements``): at every layout
    but 2.11's dp one that is DTensor 2.13's own choice, output layout
    and collectives alike. At the dp one (gradients split on both index
    dims) 2.13 prices its options by size and gathers the gradients
    whole here; the seam gathers the data split and moves the model one
    to the gradients' width (an all-to-all): as many collectives, one
    of another kind. Shard by shard it is the plain op."""
    put = torch.ops.aten.index_put.default
    vshape = IDX + TABLE[1:]
    args = [(TABLE, torch.float32, [R, R]), (IDX, torch.int64, idx_pl),
            (vshape, torch.float32, val_pl)]

    def fn(x, i, v):
        return put(x, [i], v, True)
    got = seam_call(mesh_shape, fn, args, refuse=put)
    if exact:
        assert got == want
    else:
        assert len(got[1]) == len(want[1])
    x_pl, v_pl = dryrun._index_put_placements(TABLE, [torch.empty(IDX)],
                                              vshape, val_pl)
    assert tuple(x_pl) == got[0]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(-4, 4, TABLE).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, TABLE[0] // 8, IDX))   # repeats
    v = torch.as_tensor(rng.integers(-4, 4, vshape).astype(np.float32))
    vb = blocks(v, mesh_shape, v_pl)
    local = {c: put(b, [ids], vb[c], True)
             for c, b in blocks(x, mesh_shape, x_pl).items()}
    assert torch.equal(assemble(local, mesh_shape, x_pl, TABLE),
                       put(x, [ids], v, True).double())


def test_index_split_twice_where_dtensor_refuses():
    """The embedding's lookup under ``dp_batch``, ids split on dim 0 by
    both mesh dims (2.11 refuses it): the seam gathers the second split
    (one all-gather) and hands the call back to DTensor."""
    index = torch.ops.aten.index.Tensor

    def twice(schema):
        (ids,) = schema.args_schema[1]
        dims = [p.dim for p in ids.placements if p.is_shard()]
        return len(set(dims)) < len(dims)

    def fn(w, i):
        return index(w, [i])
    args = [(TABLE, torch.float32, [S(1), R]),
            ((8, 4), torch.int64, [S(0), S(0)])]
    got = seam_call((4, 2), fn, args, refuse=(index, twice))
    moved = seam_call((4, 2), fn, [args[0], ((8, 4), torch.int64,
                                             [S(0), R])])
    assert got[1] == [("all-gather", 8 * 4 * 8 // 4, 2)] + moved[1]
    assert got[0] == moved[0]


def test_reanalyze_round_trip(tmp_path, monkeypatch):
    """A production record (its collectives stubbed: this test is of the
    stored form) has its roofline rebuilt to the same values."""
    stub = {"bytes_per_device": 3.0e9, "per_op_bytes": {"all-reduce": 3e9},
            "counts": {"all-reduce": 7}, "comm_counts": {}}
    monkeypatch.setattr(dryrun, "count_collectives", lambda c: stub)
    rec = dryrun.run_cell("granite-3-2b", "decode_32k", "single",
                          verbose=False)
    assert rec["status"] == "ok" and rec["collectives"] == stub
    path = tmp_path / "granite-3-2b__decode_32k__single.json"
    path.write_text(json.dumps(rec))
    before = json.loads(path.read_text())
    doc = json.loads(path.read_text())
    doc["roofline"] = {}
    path.write_text(json.dumps(doc))
    assert reanalyze.reanalyze_file(str(path))
    after = json.loads(path.read_text())
    assert after["roofline"] == before["roofline"]
    assert after["roofline"]["collective_s"] == 3.0e9 / 50e9
    skipped = tmp_path / "skipped.json"
    skipped.write_text(json.dumps({"status": "skipped"}))
    assert not reanalyze.reanalyze_file(str(skipped))


def test_command_line_skips_an_unsupported_cell(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "granite-3-2b", "--shape", "long_500k",
        "--mesh", "single", "multi", "--out", str(tmp_path)])
    dryrun.main()
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"granite-3-2b__long_500k__{mesh}.json")
                         .read_text())
        assert rec["status"] == "skipped" and "sub-quadratic" in \
            rec["reason"]
    assert "0 ok, 2 skipped, 0 FAILED" in capsys.readouterr().out
