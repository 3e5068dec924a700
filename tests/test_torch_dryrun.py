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
* ``reanalyze`` recomputes a stored record's roofline to the value it
  had; the command line writes a skipped record for an unsupported cell.
"""
import dataclasses
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
