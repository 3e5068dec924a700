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
  model; a redistribution of known size is priced exactly.
* ``reanalyze`` recomputes a stored record's roofline to the value it
  had; the command line writes a skipped record for an unsupported cell.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch import dryrun, reanalyze, roofline
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import local_shard
from repro_torch.models import convert
from repro_torch.models.model import init_params
from repro_torch.optim import AdamWConfig, adamw_init

ONE = ShardMesh(("data", "model"), (1, 1))
FOUR_TWO = ShardMesh(("data", "model"), (4, 2))
TWO_FOUR = ShardMesh(("data", "model"), (2, 4))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's CPU ops on one thread (many small ops; beside the suite's
    other workers intra-op threads oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("kind,knob,untraced", [
    ("prefill", dict(seq_shard=True), None),
    ("train", dict(ffn_mode="dp"), "aten.gather"),
    ("train", dict(ffn_mode="dp_batch"), None),
    ("train", dict(attn_override="batch"), None),
    ("decode", dict(serve_fsdp=False), None),
    ("train", dict(bf16_flows=True), None)],
    ids=["seq_shard", "dp", "dp_batch", "attn_batch", "no_serve_fsdp",
         "bf16_flows"])
def test_policy_knobs_run_through_the_dry_run(kind, knob, untraced):
    """Each knob's cell is counted; under ``ffn_mode="dp"`` the loss's
    gather meets logits whose sequence is split over the model axis,
    which DTensor has no rule for: the record names the op."""
    cfg = get_smoke_config("granite-3-2b")
    m = dryrun.measure_cell(cfg, tspecs.ShapeCell("smoke", 16, 8, kind),
                            FOUR_TWO, dryrun.opt_for(cfg), **knob)
    assert m["flops_counted"] > 0
    if untraced is None:
        assert m["collectives"] is not None, m.get("collectives_error")
    else:
        assert m["collectives"] is None
        assert untraced in m["collectives_error"]


def test_collective_pricing_of_a_known_redistribution():
    """One all-gather of a (64, 64) f32 tensor split 4 ways on the data
    axis: 16 KiB out, 3/4 of it over the links."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(64, 64, device="meta"), mesh,
                              [Shard(0), Replicate()])
        counter = dryrun._collective_counter()
        with counter, dryrun._alltoall_on_cpu_mesh():
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
