"""The port's MeshShardPolicy (launch/sharding.py) against the reference's,
spec for spec.

The reference's policy is built on ``jax.sharding.AbstractMesh``, which
holds no devices, so every spec can be held at the production sizes in
this one process: parameters, f32 and int8 moments, caches, batches and
each logical axis's activation spec, for all ten archs × {train,
prefill, decode} on the (4, 2), (2, 4), (8, 1), (16, 16) and (2, 16, 16)
meshes, each of the policy's knobs once, and ``plan_mesh``'s meshes.
The reference's ``PartitionSpec`` names a one-axis entry by the axis
alone; both are compared as tuples of axes (None unsplit).
"""
import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.ft import elastic as jelastic
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import schema as jschema
from repro.models.transformer import init_cache as jinit_cache
from repro_torch.configs import registry as treg
from repro_torch.ft import plan_mesh
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import ShardMesh, make_production_mesh
from repro_torch.models.schema import stacked_schema

MESHES = {(4, 2): ("data", "model"), (2, 4): ("data", "model"),
          (8, 1): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
MODES = ("train", "prefill", "decode")
CELL = {"train": "train_4k", "prefill": "prefill_32k",
        "decode": "decode_32k"}
KNOBS = (dict(seq_shard=True), dict(ffn_mode="dp"),
         dict(ffn_mode="dp_batch"), dict(attn_override="heads"),
         dict(attn_override="batch"), dict(attn_override="seq"),
         dict(serve_fsdp=False))


def norm(spec) -> tuple:
    """A reference spec as the port's tuple."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def norm_tree(tree):
    if isinstance(tree, dict):
        return {k: norm_tree(v) for k, v in tree.items()}
    return norm(getattr(tree, "spec", tree))


def policies(arch, shape, mode, **knobs):
    names = MESHES[shape]
    ref = jsharding.MeshShardPolicy.create(
        jreg.get_config(arch), AbstractMesh(shape, names), mode, **knobs)
    port = tsharding.MeshShardPolicy.create(
        treg.get_config(arch), ShardMesh(names, shape), mode, **knobs)
    return ref, port


def hold(arch, shape, mode, **knobs):
    """Every spec of the two policies for one arch × mesh × mode."""
    ref, port = policies(arch, shape, mode, **knobs)
    jcfg, tcfg = ref.cfg, port.cfg
    assert (port.attn_strategy, port.kv_repeat) == \
        (ref.attn_strategy, ref.kv_repeat)
    assert port.param_sharding_tree(stacked_schema(tcfg)) == \
        norm_tree(ref.param_sharding_tree(jschema.param_schema(jcfg)))
    for md in ("float32", "int8"):
        assert port.moment_sharding_tree(stacked_schema(tcfg), md) == \
            norm_tree(ref.moment_sharding_tree(jschema.param_schema(jcfg),
                                               md))
    cell = tspecs.SHAPES[CELL[mode]]
    if mode == "decode":
        B = cell.batch
        jcache = jax.eval_shape(lambda: jinit_cache(jcfg, B, cell.seq))
        assert port.cache_sharding_tree(
            tspecs.abstract_caches(tcfg, B, cell.seq)) == \
            norm_tree(ref.cache_sharding_tree(jcache))
        jbatch = {"tokens": jax.ShapeDtypeStruct((B, 1), "int32")}
        tbatch = {"tokens": tspecs._meta((B, 1), "int64")}
    else:
        with_labels = mode == "train"
        jbatch = jspecs.train_batch_shapes(jcfg, jspecs.SHAPES[CELL[mode]],
                                           with_labels)
        tbatch = tspecs.train_batch_shapes(tcfg, cell, with_labels)
    assert port.batch_sharding_tree(tbatch) == \
        norm_tree(ref.batch_sharding_tree(jbatch))
    for name in ref.act_rules():
        for dim in (1, 2, 12, 16, 48, 256, 4096):
            shape_ = (dim, 4096, dim)
            axes = (name, "seq", "batch")
            assert port.spec_for(shape_, axes) == \
                norm(ref.spec_for(shape_, axes)), (name, dim)


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_mesh_policy_specs_match_reference(arch, mode, shape):
    hold(arch, shape, mode)


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_mesh_policy_knob_matches_reference(knob):
    for arch in ("phi3-medium-14b", "granite-moe-3b-a800m"):
        for mode in MODES:
            hold(arch, (2, 16, 16), mode, **knob)


def test_production_mesh_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}


def test_plan_mesh_matches_reference(monkeypatch):
    """The reference's ``plan_mesh`` builds its mesh with
    ``jax.make_mesh``; on an abstract mesh its loop gives the shape."""
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, names: AbstractMesh(shape, names))
    for n in (1, 2, 3, 6, 8, 12, 24, 40, 96, 256, 512):
        for mp in (1, 4, 16):
            ref = jelastic.plan_mesh(n, model_parallelism=mp)
            assert plan_mesh(n, model_parallelism=mp).shape == \
                dict(ref.shape), (n, mp)
