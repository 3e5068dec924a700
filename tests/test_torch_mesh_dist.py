"""The port's cross-pod gradient mean (ft/compress.py) on 8 gloo ranks and
its elastic re-meshing (ft/elastic.py, ``checkpoint.restore_for_mesh``),
on the CPU.

* ``compressed_crosspod_mean`` over a (pod 2, data 4) ``DeviceMesh`` of 8
  processes: for the reference test's replicated gradient, bitwise the
  reference's ``compressed_crosspod_mean`` on its 8-device subprocess;
  for distinct per-rank gradients (multiples of 1/8, so every f32 sum is
  exact in any order), bitwise a NumPy composition: the mean over each
  pod's 4 ranks, the per-row int8 codec, the mean of the 2 pods'
  dequantized rows. Every rank ends with the same values.
* A checkpoint of the reference's granite-3-2b smoke weights restored
  onto (4, 2), (2, 4) and (8, 1): every device's blocks (one
  ``restore_for_mesh`` a device) reassemble every leaf bitwise, and the
  train-mode loss of the reassembled weights under each mesh's train
  policy equals the reference's unsharded loss (1e-5 relative, the arch
  suite's; the (2, 4) policy repeats the KV heads). This is the
  counterpart of the reference's ``test_elastic_remesh_restore``, which
  fails under JAX 0.9 (F5).
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from family_cases import make_batch, reference_pair, to_jax, to_torch
from repro.models import model as jmodel
from repro_torch.checkpoint import restore_for_mesh, save
from repro_torch.ft import plan_mesh, reshard_plan
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import MeshShardPolicy, shard_slices
from repro_torch.models import convert
from repro_torch.models import model as model_api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.ft import compressed_crosspod_mean
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("pod", "data"))
        inp = np.load(os.path.join(out, "in.npz"))
        grads = {"rep": torch.from_numpy(inp["rep"]),
                 "nested": {"dist": torch.from_numpy(inp["dist"][rank]),
                            "scalar": torch.tensor(inp["scalar"][rank])}}
        res = compressed_crosspod_mean(grads, mesh)
        np.savez(os.path.join(out, f"out{rank}.npz"), rep=res["rep"],
                 dist=res["nested"]["dist"], scalar=res["nested"]["scalar"])
    finally:
        dist.destroy_process_group()
""")

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.ft.compress import compressed_crosspod_mean
    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    g = jnp.asarray(np.load(sys.argv[1])["rep"])
    with mesh:
        out = compressed_crosspod_mean({"g": g}, mesh)["g"]
    np.save(sys.argv[2], np.asarray(out))
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env() -> dict:
    e = dict(os.environ, PYTHONPATH=SRC)
    e.pop("XLA_FLAGS", None)
    return e


def codec(x: np.ndarray) -> np.ndarray:
    """dequantize ∘ quantize, per row of the last axis, in NumPy f32 (no
    denormal or zero row in these inputs)."""
    x = x.astype(np.float32)
    scale = np.max(np.abs(x), axis=-1, keepdims=True) / np.float32(127.0)
    q = np.clip(np.round(x / scale), -127, 127)
    return (q * scale).astype(np.float32)


def test_compressed_crosspod_mean_on_eight_gloo_ranks(tmp_path):
    rng = np.random.default_rng(0)
    rep = rng.standard_normal((16, 64)).astype(np.float32)   # the ref's
    dist_g = (rng.integers(-512, 512, (8, 16, 64)) / 8).astype(np.float32)
    scalar = (rng.integers(1, 64, (8,)) / 8).astype(np.float32)
    np.savez(tmp_path / "in.npz", rep=rep, dist=dist_g, scalar=scalar)
    (tmp_path / "worker.py").write_text(WORKER)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"),
                               str(r), str(port), str(tmp_path)], env=env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(8)]
    (tmp_path / "ref.py").write_text(REFERENCE)
    ref = subprocess.run([sys.executable, str(tmp_path / "ref.py"),
                          str(tmp_path / "in.npz"), str(tmp_path / "ref.npy")],
                         env=env(), capture_output=True, text=True,
                         timeout=300)
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    got = [np.load(tmp_path / f"out{r}.npz") for r in range(8)]
    for g in got[1:]:
        for key in ("rep", "dist", "scalar"):
            assert np.array_equal(g[key], got[0][key]), key
    assert np.array_equal(got[0]["rep"], np.load(tmp_path / "ref.npy"))

    def compose(x):
        pods = [x[4 * p:4 * p + 4].sum(0) / np.float32(4) for p in (0, 1)]
        deq = np.stack([codec(np.atleast_1d(p)) for p in pods])
        return (deq.sum(0) / np.float32(2)).reshape(x.shape[1:])
    assert np.array_equal(got[0]["dist"], compose(dist_g))
    assert np.array_equal(got[0]["scalar"], compose(scalar))
    # the codec's error bound: half a step of each pod's row scale
    assert np.abs(got[0]["rep"] - rep).max() <= \
        np.abs(rep).max(-1).max() / 127 / 2 * 1.0001


def place(full: np.ndarray, block: np.ndarray, spec: tuple, mesh: ShardMesh,
          coords: dict) -> None:
    """Write one device's block of ``full`` where ``local_shard`` cut it."""
    full[shard_slices(full.shape, spec, mesh, coords)] = block


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflat(f):
    root: dict = {}
    for path, v in f.items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return root


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)], ids=str)
def test_restore_for_mesh_reassembles_and_keeps_the_loss(shape, tmp_path):
    jcfg, cfg, params, _ = reference_pair("granite-3-2b")
    tree = jax.tree.map(np.asarray, params)
    save(str(tmp_path), 5, {"params": tree})
    mesh = plan_mesh(shape[0] * shape[1], model_parallelism=shape[1])
    assert mesh.shape == {"data": shape[0], "model": shape[1]}
    specs = flat(reshard_plan(cfg, mesh))
    want = flat(tree)
    built = {k: np.zeros_like(v) for k, v in want.items()}
    for d in range(shape[0]):
        for m in range(shape[1]):
            coords = {"data": d, "model": m}
            step, state = restore_for_mesh(str(tmp_path),
                                           {"params": unflat(specs)}, mesh,
                                           coords, device="cpu")
            assert step == 5
            for k, block in flat(state["params"]).items():
                place(built[k], convert.host_array(block), specs[k], mesh,
                      coords)
    for k, v in want.items():
        assert built[k].dtype == v.dtype and np.array_equal(built[k], v), k

    batch = make_batch(cfg, np.random.default_rng(2), B=8, S=16)
    ref, _ = jax.jit(jmodel.make_train_forward(jcfg))(params, to_jax(batch))
    model = convert.from_jax_params(cfg, unflat(built), device="cpu")
    policy = MeshShardPolicy.create(cfg, mesh, "train")
    loss, _ = model_api.make_train_forward(cfg, policy)(model,
                                                        to_torch(batch))
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
