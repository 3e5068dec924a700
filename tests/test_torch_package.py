"""The port stands alone: importing every module of ``repro_torch``
loads neither ``jax`` nor anything of the reference package ``repro``,
and the package switches TF32 off where it initialises."""
import os
import subprocess
import sys

import pytest

MODULES = [
    "repro_torch", "repro_torch.core.costs", "repro_torch.core.catalog",
    "repro_torch.core.demand", "repro_torch.core.topology",
    "repro_torch.core.objective", "repro_torch.core.simcache",
    "repro_torch.core.placement", "repro_torch.kernels",
    "repro_torch.kernels.build", "repro_torch.kernels.knn",
    "repro_torch.configs.registry", "repro_torch.models.model",
    "repro_torch.models.convert", "repro_torch.serve.engine",
    "repro_torch.tracecount", "repro_torch.serve.stream",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.flash_attention.flash",
    "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.gain",
    "repro_torch.kernels.gain.ref", "repro_torch.kernels.gain.gain",
    "repro_torch.kernels.gain.ops", "repro_torch.core.placement.netduel",
    "repro_torch.kernels.duel", "repro_torch.kernels.duel.duel",
    "repro_torch.core.placement.continuous",
    "repro_torch.core.placement.warmstart", "repro_torch.core.scenarios",
    "repro_torch.core.routing", "repro_torch.core.analysis",
    "repro_torch.core.analysis.hitrate", "repro_torch.kernels.quant",
    "repro_torch.kernels.knn.lsh", "repro_torch.kernels.knn.ops",
    "repro_torch.kernels.knn.ref", "repro_torch.kernels.knn.gains",
    "repro_torch.launch.mesh", "repro_torch.launch.sharding",
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.schedule", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.checkpoint",
    "repro_torch.checkpoint.ckpt", "repro_torch.train",
    "repro_torch.train.trainer", "repro_torch.ft",
    "repro_torch.ft.straggler", "repro_torch.launch.train"]

_PROBE = """
import sys
import importlib
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro."))
import torch
print(bad, torch.backends.cuda.matmul.allow_tf32,
      torch.backends.cudnn.allow_tf32)
"""


@pytest.mark.parametrize("modules", [["repro_torch"], MODULES])
def test_import_loads_no_jax_and_no_reference(modules):
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c",
                          _PROBE.format(mods=modules)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout.strip()
    assert out == "[] False False", out


EXAMPLES = ["quickstart_torch", "netduel_online_torch",
            "serve_simcache_torch", "streaming_serve_torch",
            "train_lm_torch", "amazon_trace_torch"]

_EXAMPLE_PROBE = """
import importlib.util
import sys
for name in {names!r}:
    spec = importlib.util.spec_from_file_location(
        name, {examples!r} + "/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro.")))
"""


def test_examples_twins_load_no_jax_and_no_reference():
    """The examples' twins (``examples/*_torch.py``) import the port
    alone."""
    root = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _EXAMPLE_PROBE.format(
            names=EXAMPLES, examples=os.path.join(root, "examples"))],
        capture_output=True, text=True, env=env, timeout=300,
        check=True).stdout.strip()
    assert out == "[]", out


def test_chip_smoke_refuses_without_a_card():
    """``chip_smoke.py`` prints no result and exits non-zero when no
    CUDA device is available."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
