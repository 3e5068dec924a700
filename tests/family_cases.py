"""Shared set-up of the model-family differentials (tests/test_torch_moe.py,
test_torch_ssm.py, test_torch_encdec.py, test_torch_vlm.py and
test_torch_arch_smoke.py): the reference's smoke config and the port's,
the reference's weights with every zero- or one-initialised parameter
redrawn, the port's model of them, and batches drawn with numpy.

The reference initialises biases to zeros and norm scales to ones
(``bq``/``bk``/``bv``, ``conv_b``, ``b_up``/``b_down``, ``mlp_norm_b``,
``b_izfo``; every ``*norm``, ``Dskip``): on such weights a differential
cannot see a bias added at the wrong place or a norm read from the wrong
parameter. :func:`randomize_constants` redraws them (biases N(0, 0.1²),
scales 1 + N(0, 0.1²)) before the tree reaches ``from_jax_params``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import convert, moe

ZERO_INIT = {"bq", "bk", "bv", "conv_b", "b_up", "b_down", "mlp_norm_b",
             "b_izfo"}
ATOL = {"float32": 1e-4, "bfloat16": 3e-2}   # tests/test_torch_model.py
# a router gap (k-th minus (k+1)-th probability) below which a bf16 run of
# the port and one of the reference may choose different experts: their
# router inputs differ by bf16 roundings (2^-8 relative an element)
BF16_ROUTER_GAP = 2.0 ** -10


def _is_one_init(name: str) -> bool:
    return name.endswith("norm") or name == "Dskip"


def randomize_constants(params: dict, seed: int = 0) -> dict:
    """The reference tree with its zero- and one-initialised leaves
    redrawn (see the module docstring); other leaves unchanged."""
    rng = np.random.default_rng(seed + 1000)

    def walk(tree):
        out = {}
        for key, v in sorted(tree.items()):
            if isinstance(v, dict):
                out[key] = walk(v)
            elif key in ZERO_INIT:
                out[key] = jnp.asarray(0.1 * rng.standard_normal(v.shape),
                                       v.dtype)
            elif _is_one_init(key):
                out[key] = jnp.asarray(
                    1.0 + 0.1 * rng.standard_normal(v.shape), v.dtype)
            else:
                out[key] = v
        return out
    return walk(params)


def configs(arch: str, **fields):
    """(reference config, port config) of ``arch``'s smoke config with
    ``fields`` replaced; equal field for field."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), **fields)
    cfg = dataclasses.replace(get_smoke_config(arch), **fields)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def reference_pair(arch: str, seed: int = 0, **fields):
    """(jcfg, cfg, reference params, port model): the reference's smoke
    weights from ``seed`` with their constants redrawn, and the port's
    model holding them (on the CPU)."""
    jcfg, cfg = configs(arch, **fields)
    params = randomize_constants(jmodel.init_params(jcfg, seed), seed)
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, cfg, params, model


def make_batch(cfg, rng, B: int = 2, S: int = 24, S_img: int = 8,
               grid: bool = False) -> dict:
    """The reference suite's batch (tests/test_arch_smoke.py): tokens,
    labels, and where the family takes them audio frames (64 × 128) or
    ``S_img`` image patches with M-RoPE ids — the same ids on the three
    streams, or with ``grid`` distinct temporal / height / width ids (a
    patch grid of 2 × 4 for the image, then text ids past it)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        batch["audio_embeds"] = rng.standard_normal(
            (B, 64, 128)).astype(np.float32)
    if cfg.mrope:
        batch["image_embeds"] = rng.standard_normal(
            (B, S_img, 1280)).astype(np.float32)
        ids = np.broadcast_to(np.arange(S + S_img)[None], (3, S + S_img))
        if grid:
            ids = mrope_grid(S_img, S)
        batch["mrope_positions"] = np.broadcast_to(
            ids[:, None, :], (3, B, S + S_img)).astype(np.int32)
    return batch


def mrope_grid(S_img: int, S: int, width: int = 4) -> np.ndarray:
    """(3, S_img + S) M-RoPE ids as Qwen2-VL lays them out: the image
    patches on a grid (temporal 0, height i // width, width i % width),
    then the text, whose three ids are equal and start past the grid's
    largest."""
    i = np.arange(S_img)
    img = np.stack([np.zeros_like(i), i // width, i % width])
    start = img.max() + 1
    txt = np.broadcast_to(start + np.arange(S)[None], (3, S))
    return np.concatenate([img, txt], axis=1)


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v)).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.as_tensor(np.ascontiguousarray(v))
            for k, v in batch.items()}


def to_port_caches(cfg, jcaches) -> list:
    return convert.caches_from_jax(cfg, jax.tree.map(np.asarray, jcaches),
                                   device="cpu")


def hold_caches(got: list, ref: list, atol: float, rtol: float = 0.0):
    """Port caches against the reference's (both in the port's layout):
    the same names, shapes and dtypes, values within ``atol`` (+ ``rtol``
    relative)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in g:
            assert g[key].shape == r[key].shape, key
            assert g[key].dtype == r[key].dtype, key
            torch.testing.assert_close(g[key].float(), r[key].float(),
                                       atol=atol, rtol=rtol)


@contextlib.contextmanager
def router_gaps():
    """Record, for every ``moe_mlp`` call of the port inside the block, the
    (B, S) router gaps of its input (``moe.router_gaps``); yields the
    list."""
    gaps, orig = [], moe.moe_mlp

    def recording(x, router, *args, topk, **kw):
        gaps.append(moe.router_gaps(x, router, topk))
        return orig(x, router, *args, topk=topk, **kw)
    moe.moe_mlp = recording
    try:
        yield gaps
    finally:
        moe.moe_mlp = orig


def near_ties(gaps: list, shape: tuple, threshold: float) -> np.ndarray:
    """(B, S) mask of the positions whose smallest router gap over the
    recorded MoE layers is below ``threshold`` (none without MoE)."""
    if not gaps:
        return np.zeros(shape, bool)
    return (torch.stack(gaps).amin(0).float() < threshold).numpy()
