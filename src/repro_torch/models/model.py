"""Public model API: build (init, loss, train-forward, prefill, serve-step,
cache, greedy sampler) from an ArchConfig.

Counterpart of ``repro.models.model``, for every architecture.
``init_params`` returns the model itself — an ``nn.Module`` whose
parameters play the role of the reference's parameter tree — with
random weights drawn on ``device`` from a seeded ``torch.Generator``
(the reference's ``jax.random`` draws are not reproduced; tests that
compare against it load the JAX weights through models/convert.py).
Every function runs with the config it is given, not the one the
weights were built with (``DecoderLM.check_cfg``). A batch is a dict:
``tokens`` (B, S), and where the family takes them ``image_embeds`` (B,
S_img, 1280) with ``mrope_positions`` (3, B, S_img + S) (the VLM),
``audio_embeds`` (B, S_frames, 128) (the encoder-decoder), ``positions``
(B, S); ``labels`` and ``loss_mask`` for the loss. ``init_params``
returns parameters with ``requires_grad=False``, as every serving path
wants them; :func:`loss_and_grads` turns the gradient on for its call
and backpropagates :func:`loss_fn` through every family (the trainer's
step, ``train/trainer.py``).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.schema import layer_kinds, param_schema
from repro_torch.models.sharding_api import NO_SHARD, ShardPolicy
from repro_torch.models.transformer import DecoderLM, _kv_quant

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def init_params(cfg: ArchConfig, seed: int = 0,
                device: str | torch.device | None = None) -> DecoderLM:
    """A randomly initialized model on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    schema = param_schema(cfg)
    blocks = schema.pop("blocks")
    enc = schema.pop("enc_blocks", {}).get("enc", {})
    dtype = getattr(torch, cfg.param_dtype)
    with torch.no_grad():
        for name in sorted(schema):
            getattr(model, name).copy_(schema[name].make(gen, dtype, dev))
        for (key, _), blk in zip(layer_kinds(cfg), model.blocks):
            for name in sorted(blocks[key]):
                getattr(blk, name).copy_(blocks[key][name].make(gen, dtype,
                                                                dev))
        for blk in model.enc_blocks:
            for name in sorted(enc):
                getattr(blk, name).copy_(enc[name].make(gen, dtype, dev))
    return model


def forward(cfg: ArchConfig, params: DecoderLM, batch: dict, *,
            mode: str = "train", caches: list | None = None, pos: int = 0,
            shard: ShardPolicy = NO_SHARD):
    """(logits, caches, aux) of ``batch``: the encoder-decoder through
    ``encdec.encdec_forward``, every other family through the stack,
    under the shard policy ``shard``."""
    if cfg.is_encdec:
        return encdec.encdec_forward(cfg, params, batch, mode=mode,
                                     caches=caches, pos=pos, shard=shard)
    return params.run(batch["tokens"], batch.get("positions"), cfg, mode,
                      caches, pos, image_embeds=batch.get("image_embeds"),
                      mrope_positions=batch.get("mrope_positions"),
                      shard=shard)


def loss_fn(cfg: ArchConfig, params: DecoderLM, batch: dict,
            shard: ShardPolicy = NO_SHARD) -> tuple[torch.Tensor, dict]:
    """Token cross-entropy (+ MoE aux loss + z-loss). ``batch`` needs
    ``tokens`` (B, S) and ``labels`` (B, S_lab); the last S_lab positions
    are scored. An optional ``loss_mask`` (B, S_lab) zeroes out positions;
    the denominator is its sum, floored at 1. Returns (total, {"ce",
    "aux", "zloss"}), f32 scalars; ``aux`` is the MoE load-balance loss
    summed over the layers (0 without MoE)."""
    logits, _, aux = forward(cfg, params, batch, mode="train", shard=shard)
    labels = batch["labels"]
    logits_f = logits[:, -labels.shape[1]:, :].float()
    logz = torch.logsumexp(logits_f, dim=-1)
    # the gather on (tokens, vocab) rows: a vocab-sharded DTensor takes
    # the 2-D gather only
    ll = torch.gather(logits_f.reshape(-1, logits_f.shape[-1]), 1,
                      labels.reshape(-1, 1).long()).reshape(labels.shape)
    nll = logz - ll
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    ce = (nll * mask).sum() / denom
    zloss = (logz ** 2 * mask).sum() / denom
    total = ce + AUX_LOSS_WEIGHT * aux + Z_LOSS_WEIGHT * zloss
    return total, {"ce": ce, "aux": aux, "zloss": zloss}


def make_train_forward(cfg: ArchConfig, shard: ShardPolicy = NO_SHARD
                       ) -> Callable:
    """(params, batch) → (loss, metrics): the forward of the loss."""
    return functools.partial(loss_fn, cfg, shard=shard)


def loss_and_grads(cfg: ArchConfig, params: DecoderLM, batch: dict,
                   shard: ShardPolicy = NO_SHARD
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, {name: gradient}) of :func:`loss_fn`, the
    gradient by autograd: a zero one where the forward does not reach a
    parameter, as ``jax.grad`` gives. The parameters take a gradient for
    the call alone and come back as they were (without one, from
    :func:`init_params`)."""
    named = dict(params.named_parameters())
    was = [p.requires_grad for p in named.values()]
    params.requires_grad_(True)
    try:
        loss, metrics = loss_fn(cfg, params, batch, shard)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p, w in zip(named.values(), was):
            p.requires_grad_(w)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(named, grads)))


def make_prefill(cfg: ArchConfig, shard: ShardPolicy = NO_SHARD
                 ) -> Callable:
    """(params, batch) → (logits, caches): the full-sequence forward the
    engine runs on its misses, with ``cfg`` — not the config ``params``
    was built with — deciding the attention (``use_flash_attention``),
    as in the reference. ``params`` is the model."""
    def prefill(params: DecoderLM, batch: dict):
        with torch.inference_mode():
            logits, caches, _ = forward(cfg, params, batch, mode="prefill",
                                        shard=shard)
        return logits, caches
    return prefill


def make_serve_step(cfg: ArchConfig, shard: ShardPolicy = NO_SHARD
                    ) -> Callable:
    """One decode step: (params, tokens (B, 1), caches, pos) → (logits
    (B, 1, V), caches). ``pos`` is the current sequence length (the new
    token's position). The step writes the new K/V into the caller's
    ``caches`` in place (a static shape) and returns that same list;
    a ``pos`` outside the cache raises ``ValueError``. With M-RoPE the
    step's position ids are ``pos`` on all three streams; an
    encoder-decoder reads its encoder output from the cache."""
    def serve_step(params: DecoderLM, tokens: torch.Tensor, caches: list,
                   pos: int):
        with torch.inference_mode():
            logits, caches_out, _ = forward(
                cfg, params, serve_batch(cfg, tokens, pos), mode="decode",
                caches=caches, pos=pos, shard=shard)
        return logits, caches_out
    return serve_step


def serve_batch(cfg: ArchConfig, tokens: torch.Tensor, pos: int) -> dict:
    """A decode step's batch: ``tokens`` (B, 1) at position ``pos`` (on
    all three M-RoPE streams where the config has them)."""
    B = tokens.shape[0]
    batch = {"tokens": tokens,
             "positions": torch.full((B, 1), pos, dtype=torch.long,
                                     device=tokens.device)}
    if cfg.mrope:
        batch["mrope_positions"] = torch.full(
            (3, B, 1), pos, dtype=torch.long, device=tokens.device)
    return batch


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               device: str | torch.device | None = None) -> list:
    """The zeroed serving cache (``transformer.init_cache``) on
    ``device`` (CUDA unless named)."""
    return transformer.init_cache(cfg, batch_size, max_len, device=device)


def _pad_caches(cfg: ArchConfig, caches: list, max_len: int) -> list:
    """Pad prefill KV caches along the sequence axis to ``max_len``,
    quantizing them first when ``cfg.kv_cache_dtype == "int8"``. Only
    the self-attention ``k``/``v`` grow: recurrent states and the cross
    K/V are fixed-size. Returns new dicts; the prefill's tensors are not
    changed."""
    out = []
    for layer in caches:
        entry = dict(layer)
        for key in ("k", "v"):
            if key not in entry:
                continue
            x = entry[key]
            if cfg.kv_cache_dtype == "int8" and x.dtype != torch.int8:
                entry[key], entry[key + "_s"] = _kv_quant(x)
            extra = max_len - x.shape[1]
            if extra < 0:
                raise ValueError(f"the cache holds {x.shape[1]} positions, "
                                 f"more than max_len {max_len}")
            for name in (key, key + "_s"):
                if name in entry:
                    entry[name] = F.pad(entry[name],
                                        (0, 0, 0, 0, 0, extra))
        out.append(entry)
    return out


def greedy_generate(cfg: ArchConfig, params: DecoderLM,
                    prompt: torch.Tensor, n_steps: int,
                    max_len: int | None = None,
                    shard: ShardPolicy = NO_SHARD) -> torch.Tensor:
    """Greedy argmax sampler: the prefill of ``prompt`` (B, S), its cache
    padded to ``max_len`` (default S + n_steps), then ``n_steps`` − 1
    serve steps. Returns the (B, n_steps) generated tokens (int64, on
    the prompt's device). The argmax is over the padded vocabulary and
    takes the first index of a tie, as ``jnp.argmax``. With M-RoPE the
    prompt's position ids are ``arange(S)`` on all three streams. An
    encoder-decoder raises ``NotImplementedError``, as the reference
    (its prefill needs ``audio_embeds``)."""
    B, S = prompt.shape
    max_len = max_len or (S + n_steps)
    if cfg.is_encdec:
        raise NotImplementedError("use the serving engine for enc-dec")
    step = make_serve_step(cfg, shard)
    batch = {"tokens": prompt}
    if cfg.mrope:
        batch["mrope_positions"] = torch.arange(
            S, device=prompt.device)[None, None, :].expand(3, B, S)
    logits, caches = make_prefill(cfg, shard)(params, batch)
    with torch.inference_mode():
        caches = _pad_caches(cfg, caches, max_len)
    tok = logits[:, -1:, :].argmax(dim=-1)
    out = [tok]
    for t in range(n_steps - 1):
        logits, caches = step(params, tok, caches, S + t)
        tok = logits[:, -1:, :].argmax(dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1)
