"""The decoder stack of every family as ``nn.Module``s: GQA attention with
RoPE or M-RoPE (and QKV biases), SwiGLU MLPs, MoE, Mamba, mLSTM and
sLSTM mixers, the encoder-decoder's cross attention, tied or untied
head.

Counterpart of ``repro.models.transformer``. Modes, as in the reference:

* "train" — full-sequence teacher forcing, no cache kept; with
  ``cfg.remat`` each super-block of ``schema.block_pattern``'s layers is
  rematerialised in the backward (``torch.utils.checkpoint``);
* "prefill" — the same forward, returning each layer's serving cache;
* "decode" — one token a call against a statically shaped cache
  (:func:`init_cache`, or a prefill cache padded by
  ``model._pad_caches``), written in place.

The reference scans a super-block pattern of heterogeneous blocks
(``schema.block_pattern``); the port keeps one :class:`Block` a layer,
of the kind the pattern gives it (``schema.layer_kinds``), holding its
parameters under the reference's names. The cache is a list with one
dict a layer, in place of the reference's dict of per-block trees
stacked on the super-block axis. By kind:

* attention: ``"k"``, ``"v"`` (B, max_len, KH, Dh) after RoPE, in the
  compute dtype; with ``kv_cache_dtype == "int8"`` int8 payloads and f32
  scales ``"k_s"``, ``"v_s"`` (B, max_len, KH, 1);
* Mamba: ``"h"`` (B, Di, N) f32 and ``"conv"`` (B, CW − 1, Di);
* mLSTM: ``"C"`` (B, H, dh, dh), ``"n"`` (B, H, dh), f32;
* sLSTM: ``"c"``, ``"n"``, ``"h"`` (B, H, dh), f32;
* an encoder-decoder's layers add ``"xk"``, ``"xv"`` (B, cross_len, KH,
  Dh): the cross attention's K/V of the encoder output, written at
  prefill and only read in decode (never quantized, never padded).

Dtype policy as in the reference: f32 parameters, activations in
``cfg.compute_dtype`` (bf16 on the card), f32 norm, softmax, router and
recurrent-state statistics, logits over ``padded_vocab``.

As in the reference, the forward runs with the config it is *given*
(``DecoderLM.forward(..., cfg=)``), not only the one the weights were
built with: ``cfg.use_flash_attention`` sends the full-sequence
self-attention (causal in the decoder, non-causal in the encoder)
through ``kernels.flash_attention.flash_attention`` (kernel E on the
card) instead of the plain ``layers.gqa_attention``; the MoE's capacity
factor and dispatch are the given config's too. Decode attention and
cross attention are the plain ``layers.gqa_attention`` (XLA in the
reference, not its Pallas kernel).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers, moe
from repro_torch.models.schema import (block_pattern, enc_block_specs,
                                       layer_kinds, param_schema)
from repro_torch.models.sharding_api import NO_SHARD, ShardPolicy
from repro_torch.models.ssm import mamba_mixer, mlstm_mixer, slstm_mixer

# the fields of a config that describe no weights: the forward may run
# with a config that differs from the model's in these alone
RUNTIME_FIELDS = ("use_flash_attention", "compute_dtype", "kv_cache_dtype",
                  "capacity_factor", "moe_dispatch", "moe_group_size",
                  "remat")


def _params(module: nn.Module, specs: dict, dtype: torch.dtype,
            device: torch.device) -> None:
    """Register ``specs`` as ``module``'s parameters, uninitialised and
    without a gradient: serving never takes one, and
    ``model.loss_and_grads`` turns them on for its call."""
    for name, spec in specs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(spec.shape, dtype=dtype, device=device),
            requires_grad=False))


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(token, head) quantization for KV caches: the
    scale is max|x| / 127 over the last axis, floored at 1e-10, and the
    payload round(x / scale) clipped to ±127 (``torch.round`` is
    half-to-even, as ``jnp.round``). Returns (int8 payload, f32 scale
    with a last axis of 1)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-10)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _write_kv(cfg: ArchConfig, cache: dict, k: torch.Tensor,
              v: torch.Tensor, pos: int, dt: torch.dtype):
    """Write the new token's K/V (B, 1, KH, Dh) into ``cache`` at ``pos``
    (int8 payload and scale with ``kv_cache_dtype == "int8"``) and
    return the whole cache's K/V in the compute dtype ``dt``."""
    if cfg.kv_cache_dtype == "int8":
        for key, x in (("k", k), ("v", v)):
            q, sc = _kv_quant(x)
            cache[key][:, pos:pos + 1] = q
            cache[key + "_s"][:, pos:pos + 1] = sc
        return tuple(cache[key].to(dt) * cache[key + "_s"].to(dt)
                     for key in ("k", "v"))
    cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
    return cache["k"].to(dt), cache["v"].to(dt)


def _attention(cfg: ArchConfig, p: dict, x: torch.Tensor, positions,
               mode: str, cache: dict | None, pos: int, mrope_pos=None,
               pfx: str = "", cross_src=None, causal: bool = True,
               shard: ShardPolicy = NO_SHARD):
    """The attention sublayer, self (``pfx`` "") or cross (``pfx`` "x").
    Returns (out, new cache entries); in "decode" a self-attention writes
    the caller's ``cache`` in place. ``shard`` constrains the layouts
    where the reference's does; in "train" and "prefill" its
    ``kv_repeat`` repeats the KV heads before the attention (the cache
    keeps them unrepeated)."""
    dt = x.dtype
    h = layers.rms_norm(x, p[f"{pfx}attn_norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhe->bshe", h, p[f"{pfx}wq"].to(dt))
    if cfg.qkv_bias and f"{pfx}bq" in p:
        q = q + p[f"{pfx}bq"].to(dt)
    new_cache = {}
    if pfx == "x":
        # cross attention: K/V of the encoder output, computed at
        # prefill (and kept), read back from the cache in decode
        if cross_src is None:
            k, v = cache["xk"].to(dt), cache["xv"].to(dt)
        else:
            k = torch.einsum("bsd,dhe->bshe", cross_src, p["xwk"].to(dt))
            v = torch.einsum("bsd,dhe->bshe", cross_src, p["xwv"].to(dt))
            if mode == "prefill":
                new_cache = {"xk": k, "xv": v}
        q = shard(q, ("attn_batch", "attn_seq", "heads", "head_dim"))
        out = layers.gqa_attention(q, k, v, causal=False)
    else:
        k = torch.einsum("bsd,dhe->bshe", h, p["wk"].to(dt))
        v = torch.einsum("bsd,dhe->bshe", h, p["wv"].to(dt))
        if cfg.qkv_bias and "bk" in p:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        if cfg.mrope and mrope_pos is not None:
            q = layers.apply_mrope(q, mrope_pos, cfg.mrope_sections,
                                   cfg.rope_theta)
            k = layers.apply_mrope(k, mrope_pos, cfg.mrope_sections,
                                   cfg.rope_theta)
        else:
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        if mode == "decode":
            kf, vf = _write_kv(cfg, cache, k, v, pos, dt)
            kf = shard(kf, ("batch", "kv_seq", "kv_heads", "head_dim"))
            vf = shard(vf, ("batch", "kv_seq", "kv_heads", "head_dim"))
            q = shard(q, ("attn_batch", "attn_seq", "heads", "head_dim"))
            out = layers.gqa_attention(q, kf, vf, causal=False,
                                       kv_len=pos + 1)
        else:
            if mode == "prefill":
                new_cache = {"k": k, "v": v}
            if shard.kv_repeat > 1:
                k = k.repeat_interleave(shard.kv_repeat, dim=2)
                v = v.repeat_interleave(shard.kv_repeat, dim=2)
            q = shard(q, ("attn_batch", "attn_seq", "heads", "head_dim"))
            k = shard(k, ("attn_batch", "attn_seq", "rep_kv_heads",
                          "head_dim"))
            v = shard(v, ("attn_batch", "attn_seq", "rep_kv_heads",
                          "head_dim"))
            if cfg.use_flash_attention:
                out = flash_ops.flash_attention(q, k, v, causal=causal)
            else:
                out = layers.gqa_attention(q, k, v, causal=causal)
    out = shard(out, ("attn_batch", "attn_seq", "heads", "head_dim"))
    y = torch.einsum("bshe,hed->bsd", out, p[f"{pfx}wo"].to(dt))
    return shard(y, ("batch", "seq", "embed")), new_cache


class Block(nn.Module):
    """One decoder layer of kind ``attn+mlp``, ``attn+moe``, ``mamba+mlp``,
    ``mamba+moe``, ``mlstm`` or ``slstm`` (with cross attention after the
    mixer in an encoder-decoder), holding its parameters under the
    reference's names."""

    def __init__(self, cfg: ArchConfig, kind: str, specs: dict, dtype,
                 device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        _params(self, specs, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, mode: str, cache: dict | None, pos: int,
                mrope_pos=None, cross_src=None,
                shard: ShardPolicy = NO_SHARD):
        """Returns (x, cache, aux): the layer's new cache in "prefill",
        the caller's ``cache`` in "decode" (K/V written in place, the
        recurrent states' entries replaced by the new states), ``{}`` in
        "train"; ``aux`` the MoE's load-balance loss (None without)."""
        act = ("batch", "seq", "embed")
        p = self._parameters
        aux = None
        new_cache: dict = {}
        state = cache if mode == "decode" else None
        if self.kind in ("mlstm", "slstm"):
            mixer = mlstm_mixer if self.kind == "mlstm" else slstm_mixer
            h = layers.rms_norm(x, p["m_norm" if self.kind == "mlstm"
                                     else "s_norm"], cfg.norm_eps)
            y, st = mixer(h, p, cfg, state=state, mode=mode)
            x = x + shard(y, act)
            new_cache.update(st or {})
        else:
            mixer_kind, ffn_kind = self.kind.split("+")
            if mixer_kind == "attn":
                y, kvc = _attention(cfg, p, x, positions, mode, cache, pos,
                                    mrope_pos=mrope_pos, shard=shard)
                new_cache.update(kvc)
            else:
                h = layers.rms_norm(x, p["m_norm"], cfg.norm_eps)
                y, st = mamba_mixer(h, p, cfg, state=state, mode=mode)
                y = shard(y, act)
                new_cache.update(st or {})
            x = x + y
            if cfg.is_encdec:
                y, xc = _attention(cfg, p, x, positions, mode, cache, pos,
                                   pfx="x", cross_src=cross_src,
                                   shard=shard)
                x = x + y
                new_cache.update(xc)
            if ffn_kind == "moe":
                h = layers.rms_norm(x, p["moe_norm"], cfg.norm_eps)
                # decode never drops (a dropped decode token would corrupt
                # the stream); train and prefill use the capacity factor
                cf = -1.0 if mode == "decode" else cfg.capacity_factor
                y, aux = moe.moe_mlp(h, p["router"], p["we_gate"],
                                     p["we_up"], p["we_down"],
                                     topk=cfg.moe_topk, capacity_factor=cf,
                                     group_size=cfg.moe_group_size,
                                     dispatch=cfg.moe_dispatch, shard=shard)
                x = x + shard(y, act)
            elif cfg.d_ff or cfg.dense_ff:
                h = layers.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
                x = x + shard(layers.swiglu(h, p["w_gate"], p["w_up"],
                                            p["w_down"]), act)
        if mode == "decode":
            cache.update(new_cache)              # the recurrent states
            return x, cache, aux
        return x, new_cache, aux


class EncoderBlock(nn.Module):
    """One encoder layer: non-causal self-attention (RMS norm, RoPE), then
    a layer-normed GELU MLP with biases."""

    def __init__(self, cfg: ArchConfig, specs: dict, dtype, device):
        super().__init__()
        self.cfg = cfg
        _params(self, specs, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig,
                shard: ShardPolicy = NO_SHARD) -> torch.Tensor:
        p = self._parameters
        y, _ = _attention(cfg, p, x, positions, "train", None, 0,
                          causal=False, shard=shard)
        x = x + y
        h = layers.layer_norm(x, p["mlp_norm"], p["mlp_norm_b"],
                              cfg.norm_eps)
        return x + shard(layers.gelu_mlp(h, p["w_up"], p["b_up"],
                                         p["w_down"], p["b_down"]),
                         ("batch", "seq", "embed"))


class DecoderLM(nn.Module):
    """Embedding (and a stub frontend's projection) → ``n_layers`` blocks
    → final norm → head; in an encoder-decoder also ``n_enc_layers``
    encoder blocks (``models/encdec.py`` runs them)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        schema = param_schema(cfg)
        blocks = schema.pop("blocks")
        schema.pop("enc_blocks", None)
        dtype = getattr(torch, cfg.param_dtype)
        _params(self, schema, dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, blocks[key], dtype, device)
            for key, kind in layer_kinds(cfg))
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, enc_block_specs(cfg), dtype, device)
            for _ in range(cfg.n_enc_layers if cfg.is_encdec else 0))

    def check_cfg(self, cfg: ArchConfig | None) -> ArchConfig:
        """``cfg`` (default the model's), refused with ``ValueError`` where
        it differs from the model's config in a field that describes
        weights (any but ``RUNTIME_FIELDS``)."""
        cfg = cfg or self.cfg
        own = {f: getattr(self.cfg, f) for f in RUNTIME_FIELDS}
        if dataclasses.replace(cfg, **own) != self.cfg:
            raise ValueError(
                f"cfg {cfg.name!r} describes other weights than the "
                f"model's {self.cfg.name!r}: only {', '.join(RUNTIME_FIELDS)}"
                f" may differ")
        return cfg

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                cfg: ArchConfig | None = None, mode: str = "prefill",
                caches: list | None = None, pos: int = 0, **inputs):
        """(logits (B, S, padded_vocab), caches): :meth:`run` without the
        MoE aux loss."""
        logits, caches, _ = self.run(tokens, positions, cfg, mode, caches,
                                     pos, **inputs)
        return logits, caches

    def _super_block(self, start: int, period: int, x: torch.Tensor,
                     positions, cfg: ArchConfig, mrope_pos, cross_src,
                     shard: ShardPolicy = NO_SHARD):
        """The train-mode forward of the ``period`` layers from ``start``
        (one super-block of the reference's scan): (x, the sum of their
        MoE losses). With ``cfg.remat`` and grad mode on it runs under
        ``torch.utils.checkpoint``, so the backward recomputes the
        super-block's activations from its input, as the reference's
        ``jax.checkpoint`` of ``super_block``."""
        def run(x):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for blk in self.blocks[start:start + period]:
                x, _, a = blk(x, positions, cfg, "train", None, 0,
                              mrope_pos=mrope_pos, cross_src=cross_src,
                              shard=shard)
                if a is not None:
                    aux = aux + a
            return x, aux
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint.checkpoint(run, x, use_reentrant=False)
        return run(x)

    def run(self, tokens: torch.Tensor,
            positions: torch.Tensor | None = None,
            cfg: ArchConfig | None = None, mode: str = "prefill",
            caches: list | None = None, pos: int = 0, *,
            image_embeds: torch.Tensor | None = None,
            mrope_positions: torch.Tensor | None = None,
            cross_src: torch.Tensor | None = None,
            shard: ShardPolicy = NO_SHARD):
        """Run with ``cfg`` (default: the config the model was built
        with; :meth:`check_cfg`). ``image_embeds`` (B, S_img, 1280), with
        a vision stub, are projected and put before the tokens;
        ``mrope_positions`` (3, B, S) rotate by M-RoPE where the config
        has it (plain RoPE on ``positions`` otherwise). In an
        encoder-decoder, "train" and "prefill" need the encoder output
        ``cross_src`` (``encdec.encdec_forward`` computes it); decode
        reads it from the cache. In "decode" ``tokens`` is (B, 1) at
        position ``pos`` and ``caches`` (one dict a layer) is written in
        place and returned; a ``pos`` outside [0, max_len) of the
        attention caches raises ``ValueError`` (the reference's
        ``dynamic_update_slice`` would clamp it). "train" returns no
        caches (``None``). ``shard`` (models/sharding_api.py) constrains
        the layouts where the reference's does, the default none. Returns
        (logits, caches, aux), ``aux`` the MoE load-balance losses summed
        over the layers (f32)."""
        cfg = self.check_cfg(cfg)
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "decode":
            if caches is None or len(caches) != len(self.blocks):
                raise ValueError(f"decode needs one cache a layer "
                                 f"({len(self.blocks)})")
            max_len = next((c["k"].shape[1] for c in caches if "k" in c),
                           None)
            if max_len is not None and not 0 <= pos < max_len:
                raise ValueError(f"decode position {pos} is outside the "
                                 f"cache's {max_len} slots")
        elif cfg.is_encdec and cross_src is None:
            raise ValueError("an encoder-decoder needs the encoder output "
                             "(encdec.encdec_forward computes it)")
        dt = getattr(torch, cfg.compute_dtype)
        x = self.embed[tokens].to(dt)
        if cfg.frontend == "vision_stub" and image_embeds is not None:
            img = torch.einsum("bse,ed->bsd", image_embeds.to(dt),
                               self.vision_proj.to(dt))
            x = torch.cat([img, x], dim=1)
        x = shard(x, ("batch", "seq", "embed"))
        B, S = x.shape[:2]
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :] \
                .expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = []
        if mode == "train":
            period = len(block_pattern(cfg))
            for s in range(0, len(self.blocks), period):
                x, a = self._super_block(s, period, x, positions, cfg,
                                         mrope_positions, cross_src, shard)
                aux = aux + a
        else:
            for i, blk in enumerate(self.blocks):
                x, c, a = blk(x, positions, cfg, mode,
                              caches[i] if mode == "decode" else None, pos,
                              mrope_pos=mrope_positions, cross_src=cross_src,
                              shard=shard)
                new_caches.append(c)
                if a is not None:
                    aux = aux + a
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = shard(torch.einsum("bsd,dv->bsv", x, w.to(dt)),
                       ("batch", "seq", "vocab"))
        if mode == "decode":
            return logits, caches, aux
        return logits, (None if mode == "train" else new_caches), aux


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               dtype: str | torch.dtype | None = None,
               device: str | torch.device | None = None) -> list:
    """Statically shaped serving cache for decode, one dict a layer, all
    zero, in the layouts of the module docstring: K/V in ``dtype``
    (default the compute dtype) or int8 with ``kv_cache_dtype ==
    "int8"``, recurrent states in f32, the Mamba conv window and the
    cross K/V in ``dtype``. On ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    dt = dtype or cfg.compute_dtype
    dt = getattr(torch, dt) if isinstance(dt, str) else dt
    B, kh, dh, nh = batch_size, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    f32 = torch.float32

    def zeros(shape, t):
        return torch.zeros(shape, dtype=t, device=device)

    caches = []
    for _, kind in layer_kinds(cfg):
        if kind == "mlstm":
            dhe = cfg.ssm_expand * cfg.d_model // nh
            caches.append({"C": zeros((B, nh, dhe, dhe), f32),
                           "n": zeros((B, nh, dhe), f32)})
            continue
        if kind == "slstm":
            dhe = cfg.d_model // nh
            caches.append({key: zeros((B, nh, dhe), f32)
                           for key in ("c", "n", "h")})
            continue
        shape = (B, max_len, kh, dh)
        if kind.startswith("attn") and cfg.kv_cache_dtype == "int8":
            c = {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                 "k_s": zeros(shape[:3] + (1,), f32),
                 "v_s": zeros(shape[:3] + (1,), f32)}
        elif kind.startswith("attn"):
            c = {"k": zeros(shape, dt), "v": zeros(shape, dt)}
        else:
            c = {"h": zeros((B, cfg.d_inner, cfg.ssm_state), f32),
                 "conv": zeros((B, cfg.ssm_conv - 1, cfg.d_inner), dt)}
        if cfg.is_encdec:
            c["xk"] = zeros((B, cfg.cross_len, kh, dh), dt)
            c["xv"] = zeros((B, cfg.cross_len, kh, dh), dt)
        caches.append(c)
    return caches
