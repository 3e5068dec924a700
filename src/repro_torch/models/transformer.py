"""Dense decoder-only LM as ``nn.Module``s: GQA attention with RoPE and a
SwiGLU MLP per layer, tied or untied head.

Counterpart of the dense-decoder path of ``repro.models.transformer``.
Modes, as in the reference:

* "train" — full-sequence teacher forcing, no cache kept;
* "prefill" — the same forward, returning each layer's K/V (after RoPE,
  in the compute dtype) as the serving cache;
* "decode" — one token a call against a statically shaped cache
  (:func:`init_cache`, or a prefill cache padded by
  ``model._pad_caches``), written at ``pos`` in place.

The cache is a list with one dict a layer (``"k"``, ``"v"``: (B,
max_len, KH, Dh); with ``kv_cache_dtype == "int8"`` int8 payloads and
f32 scales ``"k_s"``, ``"v_s"``: (B, max_len, KH, 1)), in place of the
reference's dict of tensors stacked on a layer axis. The other families
are later slices. Dtype policy as in the reference: f32 parameters,
activations in ``cfg.compute_dtype`` (bf16 on the card), f32 norm and
softmax statistics, logits over ``padded_vocab``.

As in the reference, the forward runs with the config it is *given*
(``DecoderLM.forward(..., cfg=)``), not only the one the weights were
built with: ``cfg.use_flash_attention`` sends the full-sequence
attention through ``kernels.flash_attention.flash_attention`` (kernel E
on the card) instead of the plain ``layers.gqa_attention``, so one set
of weights serves both settings. Decode attention is the plain
``layers.gqa_attention`` over the whole cache with ``kv_len = pos + 1``
(XLA in the reference, not its Pallas kernel).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.schema import block_pattern, param_schema


def _params(module: nn.Module, specs: dict, dtype: torch.dtype,
            device: torch.device) -> None:
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


class DecoderBlock(nn.Module):
    """One ``attn+mlp`` block: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, cfg: ArchConfig, specs: dict, dtype, device):
        super().__init__()
        self.cfg = cfg
        _params(self, specs, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig | None = None, mode: str = "prefill",
                cache: dict | None = None, pos: int = 0):
        """Returns (x, new cache): this layer's K/V in "prefill", the
        cache written at ``pos`` in "decode", ``{}`` in "train"."""
        cfg, dt = cfg or self.cfg, x.dtype
        h = layers.rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = torch.einsum("bsd,dhe->bshe", h, self.wq.to(dt))
        k = torch.einsum("bsd,dhe->bshe", h, self.wk.to(dt))
        v = torch.einsum("bsd,dhe->bshe", h, self.wv.to(dt))
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        if mode == "decode":
            kf, vf = _write_kv(cfg, cache, k, v, pos, dt)
            out = layers.gqa_attention(q, kf, vf, causal=False,
                                       kv_len=pos + 1)
            new_cache = cache
        else:
            if cfg.use_flash_attention:
                out = flash_ops.flash_attention(q, k, v, causal=True)
            else:
                out = layers.gqa_attention(q, k, v, causal=True)
            new_cache = {"k": k, "v": v} if mode == "prefill" else {}
        x = x + torch.einsum("bshe,hed->bsd", out, self.wo.to(dt))
        h = layers.rms_norm(x, self.mlp_norm, cfg.norm_eps)
        x = x + layers.swiglu(h, self.w_gate, self.w_up, self.w_down)
        return x, new_cache


class DecoderLM(nn.Module):
    """Token embedding → ``n_layers`` decoder blocks → final norm → head.
    ``forward`` returns (logits (B, S, padded_vocab), per-layer KV)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        schema = param_schema(cfg)
        block = schema.pop("block")
        dtype = getattr(torch, cfg.param_dtype)
        _params(self, schema, dtype, device)
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, block, dtype, device)
            for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                cfg: ArchConfig | None = None, mode: str = "prefill",
                caches: list | None = None, pos: int = 0):
        """Run with ``cfg`` (default: the config the model was built
        with). It may differ from that config only in
        ``use_flash_attention``, ``compute_dtype`` and
        ``kv_cache_dtype``: any other field describes other weights, and
        raises ``ValueError``. In "decode" ``tokens`` is (B, 1) at
        position ``pos`` and ``caches`` (one dict a layer, sequence axis
        ``max_len``) is written in place and returned; ``pos`` outside
        [0, max_len) raises ``ValueError`` (the reference's
        ``dynamic_update_slice`` would clamp it). "train" returns no
        caches (``None``)."""
        cfg = cfg or self.cfg
        if dataclasses.replace(cfg, use_flash_attention=self.cfg
                               .use_flash_attention,
                               compute_dtype=self.cfg.compute_dtype,
                               kv_cache_dtype=self.cfg.kv_cache_dtype) \
                != self.cfg:
            raise ValueError(
                f"cfg {cfg.name!r} describes other weights than the "
                f"model's {self.cfg.name!r}: only use_flash_attention, "
                f"compute_dtype and kv_cache_dtype may differ")
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "decode":
            if caches is None or len(caches) != len(self.blocks):
                raise ValueError(f"decode needs one cache a layer "
                                 f"({len(self.blocks)})")
            max_len = caches[0]["k"].shape[1]
            if not 0 <= pos < max_len:
                raise ValueError(f"decode position {pos} is outside the "
                                 f"cache's {max_len} slots")
        dt = getattr(torch, cfg.compute_dtype)
        x = self.embed[tokens].to(dt)
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None, :] \
                .expand(B, S)
        new_caches = []
        for i, blk in enumerate(self.blocks):
            x, kv = blk(x, positions, cfg, mode,
                        caches[i] if mode == "decode" else None, pos)
            new_caches.append(kv)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = torch.einsum("bsd,dv->bsv", x, w.to(dt))
        if mode == "decode":
            return logits, caches
        return logits, (None if mode == "train" else new_caches)


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               dtype: str | torch.dtype | None = None,
               device: str | torch.device | None = None) -> list:
    """Statically shaped serving cache for decode, one dict a layer:
    ``"k"``, ``"v"`` (B, max_len, KH, Dh) in ``dtype`` (default the
    compute dtype), or with ``kv_cache_dtype == "int8"`` int8 payloads
    and f32 scales ``"k_s"``, ``"v_s"`` (B, max_len, KH, 1); all zero.
    Attention layers only: the dense family has no other state. On
    ``device`` (CUDA unless named)."""
    block_pattern(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.compute_dtype
    dt = getattr(torch, dt) if isinstance(dt, str) else dt
    shape = (batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    caches = []
    for _ in range(cfg.n_layers):
        if cfg.kv_cache_dtype == "int8":
            c = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_s": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                    device=device),
                 "v_s": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                    device=device)}
        else:
            c = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
        caches.append(c)
    return caches
