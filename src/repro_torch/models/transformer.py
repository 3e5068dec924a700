"""Dense decoder-only LM as ``nn.Module``s: GQA attention with RoPE and a
SwiGLU MLP per layer, tied or untied head.

Counterpart of the dense-decoder path of ``repro.models.transformer``
(modes "train" and "prefill" share this forward; decode and the other
families are later slices). Dtype policy as in the reference: f32
parameters, activations in ``cfg.compute_dtype`` (bf16 on the card),
f32 norm and softmax statistics, logits over ``padded_vocab``.

As in the reference, the forward runs with the config it is *given*
(``DecoderLM.forward(..., cfg=)``), not only the one the weights were
built with: ``cfg.use_flash_attention`` sends the full-sequence
attention through ``kernels.flash_attention.flash_attention`` (kernel E
on the card) instead of the plain ``layers.gqa_attention``, so one set
of weights serves both settings.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.schema import param_schema


def _params(module: nn.Module, specs: dict, dtype: torch.dtype,
            device: torch.device) -> None:
    for name, spec in specs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(spec.shape, dtype=dtype, device=device),
            requires_grad=False))


class DecoderBlock(nn.Module):
    """One ``attn+mlp`` block: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, cfg: ArchConfig, specs: dict, dtype, device):
        super().__init__()
        self.cfg = cfg
        _params(self, specs, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig | None = None):
        cfg, dt = cfg or self.cfg, x.dtype
        h = layers.rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = torch.einsum("bsd,dhe->bshe", h, self.wq.to(dt))
        k = torch.einsum("bsd,dhe->bshe", h, self.wk.to(dt))
        v = torch.einsum("bsd,dhe->bshe", h, self.wv.to(dt))
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        if cfg.use_flash_attention:
            out = flash_ops.flash_attention(q, k, v, causal=True)
        else:
            out = layers.gqa_attention(q, k, v, causal=True)
        x = x + torch.einsum("bshe,hed->bsd", out, self.wo.to(dt))
        h = layers.rms_norm(x, self.mlp_norm, cfg.norm_eps)
        x = x + layers.swiglu(h, self.w_gate, self.w_up, self.w_down)
        return x, {"k": k, "v": v}


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
                cfg: ArchConfig | None = None):
        """Run with ``cfg`` (default: the config the model was built
        with). It may differ from that config only in
        ``use_flash_attention`` and ``compute_dtype``: any other field
        describes other weights, and raises ``ValueError``."""
        cfg = cfg or self.cfg
        if dataclasses.replace(cfg, use_flash_attention=self.cfg
                               .use_flash_attention,
                               compute_dtype=self.cfg.compute_dtype) \
                != self.cfg:
            raise ValueError(
                f"cfg {cfg.name!r} describes other weights than the "
                f"model's {self.cfg.name!r}: only use_flash_attention and "
                f"compute_dtype may differ")
        dt = getattr(torch, cfg.compute_dtype)
        x = self.embed[tokens].to(dt)
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None, :] \
                .expand(B, S)
        caches = []
        for blk in self.blocks:
            x, kv = blk(x, positions, cfg)
            caches.append(kv)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        return torch.einsum("bsd,dv->bsv", x, w.to(dt)), caches
