"""Whisper-style encoder-decoder backbone.

Counterpart of ``repro.models.encdec``. The audio conv frontend is a
stub: ``audio_embeds`` carries precomputed frame features (B, S_frames,
128), projected into d_model by ``audio_proj``. The encoder is a
bidirectional transformer (``transformer.EncoderBlock``: RMS-normed
non-causal self-attention with RoPE, then a layer-normed GELU MLP) on
sinusoidal positions, closed by an RMS norm; the decoder is the shared
decoder stack with cross attention (RoPE self-attention, as the
reference, so long decode caches are well defined).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.sharding_api import NO_SHARD, ShardPolicy


def sinusoidal_positions(S: int, d: int, dtype: torch.dtype,
                         device: torch.device | None = None) -> torch.Tensor:
    """(S, d): sin of pos / 10000^(2i/d) in the first half, cos in the
    second."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe[:, :d].to(dtype)


def encode(cfg: ArchConfig, params, audio_embeds: torch.Tensor,
           shard: ShardPolicy = NO_SHARD) -> torch.Tensor:
    """audio_embeds: (B, S_enc, 128) stub frame features → (B, S_enc, D),
    in the compute dtype. With ``cfg.use_flash_attention`` every encoder
    layer's attention is kernel E, non-causal."""
    dt = getattr(torch, cfg.compute_dtype)
    x = torch.einsum("bse,ed->bsd", audio_embeds.to(dt),
                     params.audio_proj.to(dt))
    B, S = x.shape[:2]
    x = x + sinusoidal_positions(S, cfg.d_model, dt, x.device)[None]
    x = shard(x, ("batch", "seq", "embed"))
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for blk in params.enc_blocks:
        x = blk(x, positions, cfg, shard)
    return layers.rms_norm(x, params.enc_final_norm, cfg.norm_eps)


def encdec_forward(cfg: ArchConfig, params, batch: dict, *,
                   mode: str = "train", caches: list | None = None,
                   pos: int = 0, shard: ShardPolicy = NO_SHARD):
    """The whole encoder-decoder forward: (logits, caches, aux). In
    "decode" the encoder output already sits in the cross-attention
    cache, so the encoder is skipped."""
    cfg = params.check_cfg(cfg)
    cross_src = None
    if mode != "decode":
        cross_src = encode(cfg, params, batch["audio_embeds"], shard)
    return params.run(batch["tokens"], batch.get("positions"), cfg, mode,
                      caches, pos, cross_src=cross_src, shard=shard)
