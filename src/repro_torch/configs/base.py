"""Architecture configuration schema.

One :class:`ArchConfig` fully determines a model: the registry
(configs/registry.py) maps public arch ids (``--arch jamba-1.5-large-398b``)
to a full config and a reduced smoke config of the same family.
"""
from __future__ import annotations

import dataclasses


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # default d_model // n_heads

    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_every: int = 1           # MoE on layers with index % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    dense_ff: int = 0            # d_ff of the dense MLP on non-MoE layers (hybrid MoE)
    moe_group_size: int = 512    # tokens per dispatch group (einsum mode)
    moe_dispatch: str = "einsum"  # einsum (GShard baseline) | gather (opt)

    # --- hybrid (jamba): attention on every `attn_every`-th layer, rest Mamba
    attn_every: int = 0          # 0 ⇒ all layers are attention
    ssm_state: int = 16          # Mamba N
    ssm_conv: int = 4            # Mamba depthwise conv width
    ssm_expand: int = 2          # d_inner = expand × d_model
    ssm_dt_rank: int = 0         # default ceil(d_model/16)

    # --- xLSTM ---
    xlstm: bool = False
    slstm_every: int = 8         # one sLSTM block every k layers (rest mLSTM)
    xlstm_chunk: int = 128       # chunkwise-parallel mLSTM chunk length

    # --- encoder-decoder (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    cross_len: int = 1500        # encoder frames attended to while decoding

    # --- VLM (qwen2-vl) ---
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)

    # --- common ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qkv_bias: bool = False       # qwen2 uses QKV biases
    subquadratic: bool = False   # eligible for long_500k
    frontend: str = "none"       # none | audio_stub | vision_stub

    # --- runtime policy ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    kv_cache_dtype: str = "compute"   # compute (bf16) | int8 (quantized)
    use_flash_attention: bool = False  # prefill attention via kernel E

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank",
                               ceil_to(self.d_model, 16) // 16)
        assert self.n_heads % self.n_kv_heads == 0

    # ------------------------------------------------------------- derived
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so TP-16 embedding sharding always divides."""
        return ceil_to(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def is_attn_layer(self, i: int) -> bool:
        if self.attn_every == 0:
            return True
        return i % self.attn_every == 0

    def is_moe_layer(self, i: int) -> bool:
        if self.moe_experts == 0:
            return False
        return i % self.moe_every == self.moe_offset

    # Parameter counts are computed from the actual parameter schema
    # (models/schema.py: param_count / active_param_count) so the numbers
    # can never drift from the implementation.
