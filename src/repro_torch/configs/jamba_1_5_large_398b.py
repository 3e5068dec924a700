"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE
16 experts top-2 on every other layer (the 398B total / ~98B active of
arXiv:2403.19887 / 2408.12570).

72L, d_model 8192, 64H (GQA kv=8), d_ff 24576, vocab 65536. Layer i is
attention iff i % 8 == 0 (9 attention, 63 Mamba); MoE iff i % 2 == 1
(36 MoE layers), a dense MLP otherwise. Sub-quadratic (Mamba-dominated).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, dense_ff=24576, vocab=65536,
    moe_experts=16, moe_topk=2, moe_every=2, moe_offset=1,
    attn_every=8, ssm_state=16, ssm_expand=2,
    subquadratic=True,
)
