"""dbrx-132b [moe] — 16 experts top-4, fine-grained
(hf:databricks/dbrx-base). 40L, d_model 6144, 48H (GQA kv=8, head_dim
128), d_ff 10752, vocab 100352, untied head."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    moe_experts=16, moe_topk=4,
)
