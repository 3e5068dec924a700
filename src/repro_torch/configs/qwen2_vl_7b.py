"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).
28L, d_model 3584, 28H (GQA kv=4, head_dim 128), d_ff 18944, vocab
152064, QKV biases, rope theta 1e6.

The vision tower is a stub: a batch carries precomputed patch embeddings
(B, S_img, 1280) in ``image_embeds``, projected by ``vision_proj`` and put
before the tokens; the M-RoPE position ids (3, B, S) come with the batch
in ``mrope_positions``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    mrope=True, mrope_sections=(16, 24, 24), qkv_bias=True,
    frontend="vision_stub", rope_theta=1e6,
)
