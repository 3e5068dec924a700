"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517). 24L,
d_model 1024, 4 heads, no FFN (the blocks carry their own projections),
vocab 50304. One sLSTM every 8 blocks, the rest mLSTM with projection
factor 2 (the chunkwise-parallel form in training and prefill).
Recurrent, constant-size state: sub-quadratic."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    xlstm=True, slstm_every=8, ssm_expand=2, xlstm_chunk=128,
    subquadratic=True,
)
