"""whisper-small [audio] — encoder-decoder backbone (arXiv:2212.04356).
12L encoder + 12L decoder, d_model 768, 12H, d_ff 3072 (GELU MLP with
biases in the encoder), vocab 51865, tied embeddings.

The conv frontend is a stub: a batch carries precomputed frame features
(B, S_frames, 128) in ``audio_embeds``, projected by ``audio_proj``. The
decoder uses RoPE in place of learned positions, as the reference does,
so long decode caches are well defined."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    is_encdec=True, n_enc_layers=12, cross_len=1500,
    tie_embeddings=True, frontend="audio_stub",
)
