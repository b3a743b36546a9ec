"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206. Speech frontend is a STUB per the assignment:
input_specs() feeds precomputed frame embeddings to the encoder.
[arXiv:2308.11596; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec-audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    attention="gqa", mlp_type="gelu",
    encoder_layers=24,
    input_mode="embeddings", frontend_dim=1024,   # speech frame embed width
    tie_embeddings=True,
)
