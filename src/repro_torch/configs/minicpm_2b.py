"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760
vocab=122753. WSD schedule, llama-like. [arXiv:2404.06395; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    attention="gqa", mlp_type="swiglu",
    schedule="wsd", tie_embeddings=True,
)
