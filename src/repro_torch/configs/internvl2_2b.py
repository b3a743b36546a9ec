"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
InternViT vision frontend is a STUB per the assignment: input_specs() feeds
precomputed patch embeddings. Backbone = InternLM2-like dense LM.
[arXiv:2404.16821; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    attention="gqa", mlp_type="swiglu",
    input_mode="embeddings", frontend_dim=1024,   # InternViT patch embed width
    tie_embeddings=False,
)
