"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064. GQA + QKV bias. [hf:Qwen/Qwen2.5 family; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064,
    attention="gqa", qkv_bias=True, mlp_type="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=False,
)
