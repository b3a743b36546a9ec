"""zamba2-1.2b [hybrid] — 38 Mamba2 layers d_model=2048, ssm_state=64, plus a
SHARED full-attention block (32H MHA, d_ff=8192) applied every 6 SSM layers
with per-site LoRA on its projections. vocab=32000. [arXiv:2411.15242; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    attention="gqa", mlp_type="gelu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    conv_width=4, ssd_chunk=256,
    shared_attn_every=6, shared_attn_lora_rank=128,
    tie_embeddings=True,
    subquadratic=True,   # SSM spine; shared attn sees the same KV cache
)
