"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 (expert width)
vocab=102400. MLA kv_lora=512 (rope 64 / nope 128 / v 128, q_lora 1536),
2 shared + 160 routed experts top-6, first layer dense. [arXiv:2405.04434; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288,                      # dense first-layer FFN width (v2 paper)
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    moe=True, num_experts=160, top_k=6, num_shared_experts=2,
    moe_d_ff=1536,                   # assigned d_ff = expert width
    capacity_factor=1.25, first_dense_layers=1,
    tie_embeddings=False,
)
