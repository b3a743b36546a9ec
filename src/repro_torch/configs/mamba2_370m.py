"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128. SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    attention="none", ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, conv_width=4, ssd_chunk=256,
    tie_embeddings=True,
    subquadratic=True,
)
