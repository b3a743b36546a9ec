"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000. llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    attention="gqa", sliding_window=4096, mlp_type="swiglu",
    tie_embeddings=False,
    subquadratic=True,   # SWA decode cost is O(window), eligible for long_500k
)
