"""Architecture config schema + registry: the port's own copy.

Every assigned architecture is one frozen ``ArchConfig`` in its own module
(``src/repro_torch/configs/<id>.py``), selectable via ``--arch <id>`` in the
entry points. ``reduced()`` derives the CPU smoke-test config of the same
family.  The schema, the ten configs and ``reduced()`` are the JAX
package's, field for field (``tests/test_torch_configs.py``); the port
keeps a copy because it imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | encdec-audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention
    attention: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    mlp_type: str = "swiglu"         # swiglu | gelu

    # MLA (DeepSeek)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert ffn width
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # deepseek: leading dense layers

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256
    # beyond-paper perf knob: separate z/x/B/C/dt projections instead of one
    # fused in_proj whose TP-sharded output must be sliced (slicing a sharded
    # dim inserts halo collective-permutes; see EXPERIMENTS.md §Perf)
    ssm_split_proj: bool = False
    # keep SSD B/C/x tensors in bf16 (decay/dt stay fp32); §Perf iteration A6
    ssd_bf16: bool = False

    # hybrid (Zamba2)
    shared_attn_every: int = 0       # apply shared attn block every k ssm layers
    shared_attn_lora_rank: int = 0

    # enc-dec
    encoder_layers: int = 0

    # modality frontend stub
    input_mode: str = "tokens"       # tokens | embeddings
    frontend_dim: int = 0            # embedding input width (0 -> d_model)

    # embeddings / output
    tie_embeddings: bool = True
    embed_grad: str = "segment"      # the paper's technique: segment | scatter

    # numerics / training
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    schedule: str = "cosine"         # cosine | wsd (MiniCPM)

    # dry-run eligibility
    subquadratic: bool = False       # eligible for long_500k decode

    # remat policy for train_step (perf knob, see EXPERIMENTS §Perf)
    remat_policy: str = "nothing_saveable"  # nothing_saveable | dots_saveable

    # unroll layer scans in the lowered HLO: XLA's cost analysis counts a
    # while-loop body ONCE, so the dry-run unrolls for exact flops/collective
    # accounting (trainers keep scan=rolled for compile time)
    unroll_layers: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.num_heads))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def padded_vocab(self) -> int:
        """Embedding/LM-head rows padded to a multiple of 256 so the vocab dim
        shards evenly over the model axis (Megatron-style padding; labels are
        always < vocab_size so padding rows receive zero gradient signal)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // max(1, self.num_heads))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.attention == "mla":
            kw.update(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=16,
                      nope_head_dim=32, v_head_dim=32, head_dim=0)
        if self.moe:
            kw.update(num_experts=4, top_k=2, moe_d_ff=64,
                      num_shared_experts=min(1, self.num_shared_experts),
                      first_dense_layers=min(1, self.first_dense_layers))
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=32, ssd_chunk=16)
        if self.shared_attn_every:
            kw.update(num_layers=4, shared_attn_every=2,
                      shared_attn_lora_rank=8)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        if self.sliding_window:
            kw.update(sliding_window=32)
        if self.frontend_dim:
            kw.update(frontend_dim=64)
        return ArchConfig(**kw)


ASSIGNED = [
    "stablelm_12b", "qwen2_5_14b", "minicpm_2b", "h2o_danube_3_4b",
    "mamba2_370m", "internvl2_2b", "seamless_m4t_large_v2", "zamba2_1_2b",
    "dbrx_132b", "deepseek_v2_236b",
]

_ALIASES = {
    "stablelm-12b": "stablelm_12b",
    "qwen2.5-14b": "qwen2_5_14b",
    "minicpm-2b": "minicpm_2b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "mamba2-370m": "mamba2_370m",
    "internvl2-2b": "internvl2_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "zamba2-1.2b": "zamba2_1_2b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {n: get_config(n) for n in ASSIGNED}
