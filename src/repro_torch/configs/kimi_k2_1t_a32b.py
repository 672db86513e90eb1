"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8, d_ff_expert=2048.  Trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

The assignment specifies GQA kv=8 (real K2 uses MLA); the assignment config
wins — see DESIGN.md §Arch-applicability. One shared expert per DeepSeek-V3
lineage. head_dim = 7168 // 64 = 112.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                      # = per-expert intermediate
    vocab_size=163840,
    rope_theta=5e4,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, d_ff_shared=2048),
    source="arXiv:2501.kimi2; unverified",
)
