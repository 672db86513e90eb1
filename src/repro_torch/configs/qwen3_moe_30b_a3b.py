"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, d_ff_expert=768.  [hf:Qwen/Qwen3-30B-A3B; hf]

head_dim=128 per the HF config (not d_model//num_heads). QK-norm per Qwen3.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                       # = per-expert intermediate
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
