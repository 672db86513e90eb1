"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.
[hf:openbmb/MiniCPM3-4B; hf]

MLA dims per the HF config: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32,
v_head=64. The KV cache stores the compressed latent (c_kv + k_rope), which
is the MLA decode-memory win visible in the decode roofline.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,                    # qk_nope (64) + qk_rope (32)
    d_ff=6400,
    vocab_size=73448,
    attention_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B; hf",
)
