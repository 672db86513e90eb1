"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000. Pruned nemotron (same family: squared-ReLU, layernorm).
[arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    ffn_type="squared_relu",
    norm_type="layernorm",
    source="arXiv:2407.14679; hf",
)
