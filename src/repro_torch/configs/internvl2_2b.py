"""internvl2-2b [vlm]: InternLM2 backbone, 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553. InternViT frontend is a STUB per the assignment:
``input_specs()`` supplies 256 pre-projected patch embeddings prepended to
the token stream.  [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend=FrontendConfig(num_patches=256),
    source="arXiv:2404.16821; hf",
)
