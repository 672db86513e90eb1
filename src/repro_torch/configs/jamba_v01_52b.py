"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2. Mamba:attn = 7:1 interleave, MoE every
other layer.  [arXiv:2403.19887; hf]

Period-8 super-block (Jamba paper Fig. 2): layers {0..7} are mamba except
layer 4 which is attention; odd layers carry MoE FFN, even layers dense FFN.
32L = 4 super-blocks.
"""
from repro_torch.configs.base import MambaConfig, MoEConfig, ModelConfig

_PERIOD8 = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    block_defs=_PERIOD8,
    pos_embedding="none",           # Jamba uses no explicit positional encoding
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887; hf",
)
