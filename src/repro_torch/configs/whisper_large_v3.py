"""whisper-large-v3 [audio]: enc-dec, conv frontend (stub).

32L (enc) + 32L (dec), d_model=1280, 20 heads (GQA kv=20 == MHA),
d_ff=5120, vocab=51866.  [arXiv:2212.04356; unverified]

The mel/conv frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (B, 1500, 1280).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    ffn_type="gelu",
    norm_type="layernorm",
    pos_embedding="learned",
    encoder=EncoderConfig(num_layers=32, n_frames=1500),
    source="arXiv:2212.04356; unverified",
)
