"""Config dataclasses for the model zoo, shapes, and runtime.

The port's own copy of the JAX package's ``configs/base.py`` (that module
imports no JAX, but the port imports nothing of the JAX package).  The
dataclasses are plain frozen data, field for field the same, so a config
built here prints, hashes and diffs like its twin; ``padded_vocab`` and
the ``head_dim`` / ``block_defs`` derivation are kept exactly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# --------------------------------------------------------------------------
# sub-configs
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int              # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    # second-hop (per-expert buffer) headroom on top of the dispatch
    # capacity; 1.0 = no extra padding (hillclimb lever, §Perf cell 2)
    local_capacity_factor: float = 1.25
    # "none" | "int8": quantize the dispatch all-to-all payload (per-slot
    # scales, straight-through bwd also int8) — DeepSeek fp8-dispatch
    # analogue; combine stays bf16
    dispatch_quant: str = "none"
    router_jitter: float = 0.0
    num_shared_experts: int = 0   # kimi-style shared expert(s)
    d_ff_shared: int = 0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    # period-8 pattern, mLSTM:sLSTM = 7:1 (xLSTM[7:1])
    mlstm_per_block: int = 7
    slstm_per_block: int = 1
    proj_factor_mlstm: float = 2.0   # up-projection inside mLSTM block
    proj_factor_slstm: float = 4.0 / 3.0
    conv1d_kernel: int = 4


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a STUB:
    input_specs() supplies precomputed frame embeddings (B, n_frames, d)."""
    num_layers: int
    n_frames: int = 1500          # whisper: 30 s audio -> 1500 frames post-conv
    d_model: int = 0              # 0 -> same as decoder d_model
    num_heads: int = 0            # 0 -> same as decoder


@dataclass(frozen=True)
class FrontendConfig:
    """Vision frontend stub for VLMs. input_specs() supplies patch embeds."""
    num_patches: int = 256
    d_frontend: int = 0           # 0 -> d_model (pre-projected stub)


# --------------------------------------------------------------------------
# block pattern
# --------------------------------------------------------------------------
# A model is `n_super` repetitions (lax.scan) of a "super-block": an ordered
# tuple of (mixer, ffn) sub-blocks. Uniform models have a 1-layer super-block.
#   mixer in {"attn", "mamba", "mlstm", "slstm"}
#   ffn   in {"dense", "moe", "none"}
BlockDef = Tuple[str, str]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # block pattern (derived in __post_init__ when empty)
    block_defs: Tuple[BlockDef, ...] = ()
    # ffn / norm flavor
    ffn_type: str = "swiglu"      # swiglu | squared_relu | gelu
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    qk_norm: bool = False
    # position encoding
    pos_embedding: str = "rope"   # rope | learned | sinusoidal | none
    rope_theta: float = 10000.0
    max_position: int = 1 << 20
    # attention flavor
    attention_type: str = "gqa"   # gqa | mla
    mla: Optional[MLAConfig] = None
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # hybrid / ssm
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec / vlm frontends
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    # embedding
    tie_embeddings: bool = False
    # citation tag from the assignment table
    source: str = ""

    # ---- derived -----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_defs:
            ffn = "moe" if (self.moe is not None and self.family == "moe") else "dense"
            object.__setattr__(self, "block_defs", (("attn", ffn),))

    @property
    def n_super(self) -> int:
        n, r = divmod(self.num_layers, len(self.block_defs))
        if r:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"super-block size {len(self.block_defs)}")
        return n

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch has a sub-quadratic path (SSM/hybrid/linear-attn),
        i.e. long_500k applies."""
        return any(m in ("mamba", "mlstm", "slstm") for m, _ in self.block_defs)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def padded_vocab(self, multiple: int = 2048) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    grad_accum: int = 1           # training only: microbatch accumulation

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4096,   256, "train", grad_accum=8),
    "prefill_32k": ShapeConfig("prefill_32k", 32768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524288, 1,   "decode"),
}


# --------------------------------------------------------------------------
# runtime / training config
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    # precision
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"       # master copy dtype held by optimizer
    # optimizer
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    # memory policy
    remat: bool = True
    remat_policy: str = "dots"         # none | dots | full
    # distribution extras
    grad_compression: str = "none"     # none | int8  (cross-pod reduction)
    # attention impl: "reference" (chunked) | "pallas" (the flash kernel,
    # the name kept from the JAX package; here the CUDA kernel)
    attention_impl: str = "reference"
    attention_q_chunk: int = 1024

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
