"""Architecture registry of the port: ``get_config`` / ``get_reduced``,
the shapes (``get_shape``) and the (arch x shape) ``cells``.

The registry holds the JAX package's ten architectures, in its order;
``get_reduced`` shrinks a config exactly as the JAX package's
``configs.get_reduced`` does, so the two packages build the same reduced
model for the parity tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (BlockDef, EncoderConfig,  # noqa: F401
                                      FrontendConfig, MLAConfig, MambaConfig,
                                      MoEConfig, ModelConfig, RunConfig,
                                      SHAPES, ShapeConfig, XLSTMConfig)
from repro_torch.configs import (whisper_large_v3, qwen3_moe_30b_a3b,
                                 kimi_k2_1t_a32b, minicpm3_4b, yi_9b,
                                 nemotron_4_15b, minitron_8b, jamba_v01_52b,
                                 internvl2_2b, xlstm_350m)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (whisper_large_v3, qwen3_moe_30b_a3b, kimi_k2_1t_a32b,
              minicpm3_4b, yi_9b, nemotron_4_15b, minitron_8b,
              jamba_v01_52b, internvl2_2b, xlstm_350m)
}

ARCH_IDS = tuple(ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skipped: bool = True):
    """All 40 (arch, shape) cells. Yields (arch_id, shape_name, skipped:bool).

    long_500k is skipped for pure full-attention archs (sub-quadratic path
    required); whisper decode shapes run (enc-dec has a decoder)."""
    for a, cfg in ARCHS.items():
        for s in SHAPES:
            skip = (s == "long_500k" and not cfg.is_subquadratic)
            if skip and not include_skipped:
                continue
            yield a, s, skip


def get_reduced(arch: str) -> ModelConfig:
    """Tiny config of the same family/pattern for CPU smoke tests."""
    cfg = get_config(arch)
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=len(cfg.block_defs),          # one super-block
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        max_position=4096,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=32,
            d_ff_shared=32 if cfg.moe.num_shared_experts else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=8, qk_rope_head_dim=8,
                              v_head_dim=8)
        kw["head_dim"] = 16
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, num_layers=2, n_frames=16)
    if cfg.frontend is not None:
        kw["frontend"] = dataclasses.replace(cfg.frontend, num_patches=8)
    return dataclasses.replace(cfg, **kw)


REDUCED_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
