"""Roofline terms per (arch x shape x mesh) from the port's dry run.

The port's copy of the JAX package's ``analysis/roofline.py``: the
accounting below is that module's, function for function; only the
hardware model differs.  Hardware model: one NVIDIA H100 SXM per rank.

Three terms, all in seconds PER STEP, per device (each rank runs its own
step, so per-device quantities divide by per-card rates):

  compute    = dot_flops_per_device / PEAK_FLOPS
  memory     = hbm_bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / ICI_BW

dot FLOPs and collective bytes come from the dispatcher, not from HLO:
``analysis/counters.py`` counts the matrix products and the collectives
a rank dispatches while its step runs (on fake tensors in the dry run).
HBM traffic is analytic (see `hbm_bytes`): weights + optimizer/cache state
+ boundary activations -- the irreducible traffic a perfect fusion would
still pay.

MODEL_FLOPS uses 6*N*D (dense) / 6*N_active*D (MoE) over the step's tokens,
and the ratio MODEL_FLOPS / dot FLOPs exposes remat/redundancy waste.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (no sparsity),
# at the card's full 700 W power limit
PEAK_FLOPS = 989.4e12        # bf16 FLOP/s per card
# the same data sheet: 80 GB of HBM3 at 3.35 TB/s
HBM_BW = 3.35e12             # bytes/s per card
# collective bandwidth per card across a 256-card mesh: one 400 Gb/s NDR
# InfiniBand link per GPU (ConnectX-7, DGX H100 reference design), 50 GB/s
# a direction.  NVLink's 450 GB/s a direction (900 GB/s both ways) holds
# only inside an 8-GPU node, which a 16 x 16 mesh leaves on most of its
# collectives' hops
ICI_BW = 50e9                # bytes/s per card


# --------------------------------------------------------------------------
# analytic parameter / activation accounting
# --------------------------------------------------------------------------

def count_params(cfg):
    """Total and active (per-token) params, from the ModelConfig alone."""
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Vp = cfg.padded_vocab()
    total = active = 0

    def attn_params():
        if cfg.attention_type == "mla":
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (D * m.q_lora_rank + m.q_lora_rank * H * qk
                    + D * m.kv_lora_rank + D * m.qk_rope_head_dim
                    + m.kv_lora_rank * H * (m.qk_nope_head_dim
                                            + m.v_head_dim)
                    + H * m.v_head_dim * D)
        return D * Dh * (H + 2 * Hkv) + H * Dh * D

    def ffn_params(dff):
        mult = 3 if cfg.ffn_type == "swiglu" else 2
        return mult * D * dff

    def mamba_params():
        di = cfg.mamba.expand * D
        R = cfg.mamba.dt_rank or -(-D // 16)
        N = cfg.mamba.d_state
        return (D * 2 * di + cfg.mamba.d_conv * di + di * (R + 2 * N)
                + R * di + di * N + di + di * D)

    def mlstm_params():
        di = int(D * cfg.xlstm.proj_factor_mlstm)
        return D * 2 * di + 3 * di * di + di * 2 * cfg.num_heads + di * D

    def slstm_params():
        dh = D // cfg.num_heads
        dff = int(D * cfg.xlstm.proj_factor_slstm)
        return 4 * (D * D + cfg.num_heads * dh * dh) + 3 * D * dff

    for mixer, ffn in cfg.block_defs:
        t = a = 0
        if mixer == "attn":
            t = a = attn_params()
        elif mixer == "mamba":
            t = a = mamba_params()
        elif mixer == "mlstm":
            t = a = mlstm_params()
        elif mixer == "slstm":
            t = a = slstm_params()
        if ffn == "dense":
            f = ffn_params(cfg.d_ff)
            t, a = t + f, a + f
        elif ffn == "moe":
            moe = cfg.moe
            per_exp = ffn_params(moe.d_ff_expert)
            t += moe.num_experts * per_exp + D * moe.num_experts
            a += moe.top_k * per_exp
            if moe.num_shared_experts:
                s = ffn_params(moe.d_ff_shared * moe.num_shared_experts)
                t, a = t + s, a + s
        total += t * cfg.n_super
        active += a * cfg.n_super

    emb = Vp * D * (1 if cfg.tie_embeddings else 2)
    if cfg.pos_embedding == "learned":
        emb += min(cfg.max_position, 65536) * D
    total += emb
    active += emb
    if cfg.is_encdec:
        enc = cfg.encoder
        per = D * Dh * (H + 2 * Hkv) + H * Dh * D + ffn_params(cfg.d_ff)
        # decoder cross-attention already counted? no — add it:
        cross = (D * Dh * (H + 2 * Hkv) + H * Dh * D) * cfg.num_layers
        total += per * enc.num_layers + cross
        active += per * enc.num_layers + cross
    return total, active


def model_flops(cfg, shape):
    """6*N_active*tokens for training; 2*N_active*tokens for inference fwd;
    decode: one token per sequence."""
    _, n_active = count_params(cfg)
    if shape.kind == "train":
        return 6 * n_active * shape.tokens_per_step
    if shape.kind == "prefill":
        return 2 * n_active * shape.tokens_per_step
    return 2 * n_active * shape.global_batch          # decode: 1 tok/seq


def state_bytes(cfg, shape, n_chips, bytes_per_param_train=18.0,
                bytes_per_param_serve=2.0):
    """Sharded per-device resident state: params(+opt) or params(+cache)."""
    total, _ = count_params(cfg)
    if shape.kind == "train":
        return total * bytes_per_param_train / n_chips
    cache = cache_bytes(cfg, shape)
    return (total * bytes_per_param_serve + cache) / n_chips


def cache_bytes(cfg, shape, dtype_bytes=2):
    """Global KV/state cache bytes for a decode/prefill shape."""
    B, S = shape.global_batch, shape.seq_len
    per_layer = 0
    for mixer, _ in cfg.block_defs:
        if mixer == "attn":
            if cfg.attention_type == "mla":
                m = cfg.mla
                per_layer += B * S * (m.kv_lora_rank + m.qk_rope_head_dim)
            else:
                per_layer += 2 * B * S * cfg.num_kv_heads * cfg.head_dim
        elif mixer == "mamba":
            di = cfg.mamba.expand * cfg.d_model
            per_layer += B * di * (cfg.mamba.d_state * 2 + cfg.mamba.d_conv)
        elif mixer in ("mlstm", "slstm"):
            di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
            dh = di // cfg.num_heads
            per_layer += B * cfg.num_heads * (dh * dh + 2 * dh) * 2
    return per_layer * cfg.n_super * dtype_bytes


def hbm_bytes(cfg, shape, n_chips):
    """Analytic irreducible HBM traffic per device per step (bytes).

    train:   read params(bf16) + write grads(f32) + r/w opt moments+master
             + boundary activations (saved layer inputs, bf16, x2 for
             fwd-write/bwd-read) per microbatch
    prefill: read params + write cache + boundary activations
    decode:  read params(active experts only for MoE) + read full cache
             + write one cache slot
    """
    total, active = count_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    if shape.kind == "train":
        opt = total * (2 + 4 + 4 + 4 + 4)      # p.bf16,g.f32,mu,nu,master
        act = 2 * (B * S * D * 2) * cfg.num_layers * 2   # save+reload, bf16
        return (opt + act) / n_chips
    if shape.kind == "prefill":
        return (total * 2 + cache_bytes(cfg, shape)
                + 2 * B * S * D * 2 * cfg.num_layers) / n_chips
    # decode: weights actually touched + full cache read + tiny write.
    # MoE: each of B tokens touches ~N_active params, different tokens hit
    # different experts -> touched ~ min(total, B * N_active).
    touched = min(total, active * max(1, B)) if cfg.moe is not None else total
    return (touched * 2 + cache_bytes(cfg, shape)) / n_chips


# --------------------------------------------------------------------------
# terms
# --------------------------------------------------------------------------

@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_device: float
    useful_ratio: float
    bottleneck: str

    def to_dict(self):
        return dict(compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s,
                    model_flops=self.model_flops,
                    hlo_flops_device=self.hlo_flops_device,
                    useful_ratio=self.useful_ratio,
                    bottleneck=self.bottleneck)


def compute_roofline(cfg, shape, n_chips, dot_flops_device,
                     collective_bytes_device):
    mf = model_flops(cfg, shape)
    hbm = hbm_bytes(cfg, shape, n_chips)
    compute_s = dot_flops_device / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    coll_s = collective_bytes_device / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    useful = mf / max(dot_flops_device * n_chips, 1)
    return Roofline(compute_s, memory_s, coll_s, mf,
                    dot_flops_device, useful, bottleneck)
