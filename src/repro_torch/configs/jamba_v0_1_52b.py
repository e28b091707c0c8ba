"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave with MoE.

Assigned spec: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2. [arXiv:2403.19887] — Jamba places one attention
layer per 8-layer block (1:7 attn:mamba ratio) and applies MoE every
other layer (16 experts, top-2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_layer_period=2,
    # one attention layer per 8 (position 4 of each block, as in the paper)
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ssm_state=128,
    ssm_heads=128,          # d_inner(8192) / ssm_head_dim(64)
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    conv_width=4,
    mlp_act="swiglu",
    source="arXiv:2403.19887",
)
