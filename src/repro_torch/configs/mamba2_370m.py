"""Mamba2 370M — attention-free SSM with SSD (state-space duality).

Assigned spec: 48L d_model=1024 (attn-free) d_ff=0 vocab=50280,
ssm_state=128. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                  # no MLP: mamba2 blocks only (as per spec)
    vocab_size=50280,
    layer_pattern=("mamba",),
    ssm_state=128,
    ssm_heads=32,            # d_inner(2048) / ssm_head_dim(64)
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    conv_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
