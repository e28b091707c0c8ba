"""Qwen2-VL 7B — VLM language backbone with M-RoPE.

Assigned spec: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064;
M-RoPE, dynamic resolution. [arXiv:2409.12191]
The ViT vision encoder + projector is a stub: the caller supplies
precomputed patch embeddings (B, n_patches, d_model) as
``modality_embeds`` (the launcher's ``batch["embeds"]``), and
`models/lm._positions` lays them on a (t, h, w) grid for M-RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # t/h/w rotary sections (head_dim/2 = 64)
    rope_theta=1e6,
    modality="vision",
    num_modality_tokens=1024,      # image patches per example
    mlp_act="swiglu",
    source="arXiv:2409.12191",
)
