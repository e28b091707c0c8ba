"""SmolLM 360M — llama-architecture small dense decoder.

Assigned spec: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M family card]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    mlp_act="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
