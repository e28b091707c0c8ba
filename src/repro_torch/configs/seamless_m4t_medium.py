"""SeamlessM4T-medium — encoder-decoder multimodal (audio) backbone.

Assigned spec: 12L d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096
vocab=256206; enc-dec, multimodal. [arXiv:2308.11596]
Interpreted as 12 encoder + 12 decoder layers (the M4T-medium text
backbone). The speech frontend (mel + conformer feature extractor) is a
stub: the caller supplies precomputed frame embeddings of shape
(B, T_frames, d_model) as ``modality_embeds`` (the launcher's
``batch["embeds"]``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,             # decoder layers
    num_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    modality="audio",
    num_modality_tokens=1024,  # audio frames consumed by the encoder
    mlp_act="gelu",
    source="arXiv:2308.11596",
)
