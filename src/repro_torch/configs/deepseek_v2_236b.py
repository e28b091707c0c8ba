"""DeepSeek-V2 236B — MLA attention + fine-grained MoE.

Assigned spec: 60L d_model=5120 128H (kv=128) d_ff=1536 vocab=102400,
MoE 160 experts top-6, MLA kv_lora=512, 2 shared experts.
[arXiv:2405.04434] — first layer dense (d_ff 12288 in the release; we use
the assigned routed d_ff for all FFNs, shared experts = 2x routed width).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,                  # routed expert width
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_layer_period=1,
    first_k_dense=1,
    mlp_act="swiglu",
    source="arXiv:2405.04434",
)
