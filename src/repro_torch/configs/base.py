"""Model configuration: the port's own copy of the reference's
`ModelConfig`, registry and `reduced_config` (`repro/configs/base.py`).

The registry lists every arch of the reference's. Field names,
defaults and `reduced_config`'s arithmetic are kept identical, so a
reference config and its port counterpart describe the same shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # --- attention ---
    attention: str = "gqa"          # gqa | mla
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window; None = full causal
    rope_theta: float = 1e4
    mrope: bool = False             # multimodal rotary (qwen2-vl)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_layer_period: int = 1       # layer i is MoE iff i % period == period-1
    first_k_dense: int = 0          # leading dense layers (deepseek-v2: 1)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / jamba) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4

    # --- layout ---
    layer_pattern: Tuple[str, ...] = ("attn",)  # repeating kinds per layer
    mlp_act: str = "swiglu"         # swiglu | relu2 | gelu
    tie_embeddings: bool = False

    # --- encoder-decoder (seamless-m4t) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality stub (vlm / audio) ---
    modality: Optional[str] = None  # "vision" | "audio"
    num_modality_tokens: int = 0    # patch/frame embeddings per example

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- distribution variants ---
    moe_impl: str = "tp"            # "tp" (baseline) | "ep" (all-to-all)
    shard_seq: bool = False         # Megatron-style activation seq sharding

    # citation for the exact numbers
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert len(self.layer_pattern) >= 1
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} must be a multiple of "
            f"the layer pattern period {len(self.layer_pattern)}")

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0 or i < self.first_k_dense:
            return False
        return i % self.moe_layer_period == self.moe_layer_period - 1


_ARCH_MODULES = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "smollm-360m": "repro_torch.configs.smollm_360m",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.CONFIG


def list_archs() -> list:
    return sorted(_ARCH_MODULES)


def reduced_config(cfg: ModelConfig, *, seq_friendly: bool = True) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (2 layers, d_model<=512,
    <=4 experts, small vocab), float32."""
    period = len(cfg.layer_pattern)
    layers = period if period > 1 else 2
    d_model = min(cfg.d_model, 256)
    n_heads = max(2, min(cfg.num_heads, 4))
    head_dim = max(16, d_model // n_heads)
    n_kv = max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads else 0
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        first_k_dense=min(cfg.first_k_dense, 1 if layers > 1 else 0),
        kv_lora_rank=min(cfg.kv_lora_rank, 32),
        q_lora_rank=min(cfg.q_lora_rank, 32),
        rope_head_dim=min(cfg.rope_head_dim, 16),
        # keep ssm_heads * ssm_head_dim == ssm_expand * d_model
        ssm_heads=(cfg.ssm_expand * d_model // min(cfg.ssm_head_dim, 32)
                   if cfg.ssm_heads else 0),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=min(cfg.ssm_head_dim, 32) if cfg.ssm_heads else 0,
        ssm_chunk=16 if cfg.ssm_chunk else cfg.ssm_chunk,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        num_modality_tokens=min(cfg.num_modality_tokens, 8),
        sliding_window=(min(cfg.sliding_window, 64)
                        if cfg.sliding_window else cfg.sliding_window),
        mrope_sections=((head_dim // 4, head_dim // 8,
                         head_dim // 2 - head_dim // 4 - head_dim // 8)
                        if cfg.mrope else cfg.mrope_sections),
        dtype="float32",
        name=cfg.name + "-reduced",
    )
    return dataclasses.replace(cfg, **changes)
