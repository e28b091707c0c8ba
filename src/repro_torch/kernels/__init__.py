"""The port's CUDA kernels, each beside its plain-PyTorch version:

  K1  meta_update/fused.py             inner_update_plane (csrc/inner_update.cu)
  K2  meta_update/aggregate.py         weighted_aggregate_flat (csrc/aggregate.cu)
  K3  optim/fused_adam.py              adam_flat_pallas (csrc/adam.cu)
  K7  attention/flash_attention.py     flash_attention_bhld (csrc/flash_attention.cu)
  K8  decode_attention/flash_decode.py flash_decode (csrc/flash_decode.cu)

Each wrapper keeps a module-level ``launches`` count, raised by one
where it launches its kernel and nowhere else.
"""
