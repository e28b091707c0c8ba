"""The port's CUDA kernels, each beside its plain-PyTorch version:

  K1  meta_update/fused.py             inner_update_plane (csrc/inner_update.cu)
  K2  meta_update/aggregate.py         weighted_aggregate_flat (csrc/aggregate.cu)
  K3  optim/fused_adam.py              adam_flat_pallas (csrc/adam.cu)
  K4  meta_update/fused.py             meta_update_flat (csrc/inner_update.cu, C = 1)
  K5  meta_update/aggregate.py         trimmed_mean_flat (csrc/trimmed_mean.cu)
  K6  meta_update/compress.py          int8_encode_flat (csrc/int8_encode.cu)
  K7  attention/flash_attention.py     flash_attention_bhld (csrc/flash_attention.cu)
  K8  decode_attention/flash_decode.py flash_decode (csrc/flash_decode.cu)
  K9  ssd/ssd_scan.py                  ssd_intra_chunk (csrc/ssd_chunk.cu)

Each wrapper keeps a module-level ``launches`` count (K4's is
``fused.meta_update_launches``, K5's ``aggregate.trimmed_launches``),
raised by one where it launches its kernel and nowhere else.
"""
