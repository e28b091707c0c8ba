from repro_torch.kernels.ssd.ops import ssd_chunked
