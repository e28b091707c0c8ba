"""PyTorch/CUDA port of the FedMeta system (`repro`, the JAX reference).

The package mirrors `src/repro/` path for path. It imports torch, numpy
and the standard library, never jax and nothing of `repro`. Entry points
take an explicit ``device`` (default ``"cuda"``); kernels (K1 inner
update, K2 weighted aggregation, K3 fused Adam, K7 flash attention, K8
flash decode) are CUDA C++ under ``kernels/csrc/``, built at first use
into ``build/torch_ext/``.
"""
