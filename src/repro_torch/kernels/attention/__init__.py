"""Full-sequence attention (K7). The package keeps the name
``flash_attention`` bound to its K7 module (``from
repro_torch.kernels.attention import flash_attention as k7`` reads its
launch count); the dispatcher is `ops.flash_attention`."""
from repro_torch.kernels.attention.ops import set_default_impl
