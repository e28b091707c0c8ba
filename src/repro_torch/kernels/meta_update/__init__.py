from repro_torch.kernels.meta_update.ops import (get_default_impl,
                                                 inner_update, meta_update,
                                                 set_default_impl,
                                                 weighted_aggregate)
