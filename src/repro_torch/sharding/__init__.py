from repro_torch.sharding.rules import (DATA_AXIS, MODEL_AXIS, POD_AXIS, P,
                                        batch_pspec, cache_pspecs,
                                        param_pspecs, placements,
                                        state_pspecs)
