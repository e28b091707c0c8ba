from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          clip_by_global_norm,
                                          make_flat_optimizer, sgd)
