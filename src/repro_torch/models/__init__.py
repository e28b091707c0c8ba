from repro_torch.models.lm import (init_decode_cache, init_lm, lm_apply,
                                   lm_decode_step)
