from repro_torch.core.algorithms import (FOMAML, MAML, MetaAlgorithm, MetaSGD,
                                        Reptile, make_algorithm)
from repro_torch.core.losses import accuracy, lm_loss, softmax_xent
