from repro_torch.federated.serving import (AdaptationCache, ServeReport,
                                          ServeRequest, ServingEngine,
                                          TrafficModel, support_digest)
from repro_torch.federated.comm import CommTracker
from repro_torch.federated.server import (FederatedTrainer, evaluate_meta,
                                         make_meta_evaluator)
