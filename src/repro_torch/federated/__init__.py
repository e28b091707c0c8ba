from repro_torch.federated.serving import (AdaptationCache, ServeReport,
                                          ServeRequest, ServingEngine,
                                          TrafficModel, support_digest)
