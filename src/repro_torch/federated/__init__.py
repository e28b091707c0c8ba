from repro_torch.federated.async_engine import (AsyncRoundEngine,
                                                PrefetchError, Prefetcher,
                                                StalenessConfig, WorkerPool,
                                                WorkerPoolError,
                                                call_with_retry)
from repro_torch.federated.serving import (AdaptationCache, ServeReport,
                                          ServeRequest, ServingEngine,
                                          TrafficModel, support_digest)
from repro_torch.federated.comm import CommTracker
from repro_torch.federated.fedavg import FedAvgTrainer
from repro_torch.federated.privacy import (DPConfig, clip_gradient,
                                          dp_aggregate, dp_clip_factors)
from repro_torch.federated.server import (FederatedTrainer, evaluate_global,
                                         evaluate_meta,
                                         make_global_evaluator,
                                         make_meta_evaluator)
