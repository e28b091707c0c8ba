from repro_torch.data.federated import (ClientData, FederatedDataset,
                                        TaskBatch, TaskStream,
                                        assemble_task_batch,
                                        sample_task_batch,
                                        stack_task_batches,
                                        support_query_split)
from repro_torch.data.registry import (ClientRegistry,
                                       IndependentClientSource,
                                       RegistryView, SequentialClientSource,
                                       ShardIndexSource, load_shard_registry,
                                       registry_from_body, save_shards)
from repro_torch.data.lm_tasks import make_lm_clients, make_lm_task_batch
from repro_torch.data.synth_femnist import make_femnist
from repro_torch.data.synth_recommend import (localize_clients,
                                              localize_recommend,
                                              make_recommend)
from repro_torch.data.synth_sent140 import make_sent140
from repro_torch.data.synth_shakespeare import make_shakespeare
