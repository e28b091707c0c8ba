from repro_torch.data.federated import (ClientData, FederatedDataset,
                                        TaskBatch, TaskStream,
                                        sample_task_batch,
                                        stack_task_batches,
                                        support_query_split)
from repro_torch.data.synth_femnist import make_femnist
