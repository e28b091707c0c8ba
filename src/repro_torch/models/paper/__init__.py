from repro_torch.models.paper.models import Model, femnist_cnn
