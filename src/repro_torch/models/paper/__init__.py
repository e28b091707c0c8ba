from repro_torch.models.paper.models import (Model, char_lstm, femnist_cnn,
                                             rec_lr, rec_nn, sent_lstm)
