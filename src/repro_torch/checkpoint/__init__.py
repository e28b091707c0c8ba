from repro_torch.checkpoint.io import (latest_step, load_pytree,
                                       load_server_state, save_pytree,
                                       save_server_state)
