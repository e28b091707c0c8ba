from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                     reduced_config)
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape
