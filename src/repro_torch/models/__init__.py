"""Model families (config, layers, serving hooks, registry) and
ResNet-50, the paper's workload."""
from repro_torch.models.config import ModelConfig, reduced_for_smoke
from repro_torch.models.registry import (FAMILIES, get_family, has_decode,
                                         supports_long_context)
