"""Weight- and output-stationary matmul (kernel wrappers and plain version)."""
from repro_torch.kernels.ws_matmul.ops import ws_matmul, os_matmul
