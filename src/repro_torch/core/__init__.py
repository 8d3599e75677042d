"""Host-side UniMem page pool and the quantized-page contract; the
paper's analytic chip models (datapath, hwmodel, projection, simulator)."""
from repro_torch.core.hwmodel import (SUNRISE, CHIP_A, CHIP_B, CHIP_C,
                                     TPU_V5E, H100)
from repro_torch.core.unimem import UniMemPool, SequencePageTable, UniMemOOM
