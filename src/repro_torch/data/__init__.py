"""Training data sources (numpy only): synthetic, Markov and memmap token
streams, sliced per host."""
from repro_torch.data.pipeline import (
    DataConfig,
    MarkovLM,
    MemmapTokens,
    SyntheticLM,
    host_slice,
    make_source,
    synthetic_batch,
)

__all__ = ["DataConfig", "MarkovLM", "MemmapTokens", "SyntheticLM",
           "host_slice", "make_source", "synthetic_batch"]
