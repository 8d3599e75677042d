"""Training data sources (numpy only): synthetic, Markov and memmap token
streams, sliced per host, and the vlm's and encoder's batches."""
from repro_torch.data.pipeline import (
    DataConfig,
    MarkovLM,
    MemmapTokens,
    SyntheticFrames,
    SyntheticLM,
    WithPatches,
    host_slice,
    make_source,
    synthetic_batch,
)

__all__ = ["DataConfig", "MarkovLM", "MemmapTokens", "SyntheticFrames",
           "SyntheticLM", "WithPatches", "host_slice", "make_source",
           "synthetic_batch"]
