"""repro_torch — the PyTorch/CUDA port of the `repro` serving system.

The JAX package `repro` is the reference; this package mirrors its
module paths and names (`repro_torch.models.transformer` is the
counterpart of `repro.models.transformer`, and so on), serves the
dense, MoE, hybrid, SSM and vlm families and trains those and the
encoder on one NVIDIA H100, and carries the
paper side (the analytic chip models, ResNet-50 and the dataflow
ablation, `benchmarks/`).  Its kernels are hand-written CUDA C++ for
`sm_90a` (`kernels/csrc/`), built at first use with `nvcc` and bound
through `ctypes`.

The port never imports `jax` or anything of `repro`: what it needs of
the reference's pure-Python modules is copied here.  Entry points run on
`cuda` unless the caller passes `device="cpu"`; without a GPU and
without an explicit device they raise.
"""
